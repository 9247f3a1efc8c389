"""Composition of the parameter-sharding rules, TP ∘ EP, then FSDP
(``vit_ed_tpu/parallel/compose.py``), and the sharded training model they
make.

Each rule owns disjoint leaves, so they stack per leaf as in the JAX
package: Megatron TP on the attention and dense-MLP kernels over
``model`` (parallel/tp.py), the expert banks over ``expert``
(parallel/ep.py), and FSDP over ``data`` on every leaf the first two left
replicated (parallel/fsdp.py). Two rules on one leaf raise the JAX
package's ``conflicting shardings`` error.

``shard_model`` copies a whole model into its sharded training form on this
rank: each sharded leaf sliced to this rank's shard (TP's fused qkv / kv
head-aligned, ``tp.shard_index``), the TP modules and the banks turned into
their local parts, the FSDP units installed. ``gather_tensor`` and
``shard_tensor`` move one leaf (a parameter or an optimizer moment)
between its whole form and this rank's shard: the trainer gathers the
whole model for every eval and scoring path and for its checkpoints
(written whole, so that one checkpoint loads under any mesh) and shards
what it loads.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional

import torch
from torch import nn

from vit_ed_tpu_torch.parallel.ep import apply_ep, ep_param_specs
from vit_ed_tpu_torch.parallel.fsdp import (
    DEFAULT_MIN_SIZE,
    fsdp_param_specs,
    install_units,
)
from vit_ed_tpu_torch.parallel.mesh import Mesh, Spec, all_gather_dim
from vit_ed_tpu_torch.parallel.tp import apply_tp, shard_index, tp_param_specs

Specs = Dict[str, Optional[Spec]]


def composed_param_specs(model: nn.Module, *, tp: bool = False, ep: bool = False,
                         fsdp: bool = False, data_axis_size: int = 1,
                         min_size: int = DEFAULT_MIN_SIZE) -> Specs:
    """{parameter name: Spec or None} with the enabled rules stacked."""
    specs: Specs = {name: None for name, _ in model.named_parameters()}

    def overlay(rule: Specs) -> None:
        for name, b in rule.items():
            a = specs[name]
            if a is not None and b is not None:
                raise ValueError(f"conflicting shardings {a} vs {b}")
            specs[name] = a or b

    if tp:
        overlay(tp_param_specs(model))
    if ep:
        overlay(ep_param_specs(model))
    if fsdp:
        fallback = fsdp_param_specs(model, data_axis_size, min_size=min_size)
        for name, spec in specs.items():
            if spec is None:
                specs[name] = fallback[name]
    return specs


def live_specs(specs: Specs, mesh: Mesh) -> Specs:
    """``specs`` with every split over an axis of one rank dropped (such a
    leaf is whole on every rank, as a JAX leaf split over a size-1 axis)."""
    return {name: (s if s is not None and mesh.size(s.axis) > 1 else None)
            for name, s in specs.items()}


def _index(name: str, spec: Spec, size: int, mesh: Mesh, i: int) -> torch.Tensor:
    return shard_index(name, spec, size, mesh.size(spec.axis), i)


def shard_tensor(t: torch.Tensor, name: str, spec: Optional[Spec],
                 mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole leaf ``t`` (a copy; ``t`` itself for
    a replicated leaf)."""
    if spec is None:
        return t
    idx = _index(name, spec, t.shape[spec.dim], mesh, mesh.index(spec.axis))
    return t.index_select(spec.dim, idx.to(t.device)).contiguous()


def gather_tensor(t: torch.Tensor, name: str, spec: Optional[Spec],
                  mesh: Mesh) -> torch.Tensor:
    """The whole leaf from every rank's shard ``t`` of it (every rank of the
    spec's axis calls it); ``t`` for a replicated leaf."""
    if spec is None:
        return t
    n = mesh.size(spec.axis)
    stacked = all_gather_dim(t.detach(), spec.dim, mesh.group(spec.axis))
    size = t.shape[spec.dim] * n
    idx = torch.cat([_index(name, spec, size, mesh, i) for i in range(n)])
    full = torch.empty_like(stacked)
    return full.index_copy_(spec.dim, idx.to(t.device), stacked)


def shard_model(model: nn.Module, mesh: Mesh, specs: Specs) -> nn.Module:
    """The sharded training copy of ``model`` on this rank (``model`` is left
    whole; its generators are not copied: seed the copy's). A split leaf is
    copied as its shard only, never whole."""
    generators = {}
    for m in model.modules():
        if getattr(m, "generator", None) is not None:
            generators[m] = m.generator
            m.generator = None
    base_gen = getattr(model, "drop_path_generator", None)
    if base_gen is not None:
        model.drop_path_generator = None
    # deepcopy takes each split leaf's shard from its memo
    memo = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if specs[name] is not None:
                memo[id(p)] = nn.Parameter(shard_tensor(p.data, name, specs[name], mesh),
                                           requires_grad=p.requires_grad)
    try:
        sharded = copy.deepcopy(model, memo)
    finally:
        for m, g in generators.items():
            m.generator = g
        if base_gen is not None:
            model.drop_path_generator = base_gen
    if any(s is not None and s.axis == "model" for s in specs.values()):
        apply_tp(sharded, specs, mesh.group("model"), mesh.size("model"))
    if any(s is not None and s.axis == "expert" for s in specs.values()):
        apply_ep(sharded, mesh.group("expert"), mesh.size("expert"), mesh.index("expert"))
    if any(s is not None and s.axis == "data" for s in specs.values()):
        install_units(sharded, specs, mesh.group("data"), mesh.size("data"))
    return sharded
