"""Tensor parallelism, Megatron's column / row split over the ``model``
axis (``vit_ed_tpu/parallel/tp.py``).

The rule is the JAX package's, on the flax leaf a torch parameter converts
from (``models.convert.flax_leaf``):

- column-parallel: the kernels of ``qkv``, ``q``, ``kv`` and ``fc1`` split
  on their output dim (flax dim 1, torch dim 0), and their biases;
- row-parallel: the kernels of ``proj`` and ``fc2`` split on their input
  dim (flax dim 0, torch dim 1); their biases stay whole;
- everything else is replicated.

To compute locally, a fused ``qkv`` [3C, C] or ``kv`` [2C, C] weight is split
head-aligned: rank m of t holds rows [p*C + m*C/t, p*C + (m+1)*C/t) of each
part p (q, k, v), so that its H/t heads of q, k and v sit together, and
``proj``'s columns [m*C/t, (m+1)*C/t) are those heads' channels. The split
is on the dim the JAX rule names; gathering the shards (``shard_index``
tells where each rank's rows go) gives the whole tensor exactly.

Two collectives on the ``model`` group carry the forward and backward
(``parallel.mesh``): the input of a column-parallel layer enters through
``enter_group`` (identity forward, all-reduce backward), and the output of
a row-parallel layer is summed by ``reduce_group`` (all-reduce forward,
identity backward) before its bias is added. An attention module runs its
H/t heads; the attention kernels' route is chosen from the unsharded width
(``Attention.route_dim``), so every rank runs the route of the unsharded
model.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from vit_ed_tpu_torch.models.convert import flax_leaf
from vit_ed_tpu_torch.models.layers import Attention, CrossAttention, Linear
from vit_ed_tpu_torch.parallel.mesh import Spec

COLUMN_PARALLEL = ("qkv", "q", "kv", "fc1")
ROW_PARALLEL = ("proj", "fc2")
_FUSED_PARTS = {"qkv": 3, "kv": 2}


def tp_param_specs(model: nn.Module, axis: str = "model") -> Dict[str, Optional[Spec]]:
    """{parameter name: Spec or None} of the column / row rule."""
    specs = {}
    for name, p in model.named_parameters():
        view = flax_leaf(name, p.shape)
        nd = len(view.shape)
        spec = None
        if nd == 2 and view.leaf == "kernel" and view.parent in COLUMN_PARALLEL:
            spec = Spec(axis, view.torch_dims[1])
        elif nd == 2 and view.leaf == "kernel" and view.parent in ROW_PARALLEL:
            spec = Spec(axis, view.torch_dims[0])
        elif nd == 1 and view.leaf == "bias" and view.parent in COLUMN_PARALLEL:
            spec = Spec(axis, view.torch_dims[0])
        specs[name] = spec
    return specs


def shard_index(name: str, spec: Spec, size: int, n: int, i: int) -> torch.Tensor:
    """The indices along ``spec.dim`` (of ``size``) that rank ``i`` of ``n``
    holds: head-aligned parts for a fused qkv / kv output dim, else a
    contiguous slice."""
    parts = _FUSED_PARTS.get(name.split(".")[-2], 1) if (
        spec.axis == "model" and spec.dim == 0) else 1
    if size % (parts * n):
        raise ValueError(f"{name}: {size} does not split into {parts} x {n} parts")
    width, s = size // parts, size // (parts * n)
    return torch.cat([torch.arange(p * width + i * s, p * width + (i + 1) * s)
                      for p in range(parts)])


def apply_tp(model: nn.Module, specs: Dict[str, Optional[Spec]], group, n: int) -> None:
    """Turn the modules whose weights ``specs`` splits over ``model`` (their
    parameters already this rank's shards) into their local parts: the
    column- and row-parallel Linears get their collectives, the attention
    modules H/t heads with the unsharded width as their route."""
    modules = dict(model.named_modules())
    for name, spec in specs.items():
        if spec is None or spec.axis != "model" or not name.endswith(".weight"):
            continue
        mod_name = name[:-len(".weight")]
        lin = modules[mod_name]
        if not isinstance(lin, Linear):
            raise TypeError(f"{mod_name} is split over 'model' but is no Linear")
        if spec.dim == 0:
            lin.enter_group = group
        else:
            lin.reduce_group = group
    for mod_name, m in modules.items():
        if not isinstance(m, (Attention, CrossAttention)):
            continue
        first = f"{mod_name}.{'qkv' if isinstance(m, Attention) else 'q'}.weight"
        if specs.get(first) is None:
            continue
        if m.num_heads % n:
            raise ValueError(
                f"{mod_name}: {m.num_heads} heads do not split over {n} 'model' ranks "
                f"(TENSOR_PARALLEL gives each rank whole heads: NUM_HEADS must be a "
                f"multiple of the 'model' axis size)")
        m.route_dim = modules[first[:-len(".weight")]]._parameters["weight"].shape[1]
        m.num_heads //= n
