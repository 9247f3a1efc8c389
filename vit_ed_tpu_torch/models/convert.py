"""Weights across frameworks: JAX (flax) param trees and reference ``.pth``
checkpoints -> the port's models.

The port's module tree uses the reference timm key layout, which is also
what ``vit_ed_tpu/models/convert.py::params_to_torch_state_dict`` emits, so
a converted JAX tree loads with ``strict=True``. Layout changes:

- Dense: flax kernel [in, out] -> torch weight [out, in] (transpose)
- PatchEmbed conv: flax [kh, kw, C, D] -> torch [D, C, kh, kw]
- LayerNorm: scale/bias -> weight/bias
- the fused qkv / kv projections keep their q|k|v column order
- ``flax_leaf`` reads these rules backwards: a torch parameter's flax
  module and leaf names, shape and dims (the parallelism rules decide on
  the flax leaf, as the JAX package does)
- a MoE expert bank (models/moe.py): the router's kernel [D, E] -> the
  torch Linear weight ``mlp.router.weight`` [E, D]; ``w1`` [E, D, H],
  ``b1``, ``w2`` [E, H, D] and ``b2`` keep the flax layout and names (the
  JAX ``params_to_torch_state_dict`` refuses such trees: these names are
  the port's)

The BatchNorm model types (``models/resnet.py``, ``models/simsiam.py``) keep
flax's module names, so ``flax_variables_to_state_dict`` converts their
``params`` and ``batch_stats`` by one rule per leaf name: ``kernel`` ->
``weight`` (a conv's HWIO -> OIHW, a Dense's [in, out] transposed),
``scale`` -> ``weight`` (BatchNorm, LayerNorm and StarReLU), ``mean`` /
``var`` -> the ``running_mean`` / ``running_var`` buffers; ``bias`` and the
LayerScale vectors keep their names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class FlaxLeaf(NamedTuple):
    """The flax leaf a torch parameter converts from: its module and leaf
    names, its shape, and for each flax dim the torch dim it becomes."""
    parent: str
    leaf: str
    shape: Tuple[int, ...]
    torch_dims: Tuple[int, ...]


def flax_leaf(name: str, shape: Sequence[int]) -> FlaxLeaf:
    """The conversion's names and transpositions read backwards: a 2-D
    ``*.weight`` is a Dense kernel [in, out] (transposed), a 4-D one a conv
    kernel [kh, kw, C, D], a 1-D one a norm's ``scale``; every other leaf
    keeps its name and layout."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    nd = len(shape)
    dims = tuple(range(nd))
    if leaf == "weight":
        if nd == 2:
            leaf, dims = "kernel", (1, 0)
        elif nd == 4:
            leaf, dims = "kernel", (2, 3, 1, 0)
        else:
            leaf = "scale"
    return FlaxLeaf(parent, leaf, tuple(int(shape[d]) for d in dims), dims)


def jax_params_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ViT-ED param tree (numpy or array leaves) -> a torch state
    dict in the reference key layout (float32 tensors)."""
    sd: Dict[str, np.ndarray] = {}

    def put_linear(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["kernel"]).T
        if "bias" in p:
            sd[prefix + ".bias"] = np.asarray(p["bias"])

    def put_ln(prefix, p):
        sd[prefix + ".weight"] = np.asarray(p["scale"])
        sd[prefix + ".bias"] = np.asarray(p["bias"])

    sd["cls_token"] = np.asarray(params["cls_token"])
    sd["pos_embed"] = np.asarray(params["pos_embed"])
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = np.transpose(np.asarray(proj["kernel"]),
                                                 (3, 2, 0, 1))
    sd["patch_embed.proj.bias"] = np.asarray(proj["bias"])

    for name, p in params.items():
        if not (name.startswith("blocks_") or name.startswith("cross_blocks_")):
            continue
        if "q_norm" in p["attn"]:
            raise NotImplementedError(
                "qk_norm is not ported yet (ROADMAP queue A item 8: no config key "
                "reaches it)")
        stem, idx = name.rsplit("_", 1)
        prefix = f"{stem}.{idx}"
        put_ln(prefix + ".norm1", p["norm1"])
        put_linear(prefix + ".attn.qkv", p["attn"]["qkv"])
        put_linear(prefix + ".attn.proj", p["attn"]["proj"])
        put_ln(prefix + ".norm2", p["norm2"])
        if "w1" in p["mlp"]:
            bank = p["mlp"]
            sd[prefix + ".mlp.router.weight"] = np.asarray(bank["router"]["kernel"]).T
            for leaf in ("w1", "b1", "w2", "b2"):
                sd[f"{prefix}.mlp.{leaf}"] = np.asarray(bank[leaf])
        else:
            put_linear(prefix + ".mlp.fc1", p["mlp"]["fc1"])
            put_linear(prefix + ".mlp.fc2", p["mlp"]["fc2"])
        for ls in ("ls1", "ls2", "ls_cross"):
            if ls in p:
                sd[f"{prefix}.{ls}.gamma"] = np.asarray(p[ls]["gamma"])
        if "cross_attn" in p:
            put_ln(prefix + ".norm_cross", p["norm_cross"])
            put_ln(prefix + ".norm_context", p["norm_context"])
            put_linear(prefix + ".cross_attn.q", p["cross_attn"]["q"])
            put_linear(prefix + ".cross_attn.kv", p["cross_attn"]["kv"])
            put_linear(prefix + ".cross_attn.proj", p["cross_attn"]["proj"])

    put_ln("norm", params["norm"])
    if "head" in params:
        put_linear("head", params["head"])
    return {k: torch.tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
         "var": "running_var"}


def flax_variables_to_state_dict(params: Mapping[str, Any],
                                 batch_stats: Optional[Mapping[str, Any]] = None
                                 ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (+ ``batch_stats``) of a BatchNorm model type -> the
    port's state dict (float32 tensors)."""
    sd: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for name, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, prefix + name + ".")
                continue
            a = np.asarray(v, np.float32)
            if name == "kernel":
                a = np.transpose(a, (3, 2, 0, 1)) if a.ndim == 4 else a.T
            sd[prefix + _LEAF.get(name, name)] = torch.tensor(np.ascontiguousarray(a))

    walk(params, "")
    walk(batch_stats or {}, "")
    return sd


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a flax param tree into ``model`` (strict: every key must match)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def _upcycle_moe(sd: Dict[str, Any], own: Mapping[str, torch.Tensor],
                 logger=None) -> None:
    """Sparse upcycling (``vit_ed_tpu/train/checkpoint.py::_upcycle_moe``):
    where a DENSE checkpoint meets an expert bank of ``own``, every expert
    starts from the block's fc1 / fc2, transposed into the bank's layout
    (w1 [E, D, H] from fc1's [H, D] weight); the router keeps its init. A
    bank whose dense shapes do not match is skipped with a warning."""
    n = 0
    for key in own:
        if not key.endswith(".mlp.w1"):
            continue
        prefix = key[:-len("w1")]
        if prefix + "w1" in sd or prefix + "fc1.weight" not in sd:
            continue
        src = {"w1": torch.as_tensor(sd[prefix + "fc1.weight"]).t(),
               "b1": torch.as_tensor(sd[prefix + "fc1.bias"]),
               "w2": torch.as_tensor(sd[prefix + "fc2.weight"]).t(),
               "b2": torch.as_tensor(sd[prefix + "fc2.bias"])}
        if any(own[prefix + leaf].shape[1:] != v.shape for leaf, v in src.items()):
            if logger:
                logger.warning(f"Sparse upcycling skipped for {prefix[:-5]}: dense "
                               f"MLP shapes do not match the expert bank")
            continue
        for leaf, v in src.items():
            sd[prefix + leaf] = v.expand(own[prefix + leaf].shape).clone()
        n += 1
    if n and logger:
        logger.info(f"Sparse upcycling: initialised {n} expert banks from "
                    f"the dense checkpoint's MLPs")


def load_pretrained(model: nn.Module, path: str, logger=None) -> nn.Module:
    """Load a reference ``.pth`` checkpoint (a state dict, or a dict with a
    ``model`` entry), or a checkpoint of the port. A head whose class count
    differs is re-initialised to zeros; a dense checkpoint loaded into a
    model with expert banks initialises them (``_upcycle_moe``); missing and
    unexpected keys are reported, as the JAX package's ``load_pretrained``
    does."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(ckpt.get("model", ckpt))
    own = model.state_dict()
    for key in ("head.weight", "head.bias"):
        if key in sd and key in own and sd[key].shape != own[key].shape:
            if logger:
                logger.warning("classifier head shape differs; "
                               "re-initialising it to 0")
            sd[key] = torch.zeros_like(own[key])
    _upcycle_moe(sd, own, logger)
    res = model.load_state_dict(
        {k: torch.as_tensor(v, dtype=torch.float32) for k, v in sd.items()},
        strict=False)
    if logger:
        if res.missing_keys:
            logger.warning(f"Missing keys: {sorted(res.missing_keys)[:20]} ...")
        if res.unexpected_keys:
            logger.warning(f"Unexpected keys: {sorted(res.unexpected_keys)[:20]} ...")
        logger.info(f"=> loaded successfully '{path}'")
    return model
