"""Weights across frameworks: JAX (flax) param trees and reference ``.pth``
checkpoints -> the port's ViT-ED.

The port's module tree uses the reference timm key layout, which is also
what ``vit_ed_tpu/models/convert.py::params_to_torch_state_dict`` emits, so
a converted JAX tree loads with ``strict=True``. Layout changes:

- Dense: flax kernel [in, out] -> torch weight [out, in] (transpose)
- PatchEmbed conv: flax [kh, kw, C, D] -> torch [D, C, kh, kw]
- LayerNorm: scale/bias -> weight/bias
- the fused qkv / kv projections keep their q|k|v column order
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn


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
        if "mlp" in p and "w1" in p["mlp"]:
            raise NotImplementedError(
                f"{name} holds a MoE expert bank; MoE is not ported yet "
                f"(ROADMAP queue A item 12)")
        if "q_norm" in p["attn"]:
            raise NotImplementedError(
                "qk_norm is not ported yet (ROADMAP: what slice 1 left out)")
        stem, idx = name.rsplit("_", 1)
        prefix = f"{stem}.{idx}"
        put_ln(prefix + ".norm1", p["norm1"])
        put_linear(prefix + ".attn.qkv", p["attn"]["qkv"])
        put_linear(prefix + ".attn.proj", p["attn"]["proj"])
        put_ln(prefix + ".norm2", p["norm2"])
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


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Load a flax param tree into ``model`` (strict: every key must match)."""
    model.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return model


def load_pretrained(model: nn.Module, path: str, logger=None) -> nn.Module:
    """Load a reference ``.pth`` checkpoint (a state dict, or a dict with a
    ``model`` entry). A head whose class count differs is re-initialised to
    zeros; missing and unexpected keys are reported, as the JAX package's
    ``load_pretrained`` does."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = dict(ckpt.get("model", ckpt))
    own = model.state_dict()
    for key in ("head.weight", "head.bias"):
        if key in sd and key in own and sd[key].shape != own[key].shape:
            if logger:
                logger.warning("classifier head shape differs; "
                               "re-initialising it to 0")
            sd[key] = torch.zeros_like(own[key])
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
