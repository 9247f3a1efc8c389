"""Attention explainability (``vit_ed_tpu/ops/explain.py``): a functional
ViT-ED forward that exposes every attention map and its gradient, and the
Chefer et al. relevancy rules over them.

The forward runs over the port's state dict (timm names, ``[out, in]``
weights; a module is read through its ``state_dict()``) in float32 on an
explicit device, with an additive zero "probe" on every attention matrix:
``torch.autograd.grad`` of the target logit with respect to the probes is
the attention-gradient tensor the rules need (the reference registers
gradient hooks on ``keep_attn`` maps instead). Like the JAX function it
reads no LayerScale and no dropout, which no config of the repo sets, and
computes the exact-erf GELU and the LayerNorm from their formulas in
float32. The rules run in numpy, as in the JAX module.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

Params = Mapping[str, torch.Tensor]


def state_dict_on(params: Union[nn.Module, Params],
                  device: Union[str, torch.device] = "cpu") -> Dict[str, torch.Tensor]:
    """The float32 tensors of a module's state dict (or of a state dict) on
    ``device``, detached."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    return {k: torch.as_tensor(v).detach().to(device=device, dtype=torch.float32)
            for k, v in params.items()}


def _ln(x, p, name):
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    y = (x - mean) / torch.sqrt(var + 1e-6)
    return y * p[f"{name}.weight"] + p[f"{name}.bias"]


def _dense(x, p, name):
    y = x @ p[f"{name}.weight"].t()
    bias = p.get(f"{name}.bias")
    return y if bias is None else y + bias


def _heads(t, heads):
    b, n, c = t.shape
    return t.reshape(b, n, heads, c // heads).transpose(1, 2)


def _attend(q, k, v, heads, probe):
    """Softmax attention of [B, S, C] streams with ``probe`` added to the
    probabilities; returns ([B, Sq, C], the probed map)."""
    b, n, c = q.shape
    qh, kh, vh = _heads(q, heads), _heads(k, heads), _heads(v, heads)
    attn = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(c // heads), dim=-1)
    attn = attn + probe
    return (attn @ vh).transpose(1, 2).reshape(b, n, c), attn


def _attn(x, p, name, heads, probe):
    q, k, v = _dense(x, p, f"{name}.qkv").chunk(3, dim=-1)
    out, attn = _attend(q, k, v, heads, probe)
    return _dense(out, p, f"{name}.proj"), attn


def _cross(x, ctx, p, name, heads, probe):
    k, v = _dense(ctx, p, f"{name}.kv").chunk(2, dim=-1)
    out, attn = _attend(_dense(x, p, f"{name}.q"), k, v, heads, probe)
    return _dense(out, p, f"{name}.proj"), attn


def _mlp(x, p, name):
    h = _dense(x, p, f"{name}.fc1")
    return _dense(0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0))), p, f"{name}.fc2")


def _patchify(x, p, patch):
    y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), p["patch_embed.proj.weight"],
                                   p["patch_embed.proj.bias"], stride=patch)
    return y.flatten(2).transpose(1, 2)


def forward_with_probes(params: Params, x_pair: torch.Tensor, probes: Dict,
                        patch: int, heads: int, depth: int, c_depth: int
                        ) -> Tuple[torch.Tensor, Dict[str, List[torch.Tensor]]]:
    """The full pair forward of x_pair [B, 2, H, W, 3]. ``probes``: {'enc':
    [depth maps], 'dec_self': [c_depth], 'dec_cross': [c_depth]} of zero
    tensors broadcastable to the attention maps. Returns (logits, the
    attention maps by the same keys)."""
    x1, x2 = x_pair[:, 0], x_pair[:, 1]
    attns = {"enc": [], "dec_self": [], "dec_cross": []}

    f = _patchify(x1, params, patch) + params["pos_embed"][:, 1:]
    for i in range(depth):
        name = f"blocks.{i}"
        y, a = _attn(_ln(f, params, f"{name}.norm1"), params, f"{name}.attn",
                     heads, probes["enc"][i])
        attns["enc"].append(a)
        f = f + y
        f = f + _mlp(_ln(f, params, f"{name}.norm2"), params, f"{name}.mlp")

    t = _patchify(x2, params, patch)
    cls = params["cls_token"].expand(t.shape[0], 1, t.shape[-1])
    t = torch.cat([cls, t], dim=1) + params["pos_embed"]
    for i in range(c_depth):
        name = f"cross_blocks.{i}"
        y, a = _attn(_ln(t, params, f"{name}.norm1"), params, f"{name}.attn",
                     heads, probes["dec_self"][i])
        attns["dec_self"].append(a)
        t = t + y
        y, a = _cross(_ln(t, params, f"{name}.norm_cross"),
                      _ln(f, params, f"{name}.norm_context"), params,
                      f"{name}.cross_attn", heads, probes["dec_cross"][i])
        attns["dec_cross"].append(a)
        t = t + y
        t = t + _mlp(_ln(t, params, f"{name}.norm2"), params, f"{name}.mlp")

    t = _ln(t, params, "norm")
    return _dense(t[:, 0], params, "head"), attns


def attention_maps_and_gradients(params: Union[nn.Module, Params], x_pair,
                                 patch: int, heads: int, depth: int,
                                 c_depth: int, target_index: int = 0,
                                 device: Union[str, torch.device] = "cpu"):
    """Every attention map and d(sum of logit[:, target]) / d(map), on
    ``device`` in float32: (maps, gradients) as {key: [float32 numpy
    arrays]}, and the target value."""
    p = state_dict_on(params, device)
    x = torch.as_tensor(np.asarray(x_pair, np.float32), device=device)
    n1 = (x.shape[2] // patch) * (x.shape[3] // patch)
    n2 = n1 + 1
    b = x.shape[0]

    def zeros(n_q, n_k):
        return torch.zeros((b, heads, n_q, n_k), device=device, requires_grad=True)

    probes = {"enc": [zeros(n1, n1) for _ in range(depth)],
              "dec_self": [zeros(n2, n2) for _ in range(c_depth)],
              "dec_cross": [zeros(n2, n1) for _ in range(c_depth)]}
    keys = ("enc", "dec_self", "dec_cross")
    flat = [t for key in keys for t in probes[key]]
    with torch.enable_grad():
        logits, attns = forward_with_probes(p, x, probes, patch, heads, depth, c_depth)
        value = logits[:, target_index].sum()
        grads = torch.autograd.grad(value, flat)

    def numpy_tree(tensors):
        tensors = iter(tensors)
        return {key: [next(tensors).detach().cpu().numpy() for _ in probes[key]]
                for key in keys}

    return (numpy_tree(t for key in keys for t in attns[key]), numpy_tree(grads),
            float(value.detach()))


# ---------------------------------------------------------------------------
# Chefer et al. relevancy rules (scripts/visualise_attentions.py)
# ---------------------------------------------------------------------------

def avg_heads(cam, grad):
    """Rule 5: head-average of grad-weighted positive attention."""
    cam = np.asarray(cam).reshape(-1, cam.shape[-2], cam.shape[-1])
    grad = np.asarray(grad).reshape(-1, grad.shape[-2], grad.shape[-1])
    return np.clip(grad * cam, 0, None).mean(axis=0)


def apply_self_attention_rules(R_ss, R_sq, cam_ss):
    """Rules 6 and 7."""
    return cam_ss @ R_ss, cam_ss @ R_sq


def handle_residual(orig_self_attention):
    """Eq. 8 and 9 normalization."""
    eye = np.eye(orig_self_attention.shape[-1])
    self_attention = orig_self_attention - eye
    self_attention = self_attention / np.maximum(
        self_attention.sum(axis=-1, keepdims=True), 1e-12)
    return self_attention + eye


def apply_mm_attention_rules(R_ss, R_qq, cam_sq, apply_normalization=True,
                             apply_self_in_rule_10=True):
    """Rule 10."""
    R_ss_n = handle_residual(R_ss) if apply_normalization else R_ss
    R_qq_n = handle_residual(R_qq) if apply_normalization else R_qq
    R_sq_addition = R_ss_n.T @ (cam_sq @ R_qq_n)
    if not apply_self_in_rule_10:
        R_sq_addition = cam_sq
    R_sq_addition[np.isnan(R_sq_addition)] = 0
    return R_sq_addition


def compute_rollout_attention(all_layer_matrices, start_layer=0):
    """Residual-aware attention rollout."""
    eye = np.eye(all_layer_matrices[0].shape[1])
    mats = [m + eye for m in all_layer_matrices]
    mats = [m / m.sum(axis=-1, keepdims=True) for m in mats]
    joint = mats[start_layer]
    for i in range(start_layer + 1, len(mats)):
        joint = mats[i] @ joint
    return joint


def generate_relevance(params, x_pair, patch, heads, depth, c_depth,
                       target_index=0, normalize_self_attention=True,
                       apply_self_in_rule_10=True,
                       device: Optional[Union[str, torch.device]] = "cpu"):
    """The full Chefer relevancy pipeline: R_q_i[1:, :], the relevance of
    every decoder patch token to every encoder patch token, with the maps
    and gradients computed on ``device``."""
    attns, grads, _ = attention_maps_and_gradients(
        params, x_pair, patch, heads, depth, c_depth, target_index, device)

    n_i = attns["enc"][0].shape[-1]
    n_q = attns["dec_self"][0].shape[-1]
    R_i_i = np.eye(n_i)
    R_q_q = np.eye(n_q)
    R_q_i = np.zeros((n_q, n_i))

    for i in range(depth):
        cam = avg_heads(attns["enc"][i], grads["enc"][i])
        R_i_i = R_i_i + cam @ R_i_i

    for i in range(c_depth):
        cam = avg_heads(attns["dec_self"][i], grads["dec_self"][i])
        R_q_q_add, R_q_i_add = apply_self_attention_rules(R_q_q, R_q_i, cam)
        R_q_q = R_q_q + R_q_q_add
        R_q_i = R_q_i + R_q_i_add

        cam_q_i = avg_heads(attns["dec_cross"][i], grads["dec_cross"][i])
        R_q_i = R_q_i + apply_mm_attention_rules(
            R_q_q, R_i_i, cam_q_i,
            apply_normalization=normalize_self_attention,
            apply_self_in_rule_10=apply_self_in_rule_10)

    return R_q_i[1:, :]
