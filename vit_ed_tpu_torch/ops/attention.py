"""Multi-head attention on the packed [B, S, C] layout: the pair-attention
CUDA kernel, its plain PyTorch version and the wrappers the model calls.

The wrappers mirror the JAX entry points of ``vit_ed_tpu/ops/attention.py``
with the same layouts: ``fused_attention_packed_qkv`` (fused qkv
[B, S, 3C]), ``fused_attention_packed_kv_shared`` (one context kv
[1, Sk, 2C] for the whole q batch), ``fused_attention_packed_qkv_cls``
(CLS query row only), ``fused_attention_packed_kv`` (per-pair kv
[B, Sk, 2C]) and ``fused_attention_packed`` (separate q/k/v).

Dispatch, the same for every wrapper:

- a CPU tensor runs ``pair_attention_plain``, the kernel's chain written in
  plain PyTorch (the CPU tests and the CPU entry points);
- a CUDA tensor with head_dim 64 launches the kernel of
  ``csrc/pair_attention.cu`` (built at first use, ops/_build.py) and adds
  one to ``launches[<wrapper>]``;
- a CUDA tensor with another head_dim raises NotImplementedError: that
  needs the 4-D kernels, ROADMAP queue B slice 3.

Nothing falls back: a kernel that fails to build or launch raises. The JAX
wrappers also left sequences shorter than 256 keys to XLA (``s >= 256`` at
attention.py:879/942/965) to save a TPU launch per (batch, head); the port
drops that rule, so no CUDA call takes the plain path.

The kernel has no backward yet: on the card the wrappers raise when given
a tensor that requires grad (training is ROADMAP queue A item 6).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from vit_ed_tpu_torch.ops import _build

KERNEL_SOURCE = "pair_attention.cu"
HEAD_DIM = 64
_EXP2_CLAMP = 80.0    # exp2(80) ~ 1.2e24: f32 sums stay far from overflow
_LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper (a plain count; chip_smoke.py resets it and
# reads it around the main path)
launches = {"qkv": 0, "kv_shared": 0, "qkv_cls": 0, "kv": 0, "packed": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _default_scale(c: int, num_heads: int, scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(c // num_heads) if scale is None else scale


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, H, S, D], f32 softmax (the JAX
    package's ``reference_attention``)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = q.float() @ k.float().transpose(-1, -2)
    probs = torch.softmax(logits * scale, dim=-1)
    return (probs.to(v.dtype).float() @ v.float()).to(q.dtype)


def pair_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """The kernel's chain in plain PyTorch: q [B, Sq, C], k/v [B or 1, Sk,
    C] -> [B, Sq, C], rounding to the input type where the kernel does:

        qs  = round(q * scale * log2 e);  l = qs k^T (f32)
        e   = round(exp2(min(l, 80)))     (no max-subtract)
        out = round(sum(e v) / sum(e))    (denominator from the rounded e)
    """
    b, sq, c = q.shape
    d = c // num_heads
    dt = q.dtype

    def heads(x):
        return x.unflatten(-1, (num_heads, d)).transpose(1, 2).float()

    qs = (heads(q) * (scale * _LOG2E)).to(dt).float()
    logits = qs @ heads(k).transpose(-1, -2)
    e = torch.exp2(logits.clamp(max=_EXP2_CLAMP)).to(dt).float()
    out = (e @ heads(v)) / e.sum(-1, keepdim=True)
    return out.to(dt).transpose(1, 2).reshape(b, sq, c)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _kernel():
    fn = _build.load(KERNEL_SOURCE).pair_attention_forward
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, i, i, i, i, i,
                       ll, ll, i, ll, ll, i, ll, ll, i, ll, ll,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cols: Tuple[int, int, int], c: int, num_heads: int,
            n_q_rows: int, scale: float) -> torch.Tensor:
    """One kernel launch. q/k/v are 3-D CUDA tensors (possibly the same
    fused projection) addressed through their strides plus a column offset
    each; a k/v batch of 1 is shared by the whole q batch (batch stride 0).
    Returns [B, n_q_rows, C]."""
    if c % num_heads or c // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the pair-attention kernel takes head_dim {HEAD_DIM} only (got "
            f"C={c}, {num_heads} heads); other head dims need the 4-D "
            f"kernels (ROADMAP queue B, slice 3)")
    b = q.shape[0]
    n_keys = k.shape[1]
    for t in (q, k, v):
        if t.requires_grad:
            raise RuntimeError(
                "the pair-attention kernel has no backward yet: gradients "
                "come with the training slice (ROADMAP queue A item 6, "
                "queue B item 5)")
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"pair attention takes float32 or bfloat16 "
                            f"inputs of one type, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if t.shape[0] not in (1, b):
            raise ValueError(f"batch {t.shape[0]} does not match q's {b}")
        # the bf16 kernel stages tiles with 16-byte loads
        if (t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError("pair attention needs a unit last-dim stride, "
                             "row/batch strides in multiples of 8 elements "
                             "and 16-byte aligned data")
    if any(col % 8 for col in cols) or v.shape[1] != n_keys:
        raise ValueError("column offsets must be multiples of 8 and k/v "
                         "must have the same length")

    def bstride(t):
        return 0 if t.shape[0] == 1 else t.stride(0)

    out = torch.empty((b, n_q_rows, c), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], b, num_heads, n_q_rows, n_keys,
            bstride(q), q.stride(1), cols[0],
            bstride(k), k.stride(1), cols[1],
            bstride(v), v.stride(1), cols[2],
            out.stride(0), out.stride(1), scale * _LOG2E, stream)
    if err:
        raise RuntimeError(f"pair-attention kernel launch failed: CUDA error "
                           f"{err} ({name}, B={b}, Sq={n_q_rows}, "
                           f"Sk={n_keys}, C={c})")
    launches[name] += 1
    return out


# ---------------------------------------------------------------------------
# Wrappers (the JAX entry points' signatures and layouts)
# ---------------------------------------------------------------------------

def fused_attention_packed_qkv(qkv: torch.Tensor, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention straight from the fused qkv projection [B, S, 3C]
    -> [B, S, C]."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    scale = _default_scale(c, num_heads, scale)
    if qkv.is_cuda:
        return _launch("qkv", qkv, qkv, qkv, (0, c, 2 * c), c, num_heads, s,
                       scale)
    q, k, v = qkv.split(c, dim=-1)
    return pair_attention_plain(q, k, v, num_heads, scale)


def fused_attention_packed_qkv_cls(qkv: torch.Tensor, num_heads: int,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """CLS-query self-attention from the fused qkv [B, S, 3C] -> [B, 1, C];
    equals ``fused_attention_packed_qkv(qkv, ...)[:, :1]`` without the
    other S-1 query rows."""
    b, s, c3 = qkv.shape
    c = c3 // 3
    scale = _default_scale(c, num_heads, scale)
    if qkv.is_cuda:
        return _launch("qkv_cls", qkv, qkv, qkv, (0, c, 2 * c), c, num_heads,
                       1, scale)
    q, k, v = qkv.split(c, dim=-1)
    return pair_attention_plain(q[:, :1], k, v, num_heads, scale)


def fused_attention_packed_kv_shared(q: torch.Tensor, kv: torch.Tensor,
                                     num_heads: int,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Cross-attention where ONE context kv [1, Sk, 2C] serves the whole q
    batch [B, Sq, C] (the row-sharded O(N^2) scan chunk); equals
    ``fused_attention_packed_kv`` on the materialised broadcast."""
    b, sq, c = q.shape
    if kv.shape[0] != 1:
        raise ValueError(f"shared kv must have batch 1, got {kv.shape[0]}")
    scale = _default_scale(c, num_heads, scale)
    if q.is_cuda:
        return _launch("kv_shared", q, kv, kv, (0, 0, c), c, num_heads, sq,
                       scale)
    k, v = kv.split(c, dim=-1)
    return pair_attention_plain(q, k, v, num_heads, scale)


def fused_attention_packed_kv(q: torch.Tensor, kv: torch.Tensor,
                              num_heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Cross-attention from q [B, Sq, C] and the fused kv projection
    [B, Sk, 2C]."""
    b, sq, c = q.shape
    scale = _default_scale(c, num_heads, scale)
    if q.is_cuda:
        return _launch("kv", q, kv, kv, (0, 0, c), c, num_heads, sq, scale)
    k, v = kv.split(c, dim=-1)
    return pair_attention_plain(q, k, v, num_heads, scale)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention from separate q [B, Sq, C] and k/v [B, Sk, C]."""
    b, sq, c = q.shape
    scale = _default_scale(c, num_heads, scale)
    if q.is_cuda:
        return _launch("packed", q, k, v, (0, 0, 0), c, num_heads, sq, scale)
    return pair_attention_plain(q, k, v, num_heads, scale)
