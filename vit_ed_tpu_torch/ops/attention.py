"""Multi-head attention on the packed [B, S, C] layout: the pair-attention
CUDA kernels (forward and backward), their plain PyTorch versions and the
wrappers the model calls.

The wrappers mirror the JAX entry points of ``vit_ed_tpu/ops/attention.py``
with the same layouts: ``fused_attention_packed_qkv`` (fused qkv
[B, S, 3C]), ``fused_attention_packed_kv_shared`` (one context kv
[1, Sk, 2C] for the whole q batch), ``fused_attention_packed_qkv_cls``
(CLS query row only), ``fused_attention_packed_kv`` (per-pair kv
[B, Sk, 2C]) and ``fused_attention_packed`` (separate q/k/v).

Forward dispatch, the same for every wrapper:

- a CPU tensor runs ``pair_attention_plain``, the kernel's chain written in
  plain PyTorch (the CPU tests and the CPU entry points);
- a CUDA tensor with head_dim 64 launches the kernel of
  ``csrc/pair_attention.cu`` (built at first use, ops/_build.py) and adds
  one to ``launches[<wrapper>]``;
- a CUDA tensor with another head_dim raises NotImplementedError: that
  needs the 4-D kernels, ROADMAP queue B slice 3.

Backward: when grad mode is on and an input requires grad, four of the
wrappers (qkv, qkv_cls, kv, packed) run as a ``torch.autograd.Function``
whose forward is the dispatch above and whose backward is the function of
the JAX package's ``_pair_backward`` (a max-subtracted f32 softmax
recomputed from q and k, NOT the forward's clamped exp2 chain):

- CPU tensors run ``pair_attention_backward_plain`` (never autograd through
  ``pair_attention_plain``), so the CPU and the card compute one gradient
  function;
- CUDA tensors launch the kernels of ``csrc/pair_attention_bwd.cu`` and add
  one to ``launches[<wrapper>_bwd]``; dq|dk|dv are written straight into the
  fused gradient ([B, S, 3C], or dk|dv into [B, Sk, 2C]) through strides.

``fused_attention_packed_kv_shared`` is eval-only, as in the JAX package:
it raises for a tensor that requires grad. Nothing falls back: a kernel
that fails to build or launch raises. The JAX wrappers also left sequences
shorter than 256 keys to XLA (``s >= 256`` at attention.py:879/942/965) to
save a TPU launch per (batch, head); the port drops that rule, so no CUDA
call takes the plain path.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence, Tuple

import torch

from vit_ed_tpu_torch.ops import _build

KERNEL_SOURCE = "pair_attention.cu"
BWD_KERNEL_SOURCE = "pair_attention_bwd.cu"
HEAD_DIM = 64
_EXP2_CLAMP = 80.0    # exp2(80) ~ 1.2e24: f32 sums stay far from overflow
_LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches per wrapper, forward and backward (a plain count;
# chip_smoke.py resets it and reads it around each main path)
launches = {"qkv": 0, "kv_shared": 0, "qkv_cls": 0, "kv": 0, "packed": 0,
            "qkv_bwd": 0, "qkv_cls_bwd": 0, "kv_bwd": 0, "packed_bwd": 0}


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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, C] -> float32 [B, H, S, D]."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)
                       ).transpose(1, 2).float()


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 [B, H, S, D] -> ``dtype`` [B, S, C] (one rounding)."""
    b, h, s, d = x.shape
    return x.to(dtype).transpose(1, 2).reshape(b, s, h * d)


def pair_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """The forward kernel's chain in plain PyTorch: q [B, Sq, C], k/v [B or
    1, Sk, C] -> [B, Sq, C], rounding to the input type where the kernel
    does:

        qs  = round(q * scale * log2 e);  l = qs k^T (f32)
        e   = round(exp2(min(l, 80)))     (no max-subtract)
        out = round(sum(e v) / sum(e))    (denominator from the rounded e)
    """
    dt = q.dtype
    qs = (_heads(q, num_heads) * (scale * _LOG2E)).to(dt).float()
    logits = qs @ _heads(k, num_heads).transpose(-1, -2)
    e = torch.exp2(logits.clamp(max=_EXP2_CLAMP)).to(dt).float()
    out = (e @ _heads(v, num_heads)) / e.sum(-1, keepdim=True)
    return _merge(out, dt)


def pair_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  num_heads: int, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """The backward kernel's chain in plain PyTorch: q/do [B, Sq, C], k/v
    [B, Sk, C] -> (dq, dk, dv) of the same shapes, rounding to the input
    type where the kernel does (this is the JAX package's ``_pair_backward``,
    not the derivative of the forward's clamped chain):

        s  = (q k^T in f32) * scale;  p = softmax(s) in f32
        dp = do v^T;  delta = rowsum(dp * p);  ds = p * (dp - delta) * scale
        dq = round(round(ds) k);  dv = round(round(p)^T do)
        dk = round(round(ds)^T q)
    """
    dt = q.dtype
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (q, k, v, do))
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    delta = (dp * p).sum(-1, keepdim=True)
    ds_b = (p * (dp - delta) * scale).to(dt).float()
    p_b = p.to(dt).float()
    dq = ds_b @ kh
    dv = p_b.transpose(-1, -2) @ doh
    dk = ds_b.transpose(-1, -2) @ qh
    return _merge(dq, dt), _merge(dk, dt), _merge(dv, dt)


# ---------------------------------------------------------------------------
# Kernel launches
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


def _bwd_kernel():
    fn = _build.load(BWD_KERNEL_SOURCE).pair_attention_backward
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i,
                       ll, ll, i, ll, ll, i, ll, ll, i,      # q, k, v
                       ll, ll,                               # do
                       ll, ll, i, ll, ll, i, ll, ll, i,      # dq, dk, dv
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check_head_dim(c: int, num_heads: int) -> None:
    if c % num_heads or c // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the pair-attention kernel takes head_dim {HEAD_DIM} only (got "
            f"C={c}, {num_heads} heads); other head dims need the 4-D "
            f"kernels (ROADMAP queue B, slice 3)")


def _check_operands(tensors: Sequence[torch.Tensor], ref: torch.Tensor,
                    batches: Tuple[int, ...]) -> None:
    """What the kernels take: one float type, one device, a batch in
    ``batches``, and the layout of their 16-byte tile loads."""
    for t in tensors:
        if t.dtype != ref.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"pair attention takes float32 or bfloat16 "
                            f"inputs of one type, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError("q, k and v must lie on one device")
        if t.shape[0] not in batches:
            raise ValueError(f"batch {t.shape[0]} does not match q's "
                             f"{ref.shape[0]}")
        if (t.stride(-1) != 1 or t.stride(1) % 8 or t.stride(0) % 8
                or t.data_ptr() % 16):
            raise ValueError("pair attention needs a unit last-dim stride, "
                             "row/batch strides in multiples of 8 elements "
                             "and 16-byte aligned data")


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cols: Tuple[int, int, int], c: int, num_heads: int,
            n_q_rows: int, scale: float) -> torch.Tensor:
    """One forward kernel launch. q/k/v are 3-D CUDA tensors (possibly the
    same fused projection) addressed through their strides plus a column
    offset each; a k/v batch of 1 is shared by the whole q batch (batch
    stride 0). Returns [B, n_q_rows, C]."""
    _check_head_dim(c, num_heads)
    b = q.shape[0]
    n_keys = k.shape[1]
    _check_operands((q, k, v), q, (1, b))
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


def _launch_backward(name: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, cols: Tuple[int, int, int], c: int,
                     num_heads: int, n_q_rows: int, scale: float,
                     do: torch.Tensor, grads: Sequence[torch.Tensor],
                     gcols: Tuple[int, int, int]) -> None:
    """One backward launch (the two kernels of pair_attention_bwd.cu on the
    current stream). q/k/v as in ``_launch`` but every batch is B; ``do``
    is [B, n_q_rows, C]; ``grads`` = (dq, dk, dv) buffers, possibly one
    fused tensor, written at the column offsets ``gcols`` (dq in its first
    ``n_q_rows`` rows)."""
    _check_head_dim(c, num_heads)
    b = q.shape[0]
    n_keys = k.shape[1]
    do = do.contiguous()
    _check_operands((q, k, v, do, *grads), q, (b,))
    if (any(col % 8 for col in (*cols, *gcols)) or v.shape[1] != n_keys
            or tuple(do.shape) != (b, n_q_rows, c)):
        raise ValueError("column offsets must be multiples of 8, k/v must "
                         "have the same length and do must be [B, Sq, C]")
    dq, dk, dv = grads
    # per (batch, head, query row): softmax max, 1 / sum, delta
    stats = torch.empty((3, b, num_heads, n_q_rows), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_kernel()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            _DTYPES[q.dtype], b, num_heads, n_q_rows, n_keys,
            q.stride(0), q.stride(1), cols[0],
            k.stride(0), k.stride(1), cols[1],
            v.stride(0), v.stride(1), cols[2],
            do.stride(0), do.stride(1),
            dq.stride(0), dq.stride(1), gcols[0],
            dk.stride(0), dk.stride(1), gcols[1],
            dv.stride(0), dv.stride(1), gcols[2],
            scale, stream)
    if err:
        raise RuntimeError(f"pair-attention backward launch failed: CUDA "
                           f"error {err} ({name}, B={b}, Sq={n_q_rows}, "
                           f"Sk={n_keys}, C={c})")
    launches[name] += 1


# ---------------------------------------------------------------------------
# Dispatch shared by the wrappers
# ---------------------------------------------------------------------------

def _operands(layout: str, tensors: Sequence[torch.Tensor]):
    """A wrapper's inputs as the kernels address them:
    ``((q, k, v), column offsets, C, query rows)``."""
    if layout in ("qkv", "qkv_cls"):
        (qkv,) = tensors
        c = qkv.shape[-1] // 3
        return ((qkv, qkv, qkv), (0, c, 2 * c), c,
                1 if layout == "qkv_cls" else qkv.shape[1])
    if layout in ("kv", "kv_shared"):
        q, kv = tensors
        c = q.shape[-1]
        return (q, kv, kv), (0, 0, c), c, q.shape[1]
    q, k, v = tensors
    return (q, k, v), (0, 0, 0), q.shape[-1], q.shape[1]


def _slices(qkv: Sequence[torch.Tensor], cols, c: int, n_q_rows: int):
    q, k, v = (t[..., col:col + c] for t, col in zip(qkv, cols))
    return q[:, :n_q_rows], k, v


def _forward(layout: str, tensors: Sequence[torch.Tensor], num_heads: int,
             scale: float) -> torch.Tensor:
    qkv, cols, c, n_q_rows = _operands(layout, tensors)
    if qkv[0].is_cuda:
        return _launch(layout, *qkv, cols, c, num_heads, n_q_rows, scale)
    return pair_attention_plain(*_slices(qkv, cols, c, n_q_rows), num_heads,
                                scale)


def _backward(layout: str, tensors: Sequence[torch.Tensor], num_heads: int,
              scale: float, do: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Gradients of ``_forward`` with respect to ``tensors``, in their fused
    layouts: dq|dk|dv in one [B, S, 3C] tensor for the qkv layouts (the CLS
    layout's dq rows past row 0 are zeros), (dq, dk|dv) for kv."""
    qkv, cols, c, n_q_rows = _operands(layout, tensors)
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in tensors)
    # which buffer each of dq, dk, dv lands in
    grads = (out * 3 if len(out) == 1
             else (out[0], out[1], out[1]) if len(out) == 2 else out)
    if layout == "qkv_cls":
        out[0][:, 1:, :c].zero_()   # the other query rows got no cotangent
    if qkv[0].is_cuda:
        _launch_backward(layout + "_bwd", *qkv, cols, c, num_heads, n_q_rows,
                         scale, do, grads, cols)
    else:
        plain = pair_attention_backward_plain(
            *_slices(qkv, cols, c, n_q_rows), do, num_heads, scale)
        for buf, col, g in zip(grads, cols, plain):
            buf[:, :g.shape[1], col:col + c] = g
    return out


class _PairAttention(torch.autograd.Function):
    """Differentiable pair attention in one of the layouts qkv, qkv_cls, kv
    and packed: ``_forward`` on the way in, ``_backward`` on the way out."""

    @staticmethod
    def forward(ctx, layout, num_heads, scale, *tensors):
        ctx.layout, ctx.num_heads, ctx.scale = layout, num_heads, scale
        ctx.save_for_backward(*tensors)
        return _forward(layout, tensors, num_heads, scale)

    @staticmethod
    def backward(ctx, do):
        return (None, None, None,
                *_backward(ctx.layout, ctx.saved_tensors, ctx.num_heads,
                           ctx.scale, do))


def _attend(layout: str, tensors: Sequence[torch.Tensor], num_heads: int,
            scale: Optional[float]) -> torch.Tensor:
    c = tensors[0].shape[-1] // (3 if layout in ("qkv", "qkv_cls") else 1)
    scale = _default_scale(c, num_heads, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if layout == "kv_shared":
            raise RuntimeError(
                "fused_attention_packed_kv_shared is eval-only (the scan's "
                "shared context row has no VJP): call it under no_grad, or "
                "use fused_attention_packed_kv for training")
        return _PairAttention.apply(layout, num_heads, scale, *tensors)
    return _forward(layout, tensors, num_heads, scale)


# ---------------------------------------------------------------------------
# Wrappers (the JAX entry points' signatures and layouts)
# ---------------------------------------------------------------------------

def fused_attention_packed_qkv(qkv: torch.Tensor, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Self-attention straight from the fused qkv projection [B, S, 3C]
    -> [B, S, C]."""
    return _attend("qkv", (qkv,), num_heads, scale)


def fused_attention_packed_qkv_cls(qkv: torch.Tensor, num_heads: int,
                                   scale: Optional[float] = None
                                   ) -> torch.Tensor:
    """CLS-query self-attention from the fused qkv [B, S, 3C] -> [B, 1, C];
    equals ``fused_attention_packed_qkv(qkv, ...)[:, :1]`` without the
    other S-1 query rows. Its gradient is zero in their dq rows."""
    return _attend("qkv_cls", (qkv,), num_heads, scale)


def fused_attention_packed_kv_shared(q: torch.Tensor, kv: torch.Tensor,
                                     num_heads: int,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """Cross-attention where ONE context kv [1, Sk, 2C] serves the whole q
    batch [B, Sq, C] (the row-sharded O(N^2) scan chunk); equals
    ``fused_attention_packed_kv`` on the materialised broadcast.
    Eval-only: raises for an input that requires grad."""
    if kv.shape[0] != 1:
        raise ValueError(f"shared kv must have batch 1, got {kv.shape[0]}")
    return _attend("kv_shared", (q, kv), num_heads, scale)


def fused_attention_packed_kv(q: torch.Tensor, kv: torch.Tensor,
                              num_heads: int,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Cross-attention from q [B, Sq, C] and the fused kv projection
    [B, Sk, 2C]."""
    return _attend("kv", (q, kv), num_heads, scale)


def fused_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           num_heads: int,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention from separate q [B, Sq, C] and k/v [B, Sk, C]."""
    return _attend("packed", (q, k, v), num_heads, scale)
