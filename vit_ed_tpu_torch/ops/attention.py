"""Multi-head attention: the CUDA kernels (pair attention on the packed
[B, S, C] layout, and the 4-D attention for every other geometry), their
plain PyTorch versions and the wrappers the model calls.

The wrappers mirror the JAX entry points of ``vit_ed_tpu/ops/attention.py``
with the same layouts: ``fused_attention_packed_qkv`` (fused qkv
[B, S, 3C]), ``fused_attention_packed_kv_shared`` (one context kv
[1, Sk, 2C] for the whole q batch), ``fused_attention_packed_qkv_cls``
(CLS query row only), ``fused_attention_packed_kv`` (per-pair kv
[B, Sk, 2C]), ``fused_attention_packed`` (separate q/k/v) and, on
[B, H, S, D], ``fused_attention`` (differentiable) and
``fused_attention_heads`` (eval-only); ``fused_attention_flat`` is the
differentiable [B*H, S, D] entry (``_fused_attention_padded`` there).

THE DISPATCH RULE, the JAX package's, the same on the CPU and on the card:
a packed wrapper takes the PAIR route iff ``head_dim == 64 and C % 128 ==
0``; every other packed call and the [B, H, S, D] / [B*H, S, D] entries
take the 4-D (HEADS) route. The two routes are different functions of
their inputs:

- pair forward: ``pair_attention_plain`` (q pre-scaled and rounded, clamped
  exp2 without a max-subtract, normalisation deferred past the PV product);
  kernel ``csrc/pair_attention.cu``;
- heads forward: ``heads_attention_plain`` (max-subtracted f32 softmax whose
  normalised probabilities are rounded to the input type BEFORE the PV
  product); kernel ``csrc/heads_attention.cu``, head_dim 16, 32, 64 or 128
  (any other raises NotImplementedError, on the CPU too);
- both routes share one backward, ``attention_backward_plain`` (a
  max-subtracted f32 softmax recomputed from q and k, never the derivative
  of the pair forward's clamped chain) and its kernels
  ``csrc/heads_attention_bwd.cu`` (dq, then dk/dv), which the pair route
  runs at head_dim 64 through the same [B, H, S, D] views.
  ``csrc/attention_mma.cuh`` holds the tile helpers all kernels use.

Within a route the device decides: a CPU tensor runs the plain version (the
CPU tests and the CPU entry points), a CUDA tensor launches the kernel
(built at first use, ops/_build.py) and adds one to ``launches[...]``.
Nothing falls back: a kernel that fails to build or launch raises. The JAX
wrappers also left sequences shorter than 256 keys to XLA (``s >= 256`` at
attention.py:879/942/965/1039) to save a TPU launch per (batch, head); the
port drops that rule, so no CUDA call takes a plain path.

The heads route reaches its kernels through VIEWS: q, k and v are
[B, H, S, D] views of whatever the wrapper was given (column slices of a
fused projection, the shared batch-1 kv expanded with stride 0, the CLS row), the
output is allocated [B, Sq, H, D] so that merging heads is a free reshape,
and dq|dk|dv are written through the same views of one fused gradient
buffer. No split, transpose or pad copy is made (the JAX path pays four XLA
transposes and pads S to 128).

When grad mode is on and an input requires grad a wrapper runs as a
``torch.autograd.Function``, one per route. Launch counters: ``<layout>``
for the forward, ``<layout>_dq`` and ``<layout>_dkv`` for the two backward
kernels; the heads route's carry the prefix ``heads_``.
``fused_attention_packed_kv_shared`` and ``fused_attention_heads`` are
eval-only, as in the JAX package: they raise for a tensor that requires
grad.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from vit_ed_tpu_torch.ops import _build

KERNEL_SOURCE = "pair_attention.cu"
HEADS_KERNEL_SOURCE = "heads_attention.cu"
HEADS_BWD_KERNEL_SOURCE = "heads_attention_bwd.cu"
HEAD_DIM = 64                       # the pair route's only head_dim
HEADS_HEAD_DIMS = (16, 32, 64, 128)   # instantiated in the 4-D kernels
_EXP2_CLAMP = 80.0    # exp2(80) ~ 1.2e24: f32 sums stay far from overflow
_LOG2E = math.log2(math.e)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID = 65535     # CUDA's limit on gridDim.y / gridDim.z (heads, batch)

PACKED_LAYOUTS = ("qkv", "kv_shared", "qkv_cls", "kv", "packed")
# the 4-D route adds [B, H, S, D] (differentiable / eval-only) and [B*H, S, D]
HEADS_LAYOUTS = PACKED_LAYOUTS + ("bhsd", "bhsd_eval", "flat")
EVAL_ONLY_LAYOUTS = ("kv_shared", "bhsd_eval")

# kernel launches per wrapper and route (a plain count; chip_smoke.py resets
# it and reads it around each main path)
launches = {
    **{name: 0 for name in PACKED_LAYOUTS},
    **{f"{name}_{kernel}": 0 for name in PACKED_LAYOUTS if name != "kv_shared"
       for kernel in ("dq", "dkv")},
    **{f"heads_{name}": 0 for name in HEADS_LAYOUTS},
    **{f"heads_{name}_{kernel}": 0 for name in HEADS_LAYOUTS
       if name not in EVAL_ONLY_LAYOUTS for kernel in ("dq", "dkv")},
}


# the same launches by shape: (counter name, B, H, Sq, Sk, D) -> count, so
# that a report can tell an encoder's S = 64 launches from a decoder's S = 65
launches_by_shape: Dict[Tuple[str, int, int, int, int, int], int] = {}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0
    launches_by_shape.clear()


def _count_launch(name: str, *shape: int) -> None:
    launches[name] += 1
    launches_by_shape[(name, *shape)] = launches_by_shape.get((name, *shape), 0) + 1


def attention_probs(q: torch.Tensor, k: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """The explicit attention matrix for ``keep_attn`` and explainability
    (``vit_ed_tpu/ops/attention.py::attention_probs``, plain XLA there):
    q [B, H, Sq, D], k [B, H, Sk, D] -> float32 softmax [B, H, Sq, Sk] of
    the float32 logits times ``scale`` (default 1 / sqrt(D))."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    return torch.softmax(logits * scale, dim=-1)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def heads_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The 4-D forward kernel's chain in plain PyTorch, q [B, H, Sq, D],
    k/v [B, H, Sk, D] -> [B, H, Sq, D], rounding to the input type T where
    the kernel does (``_fwd_kernel_heads`` / ``_fwd_kernel`` of the JAX
    package):

        l   = (q k^T in f32) * scale
        p   = round_T(softmax_f32(l))        (max-subtracted, normalised)
        out = round_T(p v in f32)
    """
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return (probs.float() @ v.float()).to(q.dtype)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on [B, H, S, D], f32 softmax (the JAX
    package's ``reference_attention``; the same chain as the 4-D kernels)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return heads_attention_plain(q, k, v, scale)


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, S, C] -> the [B, H, S, D] view of its heads (no copy)."""
    return x.unflatten(-1, (num_heads, x.shape[-1] // num_heads)).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, C]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def pair_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         num_heads: int, scale: float) -> torch.Tensor:
    """The pair forward kernel's chain in plain PyTorch: q [B, Sq, C], k/v
    [B or 1, Sk, C] -> [B, Sq, C], rounding to the input type where the
    kernel does:

        qs  = round(q * scale * log2 e);  l = qs k^T (f32)
        e   = round(exp2(min(l, 80)))     (no max-subtract)
        out = round(sum(e v) / sum(e))    (denominator from the rounded e)
    """
    dt = q.dtype
    qs = (_heads(q, num_heads).float() * (scale * _LOG2E)).to(dt).float()
    logits = qs @ _heads(k, num_heads).float().transpose(-1, -2)
    e = torch.exp2(logits.clamp(max=_EXP2_CLAMP)).to(dt).float()
    out = (e @ _heads(v, num_heads).float()) / e.sum(-1, keepdim=True)
    return _merge(out.to(dt))


def attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor, scale: float
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The backward kernels' chain in plain PyTorch, for every route and
    head_dim: q/do [B, H, Sq, D], k/v [B, H, Sk, D] -> (dq, dk, dv) of the
    same shapes, rounding to the input type where the kernels do (the JAX
    package's ``_pair_backward``, ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``; NOT the derivative of the pair forward's clamped
    chain):

        s  = (q k^T in f32) * scale;  p = softmax(s) in f32
        dp = do v^T;  delta = rowsum(dp * p);  ds = p * (dp - delta) * scale
        dq = round(round(ds) k);  dv = round(round(p)^T do)
        dk = round(round(ds)^T q)
    """
    dt = q.dtype
    qh, kh, vh, doh = (t.float() for t in (q, k, v, do))
    p = torch.softmax((qh @ kh.transpose(-1, -2)) * scale, dim=-1)
    dp = doh @ vh.transpose(-1, -2)
    delta = (dp * p).sum(-1, keepdim=True)
    ds_b = (p * (dp - delta) * scale).to(dt).float()
    p_b = p.to(dt).float()
    dq = ds_b @ kh
    dv = p_b.transpose(-1, -2) @ doh
    dk = ds_b.transpose(-1, -2) @ qh
    return dq.to(dt), dk.to(dt), dv.to(dt)


def pair_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, do: torch.Tensor,
                                  num_heads: int, scale: float
                                  ) -> Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]:
    """``attention_backward_plain`` on the packed layout: q/do [B, Sq, C],
    k/v [B, Sk, C] -> (dq, dk, dv) of the same shapes."""
    grads = attention_backward_plain(
        *(_heads(t, num_heads) for t in (q, k, v, do)), scale)
    return tuple(_merge(g) for g in grads)


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


def _check_head_dim(c: int, num_heads: int) -> None:
    if c % num_heads or c // num_heads != HEAD_DIM:
        raise NotImplementedError(
            f"the pair-attention kernel takes head_dim {HEAD_DIM} only (got "
            f"C={c}, {num_heads} heads); other head dims take the 4-D "
            f"route ({HEADS_KERNEL_SOURCE})")


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


def _check_out(out: torch.Tensor, shape: Tuple[int, ...],
               ref: torch.Tensor) -> None:
    """A caller's output tensor: the shape, type and device the launch
    would have allocated."""
    if (tuple(out.shape) != tuple(shape) or out.dtype != ref.dtype
            or out.device != ref.device):
        raise ValueError(f"out must be {tuple(shape)} {ref.dtype} on "
                         f"{ref.device}, got {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}")


def _launch(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            cols: Tuple[int, int, int], c: int, num_heads: int,
            n_q_rows: int, scale: float,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One forward kernel launch. q/k/v are 3-D CUDA tensors (possibly the
    same fused projection) addressed through their strides plus a column
    offset each; a k/v batch of 1 is shared by the whole q batch (batch
    stride 0). Writes into ``out`` [B, n_q_rows, C] (allocated when None)
    and returns it."""
    _check_head_dim(c, num_heads)
    b = q.shape[0]
    n_keys = k.shape[1]
    if b > _MAX_GRID:
        raise ValueError(f"batch {b} must be <= {_MAX_GRID} (the grid's z)")
    _check_operands((q, k, v), q, (1, b))
    if any(col % 8 for col in cols) or v.shape[1] != n_keys:
        raise ValueError("column offsets must be multiples of 8 and k/v "
                         "must have the same length")

    def bstride(t):
        return 0 if t.shape[0] == 1 else t.stride(0)

    if out is None:
        out = torch.empty((b, n_q_rows, c), dtype=q.dtype, device=q.device)
    else:
        _check_out(out, (b, n_q_rows, c), q)
        _check_operands((out,), q, (b,))
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
    _count_launch(name, b, num_heads, n_q_rows, n_keys, HEAD_DIM)
    return out


def _heads_kernel(which: str):
    """The C entry points of the 4-D kernels: ``forward`` (heads_attention.cu),
    ``dq`` and ``dkv`` (heads_attention_bwd.cu). Every tensor is passed as a
    pointer plus batch, head and row strides in elements."""
    source = HEADS_KERNEL_SOURCE if which == "forward" else HEADS_BWD_KERNEL_SOURCE
    fn = getattr(_build.load(source), f"heads_attention_{which}")
    if fn.argtypes is None:
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        n_tensors = {"forward": 4, "dq": 5, "dkv": 6}[which]
        scratch = [] if which == "forward" else [p]          # stats
        fn.argtypes = ([p] * n_tensors + scratch + [i] * 6
                       + [ll] * (3 * n_tensors) + [ctypes.c_float, p])
        fn.restype = ctypes.c_int
    return fn


def _check_heads_dim(d: int) -> None:
    if d not in HEADS_HEAD_DIMS:
        raise NotImplementedError(
            f"the 4-D attention kernels are instantiated for head_dim "
            f"{HEADS_HEAD_DIMS}, got {d}")


def _check_heads_operands(q: torch.Tensor, others: Sequence[torch.Tensor],
                          n_keys: int) -> None:
    """What the 4-D kernels take: [B, H, S, D] tensors (views are fine) of
    one float type on one device, q-shaped or k-shaped, with the layout of
    the 16-byte tile loads: unit last stride, every other stride a multiple
    of 8 elements, 16-byte aligned data."""
    b, h, n_q, d = q.shape
    _check_heads_dim(d)
    if b > _MAX_GRID or h > _MAX_GRID:
        raise ValueError(f"batch {b} and heads {h} must each be <= {_MAX_GRID}")
    for t in (q, *others):
        if t.dtype != q.dtype or t.dtype not in _DTYPES:
            raise TypeError(f"attention takes float32 or bfloat16 inputs of "
                            f"one type, got {t.dtype}")
        if t.device != q.device:
            raise ValueError("q, k and v must lie on one device")
        if tuple(t.shape) not in ((b, h, n_q, d), (b, h, n_keys, d)):
            raise ValueError(f"shape {tuple(t.shape)} matches neither q "
                             f"{(b, h, n_q, d)} nor k/v {(b, h, n_keys, d)}")
        if (t.stride(3) != 1 or any(t.stride(i) % 8 for i in range(3))
                or t.data_ptr() % 16):
            raise ValueError("attention needs a unit last-dim stride, batch/"
                             "head/row strides in multiples of 8 elements and "
                             "16-byte aligned data")


def _call_heads_kernel(which: str, name: str, tensors: Sequence[torch.Tensor],
                       scratch: Sequence[torch.Tensor], n_keys: int,
                       scale: float) -> None:
    """Launch one 4-D kernel on the current stream and count it. ``tensors``
    are [B, H, S, D] views, q first."""
    q = tensors[0]
    b, h, n_q, d = q.shape
    _check_heads_operands(q, tensors[1:], n_keys)
    strides = [t.stride(i) for t in tensors for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _heads_kernel(which)(
            *(t.data_ptr() for t in (*tensors, *scratch)), _DTYPES[q.dtype],
            d, b, h, n_q, n_keys, *strides, scale, stream)
    if err:
        raise RuntimeError(f"4-D attention {which} kernel launch failed: CUDA "
                           f"error {err} ({name}, B={b}, H={h}, Sq={n_q}, "
                           f"Sk={n_keys}, D={d})")
    _count_launch(name, b, h, n_q, n_keys, d)


def _launch_heads(layout: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor, out: torch.Tensor, scale: float) -> None:
    """One forward launch of heads_attention.cu: out = attention(q, k, v),
    all four [B, H, S, D] views."""
    _call_heads_kernel("forward", f"heads_{layout}", (q, k, v, out), (),
                       k.shape[2], scale)


def _launch_heads_dq(layout: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, do: torch.Tensor, dq: torch.Tensor,
                     scale: float, prefix: str = "heads_") -> torch.Tensor:
    """The dQ kernel of heads_attention_bwd.cu, counted as
    ``<prefix><layout>_dq``. Returns the f32 row statistics [3, B, H, Sq]
    (softmax max, 1 / sum, delta) it stored, which the dK/dV kernel reads."""
    b, h, n_q, _ = q.shape
    stats = torch.empty((3, b, h, n_q), dtype=torch.float32, device=q.device)
    _call_heads_kernel("dq", f"{prefix}{layout}_dq", (q, k, v, do, dq),
                       (stats,), k.shape[2], scale)
    return stats


def _launch_heads_dkv(layout: str, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, do: torch.Tensor, dk: torch.Tensor,
                      dv: torch.Tensor, stats: torch.Tensor,
                      scale: float, prefix: str = "heads_") -> None:
    """The dK/dV kernel of heads_attention_bwd.cu, after ``_launch_heads_dq``
    on the same inputs; counted as ``<prefix><layout>_dkv``."""
    _call_heads_kernel("dkv", f"{prefix}{layout}_dkv", (q, k, v, do, dk, dv),
                       (stats,), k.shape[2], scale)


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
             scale: float, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    qkv, cols, c, n_q_rows = _operands(layout, tensors)
    if qkv[0].is_cuda:
        return _launch(layout, *qkv, cols, c, num_heads, n_q_rows, scale, out)
    res = pair_attention_plain(*_slices(qkv, cols, c, n_q_rows), num_heads,
                               scale)
    if out is None:
        return res
    _check_out(out, res.shape, res)
    return out.copy_(res)


def _heads_views(layout: str, tensors: Sequence[torch.Tensor],
                 num_heads: int) -> Tuple[torch.Tensor, ...]:
    """A wrapper's inputs (or its gradient buffers) as the q, k, v
    [B, H, S, D] views the 4-D route works on; nothing is copied."""
    if layout in ("bhsd", "bhsd_eval"):
        q, k, v = tensors
    elif layout == "flat":
        q, k, v = (t.unsqueeze(1) for t in tensors)
    else:
        qkv, cols, c, n_q_rows = _operands(layout, tensors)
        q, k, v = (_heads(t[..., col:col + c], num_heads)
                   for t, col in zip(qkv, cols))
        q = q[:, :, :n_q_rows]
    if layout == "kv_shared":   # the batch-1 kv serves the whole q batch: stride 0
        k, v = (t.expand(q.shape[0], -1, -1, -1) for t in (k, v))
    return q, k, v


def _from_heads(layout: str, x: torch.Tensor) -> torch.Tensor:
    """A [B, H, Sq, D] result in the layout the wrapper returns."""
    if layout in ("bhsd", "bhsd_eval"):
        return x
    return x.squeeze(1) if layout == "flat" else _merge(x)


def _to_heads(layout: str, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The inverse of ``_from_heads``, as a view of a contiguous ``x``."""
    if layout in ("bhsd", "bhsd_eval"):
        return x
    return x.unsqueeze(1) if layout == "flat" else _heads(x, num_heads)


def _heads_forward(layout: str, tensors: Sequence[torch.Tensor],
                   num_heads: int, scale: float,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    q, k, v = _heads_views(layout, tensors, num_heads)
    b, h, n_q, d = q.shape
    # in the returned layout ([B, Sq, H*D] for the packed wrappers): the
    # kernel writes through the heads view of it
    if layout in ("bhsd", "bhsd_eval"):
        shape = (b, h, n_q, d)
    else:
        shape = (b, n_q, d) if layout == "flat" else (b, n_q, h * d)
    if out is not None:
        _check_out(out, shape, q)
    if not q.is_cuda:
        res = _from_heads(layout, heads_attention_plain(q, k, v, scale))
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(shape, dtype=q.dtype, device=q.device)
    _launch_heads(layout, q, k, v, _to_heads(layout, out, num_heads), scale)
    return out


def _heads_backward(layout: str, tensors: Sequence[torch.Tensor],
                    num_heads: int, scale: float, do: torch.Tensor,
                    prefix: str = "heads_") -> Tuple[torch.Tensor, ...]:
    """Gradients of a wrapper call with respect to ``tensors``, each in its
    input's layout: dq|dk|dv land in one buffer per input through the same
    views the forward read (the CLS layout's dq rows past row 0 are zeros).
    Both routes: the pair route passes ``prefix=""`` for its counters."""
    q, k, v = _heads_views(layout, tensors, num_heads)
    out = tuple(torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in tensors)
    dq, dk, dv = _heads_views(layout, out, num_heads)
    if layout == "qkv_cls":
        out[0][:, 1:, :out[0].shape[-1] // 3].zero_()
    do = _to_heads(layout, do.contiguous(), num_heads)
    if q.is_cuda:
        stats = _launch_heads_dq(layout, q, k, v, do, dq, scale, prefix)
        _launch_heads_dkv(layout, q, k, v, do, dk, dv, stats, scale, prefix)
    else:
        for buf, g in zip((dq, dk, dv),
                          attention_backward_plain(q, k, v, do, scale)):
            buf.copy_(g)
    return out


class _Attention(torch.autograd.Function):
    """Differentiable attention of one route in one of its layouts:
    ``forward_fn`` on the way in, ``backward_fn`` on the way out."""

    forward_fn = backward_fn = None

    @classmethod
    def forward(cls, ctx, layout, num_heads, scale, *tensors):
        ctx.layout, ctx.num_heads, ctx.scale = layout, num_heads, scale
        ctx.save_for_backward(*tensors)
        return cls.forward_fn(layout, tensors, num_heads, scale)

    @classmethod
    def backward(cls, ctx, do):
        return (None, None, None,
                *cls.backward_fn(ctx.layout, ctx.saved_tensors, ctx.num_heads,
                                 ctx.scale, do))


class _PairAttention(_Attention):
    """The pair route: layouts qkv, qkv_cls, kv and packed at head_dim 64."""

    forward_fn = staticmethod(_forward)
    # the 4-D dq and dkv kernels at head_dim 64, counted without the prefix
    backward_fn = staticmethod(functools.partial(_heads_backward, prefix=""))


class _HeadsAttention(_Attention):
    """The 4-D route: the packed layouts at any other geometry, bhsd, flat."""

    forward_fn = staticmethod(_heads_forward)
    backward_fn = staticmethod(_heads_backward)


def _attend(layout: str, tensors: Sequence[torch.Tensor],
            num_heads: Optional[int], scale: Optional[float],
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Route a wrapper call by THE DISPATCH RULE of the module docstring.
    Every wrapper is this call on its layout, so the rules of a layout (its
    head count, the batches it accepts) live here: ``num_heads`` is the
    packed layouts' head count; the 4-D layouts read theirs from q [B, H,
    Sq, D] and the flat one has one head per row. ``out``, outside autograd
    only, is the tensor the forward writes into (the card tests fill it
    with NaN first, so that an element the kernel never stores reads NaN)."""
    if layout in ("bhsd", "bhsd_eval"):
        num_heads = tensors[0].shape[1]
    elif layout == "flat":
        num_heads = 1
    if layout == "kv_shared" and tensors[1].shape[0] != 1:
        raise ValueError(f"shared kv must have batch 1, got {tensors[1].shape[0]}")
    if layout != "kv_shared" and any(t.shape[0] != tensors[0].shape[0]
                                     for t in tensors):
        # a broadcast k/v would need its gradient summed over the batch,
        # which no backward kernel does
        raise ValueError(
            f"k/v batch {[t.shape[0] for t in tensors[1:]]} does not match "
            f"q's {tensors[0].shape[0]} (only fused_attention_packed_kv_shared "
            f"broadcasts a batch-1 kv)")
    if layout in PACKED_LAYOUTS:
        c = tensors[0].shape[-1] // (3 if layout in ("qkv", "qkv_cls") else 1)
        if c % num_heads:
            raise ValueError(f"C={c} does not split into {num_heads} heads")
        d = c // num_heads
        pair = d == HEAD_DIM and c % 128 == 0
    else:
        d, pair = tensors[0].shape[-1], False
    if not pair:
        _check_heads_dim(d)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    function = _PairAttention if pair else _HeadsAttention
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        if out is not None:
            raise ValueError("out= is for calls outside autograd")
        if layout in EVAL_ONLY_LAYOUTS:
            raise RuntimeError(
                "fused_attention_packed_kv_shared and fused_attention_heads "
                "are eval-only (no VJP, as in the JAX package): call them "
                "under no_grad, or use fused_attention_packed_kv / "
                "fused_attention for training")
        return function.apply(layout, num_heads, scale, *tensors)
    return function.forward_fn(layout, tensors, num_heads, scale, out)


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


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v on q [B, H, Sq, D], k/v [B, H, Sk, D] ->
    [B, H, Sq, D], differentiable (the 4-D route)."""
    return _attend("bhsd", (q, k, v), None, scale)


def fused_attention_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``fused_attention`` without a VJP. Eval-only: raises for an input
    that requires grad."""
    return _attend("bhsd_eval", (q, k, v), None, scale)


def fused_attention_flat(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: Optional[float] = None) -> torch.Tensor:
    """``fused_attention`` on batch and heads flattened together: q
    [B*H, Sq, D], k/v [B*H, Sk, D] -> [B*H, Sq, D], differentiable."""
    return _attend("flat", (q, k, v), None, scale)
