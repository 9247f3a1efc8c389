"""Dynamic int8 GEMMs for the scoring passes (``vit_ed_tpu/ops/quant.py``).

Scoring is inference only, so the projection GEMMs of every encoder and
decoder block (qkv / q / kv / proj / fc1 / fc2) may run int8 with dynamic
scales while attention stays in the compute dtype (``TPU.INT8_SCORE``):

- weights: symmetric int8 per output channel (a row of torch's [out, in]
  weight), quantized from the float32 parameter, never from its bf16 copy;
- activations: symmetric int8 per row (per token);
- the product: an exact int32 accumulate;
- the epilogue: ``acc * (sx * sw) + b`` rounded once to float32, then cast
  to the compute dtype.

The arithmetic is the JAX function's as XLA compiles it under ``jax.jit``,
which is how its scorer runs it: XLA turns ``amax / 127`` into ``amax *
float32(1/127)`` and fuses the dequantize and the bias add into one
multiply-add, rounded once. The epilogue here is that multiply-add in
float64 (the product of two float32 values is exact there), then one
rounding to float32. A single row (M = 1) is a vector product to XLA, and
its simplifier folds the two constants instead: the scale is ``amax_w *
(amax_x * float32(1/127^2))``. Eager JAX rounds twice; it is not the
reference.

In JAX the int32 product is an XLA ``dot_general``, not a Pallas kernel, so
the port calls a library product: ``torch._int_mm``, on the card (int8
tensor cores) and on the CPU alike, both exact. On the card it refuses
M <= 16 and K or N not a multiple of 8: such operands are padded with zero
rows and columns, which change no other entry of an exact product. Each
call on a CUDA tensor adds one to ``launches["int8_gemm"]``.

The parameters of a ``Linear`` stay ``weight`` / ``bias`` with int8 on or
off, so one checkpoint loads ``strict=True`` either way: ``int8_gemms``
turns the route on for the blocks of a model for the length of a scoring
call and keeps the quantized weights only that long.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_INV_127 = float(np.float32(1.0 / 127.0))   # XLA's constants, exact in float32
_INV_127_SQ = float(np.float32(1.0 / 127.0 ** 2))

# library GEMM launches on the card (chip_smoke.py resets and reads them)
launches = {"int8_gemm": 0}
# the same by shape: (M, K, N) -> count
launches_by_shape: Dict[Tuple[int, int, int], int] = {}


def reset_launch_counts() -> None:
    launches["int8_gemm"] = 0
    launches_by_shape.clear()


def _quantize(x: torch.Tensor, dim: int):
    """(int8 values, float32 scales, the clamped amax), ``dim`` kept."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=dim, keepdim=True), min=1e-12)
    scale = amax * _INV_127
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale, amax


def quantize_rows(x: torch.Tensor, dim: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 along ``dim``: (int8 values, float32 scales with
    ``dim`` kept). Rounding is half to even, as ``jnp.round``."""
    return _quantize(x, dim)[:2]


def quantize_weight(weight: torch.Tensor):
    """A [N, K] weight per output channel: (int8 values, scales [N, 1], the
    clamped amax [N, 1]), what ``int8_linear`` takes."""
    return _quantize(weight, 1)


def int8_mm_plain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ w [N, K]^T as an int32 product in plain PyTorch."""
    return a.to(torch.int32) @ w.to(torch.int32).t()


def int8_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ w [N, K]^T -> [M, N] int32, exact."""
    if a.device.type != "cuda":
        return torch._int_mm(a, w.t())
    m, k = a.shape
    n = w.shape[0]
    mp = 32 if m <= 16 else m
    kp, np_ = -(-k // 8) * 8, -(-n // 8) * 8
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        w = F.pad(w, (0, kp - k, 0, np_ - n))
    launches["int8_gemm"] += 1
    launches_by_shape[(m, k, n)] = launches_by_shape.get((m, k, n), 0) + 1
    # the weight's rows are the product's columns: w.t() is [K, N] column-major
    out = torch._int_mm(a.contiguous(), w.t())
    return out if (mp, np_) == (m, n) else out[:m, :n]


def int8_linear(x: torch.Tensor, wq: torch.Tensor, sw: torch.Tensor,
                amax_w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K]`` through a weight quantized by ``quantize_weight``
    (``wq`` [N, K] int8, its scales and clamped amax [N, 1]): the dynamic
    int8 GEMM and the once-rounded epilogue, in ``out_dtype`` (default
    ``x.dtype``)."""
    lead = x.shape[:-1]
    xq, sx, amax_x = _quantize(x.reshape(-1, x.shape[-1]), -1)
    acc = int8_mm(xq, wq)
    scale = (amax_w.t() * (amax_x * _INV_127_SQ) if xq.shape[0] == 1
             else sx * sw.t())
    # XLA converts the int32 accumulator to float32 first (|acc| may pass
    # 2^24), then fuses the multiply and the bias add
    out = acc.to(torch.float32).double()
    out.mul_(scale.double())
    if bias is not None:
        out.add_(bias.double())
    out = out.to(torch.float32).to(out_dtype or x.dtype)
    return out.reshape(*lead, -1)


def int8_matmul(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x [..., K] @ weight [N, K]^T + bias`` through the dynamic int8 GEMM
    (JAX ``int8_matmul`` with torch's weight layout)."""
    return int8_linear(x, *quantize_weight(weight), bias, out_dtype)


def _scored_linears(model: nn.Module):
    """Every Linear of the encoder and decoder blocks: qkv, q, kv, proj,
    fc1 and fc2 (the JAX package's QuantDense sites). The head and the
    patch embedding stay as they are."""
    from vit_ed_tpu_torch.models.layers import Linear

    for name in ("blocks", "cross_blocks"):
        blocks = getattr(model, name, None)
        for m in (blocks.modules() if blocks is not None else ()):
            if isinstance(m, Linear):
                yield m


@contextlib.contextmanager
def int8_gemms(model: nn.Module, on: bool = True):
    """With ``on``, the block Linears of ``model`` run the int8 route until
    the block ends, each with its weight quantized once on entry; without,
    nothing changes (so scopes nest)."""
    if not on:
        yield model
        return
    linears = [m for m in _scored_linears(model) if m.int8_weight is None]
    with torch.no_grad():
        for m in linears:
            m.int8_weight = quantize_weight(m.weight)
    try:
        yield model
    finally:
        for m in linears:
            m.int8_weight = None
