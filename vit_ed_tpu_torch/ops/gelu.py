"""Exact (erf) GELU with the JAX package's bf16 rounding chain.

The reference activation is torch's exact-erf ``nn.GELU``. The JAX package
evaluates it as ``jax.nn.gelu(x, approximate=False)`` does:

    (0.5 * x) * erfc(-x * sqrt(0.5))

and on bf16 every step of that chain rounds to bf16: ``sqrt(0.5)`` itself,
the product ``-x * sqrt(0.5)``, ``erfc`` (computed in f32, rounded once),
``0.5 * x`` and the final product. ``torch.nn.functional.gelu`` rounds once
at the end instead and differs from the chain by one ulp on about 1,229 of
the 65,536 bf16 inputs, so the port spells the chain out. PyTorch's bf16
elementwise ops compute in f32 and round each result to bf16, which is the
chain's own rounding; the constant is made a bf16 tensor so that it is
rounded like the JAX one. In float32 the same expression is the exact GELU.

Forward only: the closed-form derivative of ``vit_ed_tpu/ops/gelu.py``
(gelu'(x) = Phi(x) + x * phi(x)) comes with the training slice.
"""

from __future__ import annotations

import math

import torch

_SQRT_HALF = math.sqrt(0.5)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    sqrt_half = torch.tensor(_SQRT_HALF, dtype=x.dtype, device=x.device)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)
