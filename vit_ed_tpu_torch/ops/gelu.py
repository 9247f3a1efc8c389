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

Backward, as ``vit_ed_tpu/ops/gelu.py::_gelu_bf16_jvp``: on bf16 the
derivative is the closed form

    gelu'(x) = Phi(x) + x * phi(x),   Phi(x) = 0.5 * erfc(-x * sqrt(0.5))

evaluated in float32, and the cotangent ``g * gelu'(x)`` rounds once to
bf16. Only ``x`` is saved: autograd through the five-op chain would keep
four hidden-width tensors per MLP. The JAX package evaluates Phi with its
polynomial erfc and the density with exp2, the port with
``torch.special.erfc`` and ``exp`` in f32; gradients carry no bit contract
(tests/test_torch_gelu.py states the measured difference). float32 inputs
keep plain autograd of the exact GELU, as ``jax.nn.gelu`` does.
"""

from __future__ import annotations

import math

import torch

_SQRT_HALF = math.sqrt(0.5)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _gelu_chain(x: torch.Tensor) -> torch.Tensor:
    sqrt_half = torch.tensor(_SQRT_HALF, dtype=x.dtype, device=x.device)
    return (0.5 * x) * torch.special.erfc(-x * sqrt_half)


class _GeluBf16(torch.autograd.Function):
    """The bf16 chain with the closed-form derivative."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _gelu_chain(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        xf = x.float()
        big_phi = 0.5 * torch.special.erfc(xf * -_SQRT_HALF)
        dens = torch.exp(xf * xf * -0.5) * _INV_SQRT_2PI
        return (g.float() * (big_phi + xf * dens)).to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    if (x.dtype == torch.bfloat16 and x.requires_grad
            and torch.is_grad_enabled()):
        return _GeluBf16.apply(x)
    return _gelu_chain(x)
