"""The port's GELU (vit_ed_tpu_torch/ops/gelu.py) against the JAX package's
``gelu_exact``, run eagerly, on every one of the 65,536 bf16 bit patterns.

XLA on the CPU flushes subnormal values to zero, PyTorch keeps them: the
only mismatches allowed are inputs where a step of the chain is subnormal
and the JAX result is the flushed zero (514 inputs on jax 0.9.0 / torch
2.13 CPU).
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import torch

from vit_ed_tpu.ops.gelu import gelu_exact as jax_gelu
from vit_ed_tpu_torch.ops.gelu import gelu_exact

_TINY = np.finfo(np.float32).tiny  # smallest normal: below it, subnormal


def _all_bf16():
    bits = np.arange(65536, dtype=np.uint16)
    return bits, torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def test_gelu_bf16_exhaustive_against_jax():
    bits, x = _all_bf16()
    ours = gelu_exact(x)
    assert ours.dtype == torch.bfloat16
    ref = jax_gelu(jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16))
    ob = ours.view(torch.int16).numpy().view(np.uint16)
    rb = np.asarray(jax.lax.bitcast_convert_type(ref, jnp.uint16))
    of = ours.float().numpy()
    rf = np.asarray(ref.astype(jnp.float32))
    diff = (ob != rb) & ~(np.isnan(of) & np.isnan(rf))
    assert diff.sum() < 1024, diff.sum()
    # every mismatch is XLA flushing a subnormal step of the chain to zero
    assert np.all(rf[diff] == 0.0)
    # each step's float32 value before its rounding to bf16
    xf = x.float()
    sqrt_half = torch.tensor(np.sqrt(0.5), dtype=torch.bfloat16).float()
    half_x = 0.5 * xf
    arg = -xf * sqrt_half
    erfc = torch.special.erfc(arg.bfloat16().float())
    prod = half_x.bfloat16().float() * erfc.bfloat16().float()
    subnormal = np.zeros(len(bits), bool)
    for st in (half_x, arg, erfc, prod):
        a = np.abs(st.numpy())
        subnormal |= (a > 0) & (a < _TINY)
    assert np.all(subnormal[diff])


def test_gelu_f32_is_exact_gelu():
    x = np.linspace(-8.0, 8.0, 4097, dtype=np.float32)
    ours = gelu_exact(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=False))
    # XLA's f32 erfc is less accurate in the far tail (it returns 0 for
    # gelu(-8) ~ -5e-15): absolute 1e-6 there
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    # F.gelu's 1 + erf(x/sqrt 2) cancels in the negative tail: same bound
    np.testing.assert_allclose(
        ours, torch.nn.functional.gelu(torch.from_numpy(x)).numpy(),
        rtol=1e-6, atol=1e-6)


def test_gelu_bf16_is_not_one_rounding():
    """The chain rounds at each step: ``F.gelu`` (one rounding) is not the
    reference activation on bf16, which is why the port spells it out."""
    _, x = _all_bf16()
    fin = torch.isfinite(x)
    differs = (gelu_exact(x) != torch.nn.functional.gelu(x)) & fin
    assert int(differs.sum()) > 0


def _bf16_order(bits):
    """bf16 bit patterns -> integers whose difference counts ulps."""
    b = bits.astype(np.int64)
    return np.where(b & 0x8000, -(b & 0x7FFF), b & 0x7FFF)


def test_gelu_bf16_derivative_against_jax_grad():
    """The closed-form bf16 derivative against the JAX package's custom JVP
    on every finite bf16 input, cotangent 1: within one bf16 ulp. The two
    evaluate Phi and the density differently (polynomial erfc + exp2 there,
    ``torch.special.erfc`` + exp here) and gradients carry no bit contract.
    Measured on jax 0.9.0 / torch 2.13 CPU: 12 of the 65,280 finite inputs
    differ at all, 4 of them by one ulp; the other 8 are x in
    [-13.625, -13.1875], where the JAX side returns 0 (XLA flushes the
    subnormal density) and ours is at most 9.0e-38 in magnitude."""
    bits, x = _all_bf16()
    fin = torch.isfinite(x).numpy()
    xt = x.clone().requires_grad_()
    out = gelu_exact(xt)
    # only x is kept for the backward
    assert len(out.grad_fn.saved_tensors) == 1
    out.backward(torch.ones_like(xt))
    assert xt.grad.dtype == torch.bfloat16
    xj = jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16)
    _, vjp = jax.vjp(jax_gelu, xj)
    ref = vjp(jnp.ones_like(xj))[0]
    ours_bits = xt.grad.view(torch.int16).numpy().view(np.uint16)
    ref_bits = np.asarray(jax.lax.bitcast_convert_type(ref, jnp.uint16))
    ulps = np.abs(_bf16_order(ours_bits) - _bf16_order(ref_bits))
    ours = xt.grad.float().numpy()
    flushed = (np.asarray(ref.astype(jnp.float32)) == 0.0) & (np.abs(ours) < 1e-36)
    assert np.all((ulps <= 1) | flushed | ~fin)
    assert int(((ulps > 0) & fin).sum()) < 64


def test_gelu_f32_gradient_is_plain_autograd():
    x = np.linspace(-6.0, 6.0, 1025, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = gelu_exact(xt)
    assert "Mul" in type(out.grad_fn).__name__   # no custom Function in f32
    out.sum().backward()
    ref = np.asarray(jax.grad(lambda a: jnp.sum(
        jax.nn.gelu(a, approximate=False)))(jnp.asarray(x)))
    np.testing.assert_allclose(xt.grad.numpy(), ref, rtol=1e-5, atol=1e-6)
