"""The port's attention wrappers (vit_ed_tpu_torch/ops/attention.py) against
the JAX package's Pallas pair kernel, run in interpret mode on the CPU.

At head_dim 64 with C % 128 == 0 (the pair route, every case here) a port
wrapper on the CPU runs ``pair_attention_plain`` (the CUDA kernel's chain
in plain PyTorch); the kernel itself is held against that
plain version on the card (tests/test_torch_cuda.py and chip_smoke.py). Inputs come from numpy seeds and go to both
frameworks as numpy arrays.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ed_tpu.ops.attention as jattn
from test_torch_cuda import dominant_last_key
from vit_ed_tpu_torch.ops import attention as tattn

H, C, B = 2, 128, 3
# f32: summation order only (the JAX suite's packed-kernel tolerance);
# bf16: the JAX suite's bf16 tolerance
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _inputs(seed, s, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "qkv": rng.normal(size=(B, s, 3 * C)) * scale,
        "q": rng.normal(size=(B, s, C)) * scale,
        "kv": rng.normal(size=(B, s, 2 * C)),
        "kv1": rng.normal(size=(1, s, 2 * C)),
        "k": rng.normal(size=(B, s, C)),
        "v": rng.normal(size=(B, s, C)),
    }


def _jax(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


CALLS = {
    "qkv": (lambda m, a, j: m.fused_attention_packed_qkv(a["qkv"], H, **j)),
    "kv_shared": (lambda m, a, j: m.fused_attention_packed_kv_shared(
        a["q"], a["kv1"], H, **j)),
    "qkv_cls": (lambda m, a, j: m.fused_attention_packed_qkv_cls(a["qkv"], H, **j)),
    "kv": (lambda m, a, j: m.fused_attention_packed_kv(a["q"], a["kv"], H, **j)),
    "packed": (lambda m, a, j: m.fused_attention_packed(a["q"], a["k"], a["v"],
                                                        H, **j)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [64, 65, 261])
@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_wrapper_matches_jax_pallas(wrapper, s, dtype):
    raw = _inputs(s, s, dtype)
    ref = CALLS[wrapper](jattn, {k: _jax(v, dtype) for k, v in raw.items()},
                         {"use_pallas": True})
    out = CALLS[wrapper](tattn, {k: _torch(v, dtype) for k, v in raw.items()}, {})
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=0)


# max |port - JAX| / max |JAX| at the ragged lengths: f32 summation order
# only (readings <= 1.2e-6); bf16 at most one bf16 step at the output's max,
# 2^-7 of it (readings 0: the same rounding points)
RAGGED_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 17, 65, 129])
@pytest.mark.parametrize("wrapper", ["qkv", "kv_shared"])
def test_plain_matches_jax_at_ragged_lengths(wrapper, s, dtype):
    """``pair_attention_plain`` (the card's yardstick for pair_attention.cu)
    against the JAX pair kernel through the scan's two wrappers at the
    lengths the kernel's ragged key tiles and last query tiles serve, with
    the last key of every (batch, head) dominant (the inputs of the card's
    forward checks)."""
    rng = np.random.default_rng(s)
    raw = {"qkv": rng.normal(size=(B, s, 3 * C)).astype(np.float32),
           "q": rng.normal(size=(B, s, C)).astype(np.float32),
           "kv1": rng.normal(size=(1, s, 2 * C)).astype(np.float32)}
    t = {n: torch.from_numpy(x) for n, x in raw.items()}
    heads = [tattn._heads(t["qkv"][..., i * C:(i + 1) * C], H) for i in range(3)]
    dominant_last_key(*heads)
    dominant_last_key(tattn._heads(t["q"], H), tattn._heads(t["kv1"][..., :C], H),
                      tattn._heads(t["kv1"][..., C:], H))
    ref = CALLS[wrapper](jattn, {k: _jax(v, dtype) for k, v in raw.items()},
                         {"use_pallas": True})
    out = CALLS[wrapper](tattn, {k: _torch(v, dtype) for k, v in raw.items()}, {})
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    err = np.abs(out.float().numpy() - ref).max() / np.abs(ref).max()
    assert err <= RAGGED_TOL[dtype], err


def test_exp2_clamp_matches_jax():
    """Logits past the static exp2 clamp (80 in log2 units): both sides cap
    the exponent instead of subtracting the row maximum, so they still
    agree where a max-subtracting softmax would not."""
    raw = _inputs(7, 65, "float32", scale=12.0)
    ref = np.asarray(jattn.fused_attention_packed_qkv(
        _jax(raw["qkv"], "float32"), H, use_pallas=True))
    out = tattn.fused_attention_packed_qkv(_torch(raw["qkv"], "float32"), H)
    qs = raw["qkv"][..., :64] * (0.125 * np.log2(np.e))
    assert (np.einsum("bqd,bkd->bqk", qs, raw["qkv"][..., C:C + 64]) > 80).any()
    # logits of ~100 carry f32 rounding of ~1e-5 into exp2: looser than
    # the unit-scale 2e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=1e-4)
    q, k, v = (_torch(raw["qkv"], "float32").unflatten(-1, (3, H, 64))
               .permute(2, 0, 3, 1, 4).unbind(0))
    softmax = tattn.reference_attention(q, k, v).transpose(1, 2).reshape(B, 65, C)
    assert not torch.allclose(out, softmax, atol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_softmax_reference(dtype):
    """Below the clamp the chain is softmax attention."""
    raw = _inputs(3, 65, dtype)
    q, k, v = (_torch(raw[n], dtype) for n in ("q", "k", "v"))
    out = tattn.fused_attention_packed(q, k, v, H)
    split = [t.unflatten(-1, (H, 64)).transpose(1, 2) for t in (q, k, v)]
    ref = tattn.reference_attention(*split).transpose(1, 2).reshape(B, 65, C)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=TOL[dtype] * 10 if dtype == "bfloat16" else 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_shared_equals_broadcast_and_cls_equals_row0(dtype):
    raw = _inputs(11, 261, dtype)
    q, kv1, qkv = (_torch(raw[n], dtype) for n in ("q", "kv1", "qkv"))
    shared = tattn.fused_attention_packed_kv_shared(q, kv1, H)
    bcast = tattn.fused_attention_packed_kv(q, kv1.expand(B, -1, -1).contiguous(), H)
    assert torch.equal(shared, bcast)
    cls = tattn.fused_attention_packed_qkv_cls(qkv, H)
    full = tattn.fused_attention_packed_qkv(qkv, H)
    assert tuple(cls.shape) == (B, 1, C)
    if dtype == "bfloat16":
        assert torch.equal(cls, full[:, :1])
    else:
        # the CPU's f32 matmul blocks a 1-row product differently from a
        # 261-row one (ulp level), as the JAX suite notes for its CPU
        # interpret mode; on the card the kernel computes each row alone
        # and chip_smoke.py asserts equality bit for bit
        np.testing.assert_allclose(cls.numpy(), full[:, :1].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_kernel_rules_without_a_card():
    """Raised before the card is touched: the pair kernel takes head_dim 64
    only (the wrappers send other geometries to the 4-D route); a shared kv
    must have batch 1."""
    x = torch.zeros(2, 8, 96)
    with pytest.raises(NotImplementedError, match="head_dim 64 only"):
        tattn._launch("packed", x, x, x, (0, 0, 0), 96, 3, 8, 0.2)
    with pytest.raises(ValueError, match="batch 1"):
        tattn.fused_attention_packed_kv_shared(torch.zeros(2, 8, 128),
                                               torch.zeros(2, 8, 256), H)


@pytest.mark.parametrize("layout,names,h", [
    ("qkv", ("qkv",), H), ("kv_shared", ("q", "kv1"), H), ("qkv_cls", ("qkv",), H),
    ("kv", ("q", "kv"), H), ("packed", ("q", "k", "v"), H),
    ("qkv", ("qkv",), 4)])           # head_dim 32: the 4-D route
def test_forward_writes_into_a_given_output(layout, names, h):
    """``_attend(..., out=...)``, through which the card tests hand a kernel
    a NaN-filled output: the wrapper's values, in the tensor given, on both
    routes; a wrong shape and a call under autograd raise."""
    a = {n: torch.from_numpy(v.astype(np.float32)) for n, v in _inputs(5, 17, None).items()}
    tensors = [a[n] for n in names]
    want = tattn._attend(layout, tensors, h, None)
    out = torch.full(want.shape, float("nan"))
    got = tattn._attend(layout, tensors, h, None, out=out)
    assert got.data_ptr() == out.data_ptr() and torch.equal(out, want)
    with pytest.raises(ValueError, match="out must be"):
        tattn._attend(layout, tensors, h, None, out=torch.empty(want.shape[0], 3))
    grad = [t.clone().requires_grad_() for t in tensors]
    with pytest.raises(ValueError, match="outside autograd"):
        tattn._attend(layout, grad, h, None, out=out)


WRAPPERS = {
    "qkv": (tattn.fused_attention_packed_qkv, ("qkv",), True),
    "qkv_cls": (tattn.fused_attention_packed_qkv_cls, ("qkv",), True),
    "kv_shared": (tattn.fused_attention_packed_kv_shared, ("q", "kv1"), True),
    "kv": (tattn.fused_attention_packed_kv, ("q", "kv"), True),
    "packed": (tattn.fused_attention_packed, ("q", "k", "v"), True),
    "bhsd": (tattn.fused_attention, ("q4", "k4", "v4"), False),
    "bhsd_eval": (tattn.fused_attention_heads, ("q4", "k4", "v4"), False),
    "flat": (tattn.fused_attention_flat, ("q3", "k3", "v3"), False),
}


@pytest.mark.parametrize("h", [H, 4])          # head_dim 64 and 32
@pytest.mark.parametrize("layout", list(WRAPPERS))
def test_every_wrapper_is_the_attend_call_of_its_layout(layout, h):
    """Each public wrapper equals ``_attend(layout, tensors, h, None)``, the
    call through which the card's forward checks hand a kernel its output:
    a head-count rule of a wrapper cannot drift from the checked one."""
    fn, names, packed = WRAPPERS[layout]
    a = {n: torch.from_numpy(v.astype(np.float32)) for n, v in _inputs(6, 17, None).items()}
    d = C // h
    a["q4"], a["k4"], a["v4"] = (tattn._heads(a[n], h) for n in ("q", "k", "v"))
    a["q3"], a["k3"], a["v3"] = (a[n].reshape(B * h, 17, d) for n in ("q4", "k4", "v4"))
    tensors = [a[n] for n in names]
    with torch.no_grad():
        got = fn(*tensors, h) if packed else fn(*tensors)
        want = tattn._attend(layout, tensors, h, None)
    assert torch.equal(got, want)
