"""The port's 4-D attention route (head_dim != 64, or C % 128 != 0) against
the JAX package's 4-D Pallas kernels, run in interpret mode on the CPU under
``jax.jit``, and against ``reference_attention``.

On the CPU the port runs ``heads_attention_plain`` forward and
``attention_backward_plain`` backward; the CUDA kernels are held against
those on the card (tests/test_torch_cuda.py and chip_smoke.py). Inputs come
from numpy seeds and go to both frameworks as numpy arrays. Tolerances are
the JAX suite's (tests/test_attention.py): f32 atol 2e-4, bf16 atol 3e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ed_tpu.ops.attention as jattn
from test_torch_cuda import dominant_last_key
from vit_ed_tpu_torch.ops import attention as tattn

B, H, S, D = 2, 3, 70, 32
C = H * D
TOL = {"float32": 2e-4, "bfloat16": 3e-2}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _jax(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _torch(x, dtype):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _jax_out_and_grads(fn, args, do):
    """fn(*args) and its VJP at the cotangent ``do``, jitted (the interpret
    kernels compile once)."""
    def run(*a):
        out, vjp = jax.vjp(fn, *a)
        return out, vjp(do.astype(out.dtype))

    return jax.jit(run)(*args)


def _torch_out_and_grads(fn, args, do):
    args = [a.detach().clone().requires_grad_() for a in args]
    out = fn(*args)
    out.backward(do.to(out.dtype))
    return out, [a.grad for a in args]


def _assert_close(got, want, dtype, what):
    assert tuple(got.shape) == tuple(want.shape), what
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype], rtol=0,
                               err_msg=what)


# max |port - JAX| / max |JAX| at the ragged lengths: f32 summation order
# only (readings <= 2.3e-7); bf16 at most one bf16 step at the output's max,
# 2^-7 of it (readings 0: the same rounding points)
RAGGED_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def _rel(got, want):
    return np.abs(_np(got) - _np(want)).max() / np.abs(_np(want)).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 17, 65, 129])
def test_plain_matches_jax_at_ragged_lengths(s, dtype):
    """``heads_attention_plain`` (the card's yardstick for heads_attention.cu)
    against the JAX 4-D kernel (``_pallas_fwd_heads``, interpret mode) at the
    lengths the kernel's ragged tiles and one-pass / ring instantiations
    serve, with the last key of every (batch, head) dominant (the inputs of
    the card's forward checks)."""
    rng = np.random.default_rng(s)
    raw = [rng.normal(size=(B, 2, s, D)).astype(np.float32) for _ in range(3)]
    dominant_last_key(*(torch.from_numpy(x) for x in raw))
    ref = jax.jit(functools.partial(jattn.fused_attention, use_pallas=True))(
        *[_jax(x, dtype) for x in raw])
    out = tattn.fused_attention_heads(*[_torch(x, dtype) for x in raw])
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == ref.shape
    assert _rel(out, ref) <= RAGGED_TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sk", [70, 64])
def test_fused_attention_matches_jax_pallas(sk, dtype):
    """Forward and dq, dk, dv of ``fused_attention`` on [2, 3, 70, 32]
    against the JAX 4-D kernels (``_pallas_fwd_heads``, ``_pallas_dq``,
    ``_pallas_dkv``) and against ``reference_attention``."""
    rng = np.random.default_rng(sk)
    raw = [rng.normal(size=(B, H, n, D)) for n in (S, sk, sk)]
    do = rng.normal(size=(B, H, S, D))
    ref, ref_grads = _jax_out_and_grads(
        functools.partial(jattn.fused_attention, use_pallas=True),
        [_jax(x, dtype) for x in raw], _jax(do, dtype))
    out, grads = _torch_out_and_grads(
        tattn.fused_attention, [_torch(x, dtype) for x in raw], _torch(do, dtype))
    assert out.dtype == getattr(torch, dtype)
    _assert_close(out, ref, dtype, "forward")
    _assert_close(out, jattn.reference_attention(*[_jax(x, dtype) for x in raw]),
                  dtype, "forward vs reference_attention")
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads):
        assert g.dtype == getattr(torch, dtype)
        _assert_close(g, r, dtype, name)
    # the eval-only entry computes the same forward
    heads = tattn.fused_attention_heads(*[_torch(x, dtype) for x in raw])
    assert torch.equal(heads, out.detach())
    _assert_close(heads, jax.jit(jattn.fused_attention_heads)(
        *[_jax(x, dtype) for x in raw]), dtype, "fused_attention_heads")


def test_flat_entry_matches_jax_fused_attention_padded():
    """The [B*H, S, D] entry against ``_fused_attention_padded`` (``_pallas_fwd``
    with the dq / dkv kernels as its VJP), which takes inputs padded to its
    blocks; the port takes them as they are."""
    rng = np.random.default_rng(5)
    sk, pad = 64, 128
    raw = [rng.normal(size=(B * H, n, D)) for n in (S, sk, sk)]
    do = rng.normal(size=(B * H, S, D))
    scale = D ** -0.5

    def padded(x):
        return jnp.pad(_jax(x, "float32"), ((0, 0), (0, pad - x.shape[1]), (0, 0)))

    ref, ref_grads = _jax_out_and_grads(
        lambda q, k, v: jattn._fused_attention_padded(q, k, v, (scale, S, sk, pad)),
        [padded(x) for x in raw], padded(do))
    out, grads = _torch_out_and_grads(
        tattn.fused_attention_flat, [_torch(x, "float32") for x in raw],
        _torch(do, "float32"))
    _assert_close(out, ref[:, :S], "float32", "forward")
    for name, g, r, n in zip(("dq", "dk", "dv"), grads, ref_grads, (S, sk, sk)):
        _assert_close(g, r[:, :n], "float32", name)


def _packed_inputs(seed, s, sk, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"qkv": rng.normal(size=(B, s, 3 * C)) * scale,
            "q": rng.normal(size=(B, s, C)) * scale,
            "kv": rng.normal(size=(B, sk, 2 * C)),
            "kv1": rng.normal(size=(1, sk, 2 * C)),
            "k": rng.normal(size=(B, sk, C)),
            "v": rng.normal(size=(B, sk, C))}


# wrapper -> (call on module m with inputs a and keyword arguments j, inputs)
PACKED = {
    "qkv": (lambda m, a, j: m.fused_attention_packed_qkv(a[0], H, **j), ("qkv",)),
    "kv_shared": (lambda m, a, j: m.fused_attention_packed_kv_shared(*a, H, **j),
                  ("q", "kv1")),
    "qkv_cls": (lambda m, a, j: m.fused_attention_packed_qkv_cls(a[0], H, **j),
                ("qkv",)),
    "kv": (lambda m, a, j: m.fused_attention_packed_kv(*a, H, **j), ("q", "kv")),
    "packed": (lambda m, a, j: m.fused_attention_packed(*a, H, **j),
               ("q", "k", "v")),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wrapper", sorted(PACKED))
def test_packed_wrapper_matches_jax_4d_path(wrapper, dtype):
    """Each packed wrapper at C = 96, 3 heads (head_dim 32) against its JAX
    twin with ``use_pallas=True``, which splits heads and runs the 4-D
    kernels; forward, and the gradients where the wrapper has a VJP."""
    call, names = PACKED[wrapper]
    raw = _packed_inputs(len(wrapper), S, 64 if "kv" in wrapper else S)
    rows = 1 if wrapper == "qkv_cls" else S
    do = np.random.default_rng(1).normal(size=(B, rows, C))
    jargs = [_jax(raw[n], dtype) for n in names]
    targs = [_torch(raw[n], dtype) for n in names]
    if wrapper == "kv_shared":     # eval-only in both packages
        ref = jax.jit(lambda *a: call(jattn, a, {"use_pallas": True}))(*jargs)
        _assert_close(call(tattn, targs, {}), ref, dtype, "forward")
        return
    ref, ref_grads = _jax_out_and_grads(
        lambda *a: call(jattn, a, {"use_pallas": True}), jargs, _jax(do, dtype))
    out, grads = _torch_out_and_grads(lambda *a: call(tattn, a, {}), targs,
                                      _torch(do, dtype))
    _assert_close(out, ref, dtype, "forward")
    for name, g, r in zip(names, grads, ref_grads):
        _assert_close(g, r, dtype, f"d{name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cls_equals_row0_and_shared_equals_broadcast(dtype):
    raw = _packed_inputs(11, S, 64)
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
        # 70-row one (ulp level); on the card the kernel computes each row
        # alone and chip_smoke.py asserts equality bit for bit
        np.testing.assert_allclose(cls.numpy(), full[:, :1].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_head_dim_32_past_the_clamp_matches_jax_4d_path():
    """Logits past the pair kernel's exp2 clamp (80 in log2 units) at
    head_dim 32: the JAX package computes a max-subtracted softmax there
    (the 4-D path), and so must the port; the pair route's clamped chain
    gives another answer."""
    raw = _packed_inputs(7, S, S, scale=16.0)
    ref = jax.jit(lambda x: jattn.fused_attention_packed_qkv(
        x, H, use_pallas=True))(_jax(raw["qkv"], "float32"))
    qkv = _torch(raw["qkv"], "float32")
    out = tattn.fused_attention_packed_qkv(qkv, H)
    q, k, v = qkv.split(C, -1)
    logits = np.einsum("bqd,bkd->bqk", raw["qkv"][..., :D], raw["qkv"][..., C:C + D])
    assert (logits * D ** -0.5 * np.log2(np.e) > 80).any()
    # the scaled v makes outputs of ~20: the f32 bound is relative there
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-4)
    clamped = tattn.pair_attention_plain(q, k, v, H, D ** -0.5)
    assert not torch.allclose(out, clamped, atol=1e-3)


def test_dispatch_rule():
    """The pair route iff head_dim == 64 and C % 128 == 0, as in the JAX
    package: head_dim 64 at C = 192 takes the 4-D route, at C = 128 the pair
    route (past the clamp the two routes give different answers)."""
    rng = np.random.default_rng(3)
    for c, heads, pair in ((192, 3, False), (128, 2, True)):
        qkv = _torch(rng.normal(size=(B, 9, 3 * c)) * 12.0, "float32")
        q, k, v = qkv.split(c, -1)
        out = tattn.fused_attention_packed_qkv(qkv, heads)
        four_d = tattn._merge(tattn.heads_attention_plain(
            *(tattn._heads(t, heads) for t in (q, k, v)), 0.125))
        clamped = tattn.pair_attention_plain(q, k, v, heads, 0.125)
        assert not torch.allclose(four_d, clamped, atol=1e-3)
        assert torch.equal(out, clamped if pair else four_d)


def test_rules_of_the_4d_route():
    x = torch.zeros(2, 8, 96)
    with pytest.raises(NotImplementedError, match=r"\(16, 32, 64, 128\)"):
        tattn.fused_attention_packed(x, x, x, 2)                  # head_dim 48
    with pytest.raises(NotImplementedError, match=r"\(16, 32, 64, 128\)"):
        tattn.fused_attention(*[torch.zeros(1, 2, 8, 24)] * 3)
    q = torch.zeros(1, 2, 8, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        tattn.fused_attention_heads(q, q.detach(), q.detach())
    with torch.no_grad():
        assert tattn.fused_attention_heads(q, q, q).shape == q.shape
    qp = torch.zeros(2, 8, 96, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        tattn.fused_attention_packed_kv_shared(qp, torch.zeros(1, 8, 192), 3)
    with pytest.raises(ValueError, match="does not split"):
        tattn.fused_attention_packed(x, x, x, 5)


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("entry", ["kv", "packed", "bhsd", "flat"])
def test_only_kv_shared_broadcasts_a_batch_1_kv(entry, grad):
    """A k/v batch that differs from q's raises in every layout but
    kv_shared, with and without grad: its gradient would have to be summed
    over the batch, which no backward kernel does."""
    q = torch.zeros(2, 8, 96, requires_grad=grad)
    q4 = torch.zeros(2, 3, 8, 32, requires_grad=grad)
    q3 = torch.zeros(6, 8, 32, requires_grad=grad)
    calls = {
        "kv": lambda: tattn.fused_attention_packed_kv(q, torch.zeros(1, 8, 192), 3),
        "packed": lambda: tattn.fused_attention_packed(
            q, torch.zeros(1, 8, 96), torch.zeros(1, 8, 96), 3),
        "bhsd": lambda: tattn.fused_attention(
            q4, torch.zeros(1, 3, 8, 32), torch.zeros(1, 3, 8, 32)),
        "flat": lambda: tattn.fused_attention_flat(
            q3, torch.zeros(1, 8, 32), torch.zeros(1, 8, 32)),
    }
    with pytest.raises(ValueError, match="does not match"):
        calls[entry]()
