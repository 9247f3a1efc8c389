"""The port's attention backward (vit_ed_tpu_torch/ops/attention.py) against
the JAX package's fused Pallas backward kernel ``_pair_backward``, run in
interpret mode on the CPU under ``jax.jit``.

On the CPU the port's ``autograd.Function`` runs
``pair_attention_backward_plain`` (the CUDA backward kernels' chain in plain
PyTorch); the kernels themselves are held against that plain version on the
card (tests/test_torch_cuda.py and chip_smoke.py). Inputs and cotangents come
import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
from numpy seeds and go to both frameworks as numpy arrays. Tolerances are
the JAX suite's own for its packed gradients (tests/test_attention.py:
f32 atol 5e-4 / rtol 1e-3, bf16 atol 3e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ed_tpu.ops.attention as jattn
from vit_ed_tpu_torch.ops import attention as tattn

H, C = 2, 128
SCALE = 64 ** -0.5
TOL = {"float32": dict(atol=5e-4, rtol=1e-3), "bfloat16": dict(atol=3e-2, rtol=0)}


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


def _jax(x, dtype):
    return jnp.asarray(np.asarray(x, np.float32), getattr(jnp, dtype))


def _torch(x, dtype, grad=False):
    t = torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    return t.requires_grad_() if grad else t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# multi-block sizes (> 512 query rows) walk the JAX kernel's dk/dv
# accumulation across grid steps and its padded-row and padded-column masks
@pytest.mark.parametrize("b,sq,sk,dtype", [
    (2, 70, 80, "float32"), (2, 600, 520, "float32"), (1, 513, 600, "float32"),
    (3, 1, 261, "float32"), (2, 261, 260, "bfloat16"), (2, 1, 65, "bfloat16")])
def test_backward_plain_matches_jax_kernel(b, sq, sk, dtype):
    rng = np.random.default_rng(sq * 1000 + sk)
    q, do = rng.normal(size=(2, b, sq, C))
    k, v = rng.normal(size=(2, b, sk, C))
    ref = jax.jit(lambda *a: jattn._pair_backward(*a, SCALE))(
        *(_jax(x, dtype) for x in (q, k, v, do)))
    out = tattn.pair_attention_backward_plain(
        *(_torch(x, dtype) for x in (q, k, v, do)), H, SCALE)
    for name, o, r in zip(("dq", "dk", "dv"), out, ref):
        assert o.dtype == getattr(torch, dtype) and tuple(o.shape) == r.shape
        np.testing.assert_allclose(_np(o), _np(r), err_msg=name, **TOL[dtype])


# wrapper -> (argument names, query rows of the output)
WRAPPERS = {
    "fused_attention_packed_qkv": (("qkv",), None),
    "fused_attention_packed_qkv_cls": (("qkv",), 1),
    "fused_attention_packed_kv": (("q", "kv"), None),
    "fused_attention_packed": (("q", "k", "v"), None),
}


def _wrapper_inputs(seed, b, sq, sk):
    rng = np.random.default_rng(seed)
    return {"qkv": rng.normal(size=(b, sq, 3 * C)), "q": rng.normal(size=(b, sq, C)),
            "kv": rng.normal(size=(b, sk, 2 * C)), "k": rng.normal(size=(b, sk, C)),
            "v": rng.normal(size=(b, sk, C)),
            "w": rng.normal(size=(b, sq, C))}


@pytest.mark.parametrize("dtype,b,sq,sk", [("float32", 2, 70, 80),
                                           ("float32", 1, 516, 516),
                                           ("bfloat16", 2, 261, 260)])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_vjp_matches_jax_grad(wrapper, dtype, b, sq, sk):
    """Each differentiable wrapper's gradient under a fixed cotangent w
    against ``jax.grad`` of the JAX wrapper on its Pallas path (custom VJP
    -> ``_pair_backward``)."""
    names, rows = WRAPPERS[wrapper]
    if "qkv" in names:
        sk = sq
    raw = _wrapper_inputs(sq + sk, b, sq, sk)
    w = raw["w"][:, :rows or sq]

    jfn = getattr(jattn, wrapper)
    grads_ref = jax.jit(jax.grad(
        lambda *a: jnp.sum(jfn(*a, H, use_pallas=True).astype(jnp.float32)
                           * jnp.asarray(w, jnp.float32)),
        argnums=tuple(range(len(names)))))(*(_jax(raw[n], dtype) for n in names))

    args = [_torch(raw[n], dtype, grad=True) for n in names]
    out = getattr(tattn, wrapper)(*args, H)
    assert tuple(out.shape) == w.shape
    out.backward(_torch(w, dtype))
    for n, a, r in zip(names, args, grads_ref):
        assert a.grad.dtype == a.dtype and a.grad.shape == a.shape
        np.testing.assert_allclose(_np(a.grad), _np(r), err_msg=n, **TOL[dtype])


@pytest.mark.parametrize("s", [64, 261])
def test_cls_gradient_is_the_full_gradient_of_row_0(s):
    """d/dqkv of the CLS wrapper == d/dqkv of ``qkv(...)[:, :1]`` (the JAX
    suite's bound for the same contract, test_attention.py:251), and the
    other query rows' dq is exactly zero."""
    rng = np.random.default_rng(s)
    raw = rng.normal(size=(2, s, 3 * C))
    w = _torch(rng.normal(size=(2, 1, C)), "float32")
    a = _torch(raw, "float32", grad=True)
    tattn.fused_attention_packed_qkv_cls(a, H).backward(w)
    b = _torch(raw, "float32", grad=True)
    tattn.fused_attention_packed_qkv(b, H)[:, :1].backward(w)
    assert torch.count_nonzero(a.grad[:, 1:, :C]) == 0
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-4, atol=2e-5)


def test_backward_is_not_autograd_of_the_forward_chain():
    """The VJP is the max-subtracted softmax's, as in the JAX package, not
    the derivative of the forward's clamped exp2 chain: past the clamp the
    forward saturates (its own derivative would vanish there) while the VJP
    still follows softmax."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(1, 65, 3 * C)) * 12.0
    w = _torch(rng.normal(size=(1, 65, C)), "float32")
    a = _torch(raw, "float32", grad=True)
    tattn.fused_attention_packed_qkv(a, H).backward(w)
    q, k, v = (t.detach().requires_grad_() for t in
               _torch(raw, "float32").split(C, -1))
    tattn.pair_attention_plain(q, k, v, H, SCALE).backward(w)
    chain = torch.cat([q.grad, k.grad, v.grad], -1)
    assert not torch.allclose(a.grad, chain, atol=1e-3)
    ref = tattn.pair_attention_backward_plain(
        *_torch(raw, "float32").split(C, -1), w, H, SCALE)
    np.testing.assert_array_equal(a.grad.numpy(), torch.cat(ref, -1).numpy())


def test_kv_shared_is_eval_only():
    q = torch.zeros(2, 8, C, requires_grad=True)
    kv = torch.zeros(1, 8, 2 * C)
    with pytest.raises(RuntimeError, match="eval-only"):
        tattn.fused_attention_packed_kv_shared(q, kv, H)
    with torch.no_grad():
        assert tattn.fused_attention_packed_kv_shared(q, kv, H).shape == (2, 8, C)


def test_no_grad_inputs_take_the_plain_forward_path():
    """Without an input that requires grad no autograd node is recorded."""
    qkv = torch.randn(1, 8, 3 * C)
    assert tattn.fused_attention_packed_qkv(qkv, H).grad_fn is None
    with torch.no_grad():
        out = tattn.fused_attention_packed_qkv(qkv.requires_grad_(), H)
    assert out.grad_fn is None and not out.requires_grad
    # one counter for each of the two backward kernels of every VJP
    assert set(tattn.launches) >= {f"{name}_{kernel}" for kernel in ("dq", "dkv")
                                   for name in ("qkv", "qkv_cls", "kv", "packed")}
