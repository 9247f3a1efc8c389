"""The pair-attention CUDA kernels, forward and backward, against their
plain PyTorch versions, on the card. Every test here carries the ``cuda`` marker and skips without a card
(the kernel has no CPU mode). The file imports nothing of JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from vit_ed_tpu_torch.ops import attention as A

H, C, B = 2, 128, 3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from vit_ed_tpu_torch.device import resolve_device

    return resolve_device("cuda")


def _inputs(seed, s, dtype):
    rng = np.random.default_rng(seed)
    shapes = {"qkv": (B, s, 3 * C), "q": (B, s, C), "kv": (B, s - 1, 2 * C),
              "kv1": (1, s - 1, 2 * C), "k": (B, s - 1, C), "v": (B, s - 1, C)}
    return {n: torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for n, sh in shapes.items()}


CALLS = {
    "qkv": lambda a: A.fused_attention_packed_qkv(a["qkv"], H),
    "kv_shared": lambda a: A.fused_attention_packed_kv_shared(a["q"], a["kv1"], H),
    "qkv_cls": lambda a: A.fused_attention_packed_qkv_cls(a["qkv"], H),
    "kv": lambda a: A.fused_attention_packed_kv(a["q"], a["kv"], H),
    "packed": lambda a: A.fused_attention_packed(a["q"], a["k"], a["v"], H),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 261])
@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_kernel_matches_plain(card, wrapper, s, dtype):
    cpu = _inputs(s, s, dtype)
    before = A.launches[wrapper]
    with torch.inference_mode():
        out = CALLS[wrapper]({n: t.to(card) for n, t in cpu.items()})
        torch.cuda.synchronize()
    assert A.launches[wrapper] == before + 1
    plain = CALLS[wrapper](cpu)
    assert out.dtype == dtype and out.shape == plain.shape
    np.testing.assert_allclose(out.float().cpu().numpy(), plain.float().numpy(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shared_and_cls_are_bit_exact_on_card(card, dtype):
    a = {n: t.to(card) for n, t in _inputs(1, 261, dtype).items()}
    with torch.inference_mode():
        shared = A.fused_attention_packed_kv_shared(a["q"], a["kv1"], H)
        bcast = A.fused_attention_packed_kv(
            a["q"], a["kv1"].expand(B, -1, -1).contiguous(), H)
        cls = A.fused_attention_packed_qkv_cls(a["qkv"], H)
        full = A.fused_attention_packed_qkv(a["qkv"], H)
        torch.cuda.synchronize()
    assert torch.equal(shared, bcast)
    assert torch.equal(cls, full[:, :1])


@pytest.mark.cuda
def test_kernel_rules_on_card(card):
    x = torch.zeros(2, 8, 96, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP queue B, slice 3"):
        A.fused_attention_packed(x, x, x, 3)
    q = torch.zeros(2, 8, C, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        A.fused_attention_packed_kv_shared(q, torch.zeros(1, 8, 2 * C, device=card), H)


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
VJPS = {"qkv": ("qkv",), "qkv_cls": ("qkv",), "kv": ("q", "kv"),
        "packed": ("q", "k", "v")}


def _grads(wrapper, inputs, do):
    args = [inputs[n].detach().clone().requires_grad_() for n in VJPS[wrapper]]
    CALLS[wrapper](dict(zip(VJPS[wrapper], args))).backward(do)
    return [a.grad for a in args]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 261, 600])
@pytest.mark.parametrize("wrapper", sorted(VJPS))
def test_backward_kernel_matches_plain(card, wrapper, s, dtype):
    """Each VJP on the card (the backward kernels) against the same VJP on
    the CPU (``pair_attention_backward_plain``): f32 within 1e-4 of the
    gradient's max, bf16 within 2e-2; two launches give the same bits (the
    kernels use no atomics)."""
    cpu = _inputs(s + 1, s, dtype)
    rows = 1 if wrapper == "qkv_cls" else s
    do = torch.from_numpy(np.random.default_rng(s).normal(
        size=(B, rows, C)).astype(np.float32)).to(dtype)
    dev = {n: t.to(card) for n, t in cpu.items()}
    before = A.launches[wrapper + "_bwd"]
    got = _grads(wrapper, dev, do.to(card))
    again = _grads(wrapper, dev, do.to(card))
    torch.cuda.synchronize()
    assert A.launches[wrapper + "_bwd"] == before + 2
    ref = _grads(wrapper, cpu, do)
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        assert g.dtype == dtype and g.shape == r.shape
        scale = max(r.float().abs().max().item(), 1.0 if dtype == torch.bfloat16 else 1e-6)
        err = (g.float().cpu() - r.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * scale, (err, scale)
    if wrapper == "qkv_cls":
        assert torch.count_nonzero(got[0][:, 1:, :C]) == 0


@pytest.mark.cuda
def test_training_on_card_matches_cpu_and_recomputation(card):
    """A small ViT-ED in training mode on the card: f32 gradients through
    the kernels against the CPU's plain versions (drop path 0), and with
    drop path 0.5 on a CUDA generator the recomputed blocks
    (``use_checkpoint``) give the gradients of the plain run."""
    from vit_ed_tpu_torch.models.vit_ed import ViTED

    kw = dict(embed_dim=128, num_heads=2, depth=1, c_depth=2, img_size=64,
              patch_size=16, num_classes=1)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 2, 64, 64, 3)).astype(np.float32))

    def grads(device, **extra):
        torch.manual_seed(0)
        model = ViTED(**kw, **extra).to(device).train()
        model.seed_drop_path(3)
        model(x.to(device)).sum().backward()
        return {n: p.grad.cpu() for n, p in model.named_parameters()}

    cpu, dev = grads("cpu"), grads(card)
    for n in cpu:
        err = (dev[n] - cpu[n]).abs().max().item()
        assert err <= 1e-4 * max(cpu[n].abs().max().item(), 1e-12), n
    plain = grads(card, drop_path_rate=0.5)
    ckpt = grads(card, drop_path_rate=0.5, use_checkpoint=True)
    for n in plain:
        np.testing.assert_allclose(ckpt[n].numpy(), plain[n].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    assert any(not torch.equal(plain[n], dev[n]) for n in plain)
