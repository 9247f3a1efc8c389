"""The pair-attention CUDA kernel against its plain PyTorch version, on the
card. Every test here carries the ``cuda`` marker and skips without a card
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
    w = torch.zeros(2, 8, 3 * C, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="training slice"):
        A.fused_attention_packed_qkv(w, H)
