"""The attention CUDA kernels (pair and 4-D routes), forward and backward,
against their plain PyTorch versions, on the card. Every test here carries the ``cuda`` marker and skips without a card
(the kernel has no CPU mode). The file imports nothing of JAX, so it runs
on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import math

import numpy as np
import pytest
import torch

from vit_ed_tpu_torch.ops import attention as A

H, C, B = 2, 128, 3
# a forward output against its plain version: max |out - plain| over max
# |plain| (as _grad_err for gradients). Between the sound readings and the
# readings of a kernel that drops the last key or the last query row of a
# ragged tile (dominant_last_key makes both O(1)); PERF.md has both.
FWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def dominant_last_key(q, k, v):
    """In place on f32 [..., Sq, D] / [..., Sk, D] views: every q row gets the
    component 2 along u = (1, ..., 1) / sqrt(D) and the last key is
    (ln(Sk) + 1) * sqrt(D) / 2 * u, so that its logit q.k / sqrt(D) is ln(Sk)
    + 1 in every row, a softmax weight of ~0.6 against Sk - 1 unit-normal
    keys (the pair route's exp2 chain gives the same weights); the last
    value row is (3, -3, 3, ...). A kernel that drops the last key, or the
    last query row, is then off by O(1) of the output's max."""
    d, n_k = q.shape[-1], k.shape[-2]
    u = torch.full((d,), d ** -0.5)
    q -= (q @ u)[..., None] * u
    q += 2 * u
    k[..., -1, :] = (math.log(n_k) + 1) * d ** 0.5 / 2 * u
    v[..., -1, :] = 3.0 - 6.0 * (torch.arange(d) % 2)


def _reading(what, x, ref):
    """max |x - ref| / max |ref|: an output's error against its own largest
    element, in both types (no absolute floor, which would pass a zeroed
    row or gradient whose elements are all small). Printed, so that a run
    with -s shows the readings the tolerances are set between."""
    err = (x.float().cpu() - ref.float().cpu()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-12)
    print(f"{what} reading {str(x.dtype)[6:]} {tuple(x.shape)} {rel:.3e}")
    return rel


def _fwd_err(out, ref):
    return _reading("forward", out, ref)


def _poison(like, device):
    """A NaN-filled tensor of ``like``'s shape and type: the output a forward
    check hands the kernel, so that an element it never stores reads NaN,
    whatever the allocator did before."""
    return torch.full(tuple(like.shape), float("nan"), dtype=like.dtype,
                      device=device)


# each wrapper's inputs, by layout (the names of _probed_inputs)
ARGS = {"qkv": ("qkv",), "kv_shared": ("q", "kv1"), "qkv_cls": ("qkv",),
        "kv": ("q", "kv"), "packed": ("q", "k", "v"), "bhsd": ("q4", "k4", "v4"),
        "bhsd_eval": ("q4", "k4", "v4"), "flat": ("q3", "k3", "v3")}


def _forward_into(layout, h, a, out=None):
    """A wrapper's forward on the inputs ``a`` through ``A._attend``, the
    dispatch every wrapper makes, writing into ``out`` when given."""
    tensors = [a[n] for n in ARGS[layout]]
    return A._attend(layout, tensors, h, None, out=out)


def _probed_inputs(seed, sq, sk, dtype, c=C, h=H):
    """Every wrapper's inputs (self-attention Sq rows of qkv, the cross
    layouts Sq rows of q against Sk keys), made from a numpy seed with the
    last key of every (batch, head) dominant (``dominant_last_key``)."""
    rng = np.random.default_rng(seed)
    d = c // h
    shapes = {"qkv": (B, sq, 3 * c), "q": (B, sq, c), "kv": (B, sk, 2 * c),
              "kv1": (1, sk, 2 * c), "k": (B, sk, c), "v": (B, sk, c),
              "q4": (B, h, sq, d), "k4": (B, h, sk, d), "v4": (B, h, sk, d),
              "q3": (B * h, sq, d), "k3": (B * h, sk, d), "v3": (B * h, sk, d)}
    t = {n: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
         for n, sh in shapes.items()}

    def heads(name, i):
        return A._heads(t[name][..., i * c:(i + 1) * c], h)

    q = heads("q", 0)
    for group in ((heads("qkv", 0), heads("qkv", 1), heads("qkv", 2)),
                  (q, heads("kv", 0), heads("kv", 1)), (q, heads("kv1", 0), heads("kv1", 1)),
                  (q, heads("k", 0), heads("v", 0)), (t["q4"], t["k4"], t["v4"]),
                  (t["q3"], t["k3"], t["v3"])):
        dominant_last_key(*group)     # q's changes are the same each time
    return {n: x.to(dtype) for n, x in t.items()}


def _check_forward(layout, h, cpu, device, dtype):
    """The wrapper of ``layout`` (``h`` heads) on the card twice (bit-equal)
    against the same call on the CPU (the plain version), each launch
    writing into an output filled with NaN."""
    plain = _forward_into(layout, h, cpu)
    dev = {n: x.to(device) for n, x in cpu.items()}
    outs = []
    with torch.inference_mode():
        for _ in range(2):
            poisoned = _poison(plain, device)
            outs.append(_forward_into(layout, h, dev, poisoned))
            assert outs[-1].data_ptr() == poisoned.data_ptr()
        torch.cuda.synchronize()
    out, again = outs
    assert out.dtype == dtype and out.shape == plain.shape
    err = _fwd_err(out, plain)
    assert torch.equal(out, again)
    assert err <= FWD_TOL[dtype], err


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
    cpu = _probed_inputs(s, s, s - 1, dtype)
    before = A.launches[wrapper]
    _check_forward(wrapper, H, cpu, card, dtype)
    assert A.launches[wrapper] == before + 2


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
    before = A.launches["heads_packed"]
    assert A.fused_attention_packed(x, x, x, 3).shape == (2, 8, 96)   # d = 32
    assert A.launches["heads_packed"] == before + 1
    with pytest.raises(NotImplementedError, match=r"\(16, 32, 64, 128\)"):
        A.fused_attention_packed(x, x, x, 2)                          # d = 48
    with pytest.raises(NotImplementedError, match="head_dim 64 only"):
        A._launch("packed", x, x, x, (0, 0, 0), 96, 3, 8, 0.2)
    q = torch.zeros(2, 8, C, device=card, requires_grad=True)
    with pytest.raises(RuntimeError, match="eval-only"):
        A.fused_attention_packed_kv_shared(q, torch.zeros(1, 8, 2 * C, device=card), H)
    # only kv_shared broadcasts a batch-1 kv: on the 4-D route the others
    # raise, with and without grad, as they do on the CPU
    for grad in (False, True):
        q = torch.zeros(2, 8, 96, device=card, requires_grad=grad)
        before = dict(A.launches)
        with pytest.raises(ValueError, match="does not match"):
            A.fused_attention_packed_kv(q, torch.zeros(1, 8, 192, device=card), 3)
        assert A.launches == before


BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _grad_err(g, r):
    return _reading("grad", g, r)

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
    the CPU (``pair_attention_backward_plain``): f32 within 1e-4 and bf16
    within 2e-2 of each gradient's max; two runs give the same bits (the
    kernels use no atomics). The pair route runs the dq and dk/dv kernels
    of heads_attention_bwd.cu at head_dim 64."""
    cpu = _inputs(s + 1, s, dtype)
    rows = 1 if wrapper == "qkv_cls" else s
    do = torch.from_numpy(np.random.default_rng(s).normal(
        size=(B, rows, C)).astype(np.float32)).to(dtype)
    dev = {n: t.to(card) for n, t in cpu.items()}
    before = (A.launches[wrapper + "_dq"], A.launches[wrapper + "_dkv"])
    got = _grads(wrapper, dev, do.to(card))
    again = _grads(wrapper, dev, do.to(card))
    torch.cuda.synchronize()
    assert (A.launches[wrapper + "_dq"],
            A.launches[wrapper + "_dkv"]) == (before[0] + 2, before[1] + 2)
    ref = _grads(wrapper, cpu, do)
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        assert g.dtype == dtype and g.shape == r.shape
        err = _grad_err(g, r)
        assert err <= BWD_TOL[dtype], err
    if wrapper == "qkv_cls":
        assert torch.count_nonzero(got[0][:, 1:, :C]) == 0


# pjs-S at michigan_patch16_384: C = 384, 6 heads of 64, 576 patches, so the
# decoder's self-attention runs at S = 577 = 9 * 64 + 1 (one row past a
# whole tile) and its cross-attention reads the encoder's 576 keys
MC, MH = 384, 6
M_CALLS = {
    "qkv": lambda a: A.fused_attention_packed_qkv(a["qkv"], MH),
    "kv_shared": lambda a: A.fused_attention_packed_kv_shared(a["q"], a["kv1"], MH),
    "qkv_cls": lambda a: A.fused_attention_packed_qkv_cls(a["qkv"], MH),
    "kv": lambda a: A.fused_attention_packed_kv(a["q"], a["kv"], MH),
    "packed": lambda a: A.fused_attention_packed(a["q"], a["k"], a["v"], MH),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq", [576, 577])
@pytest.mark.parametrize("wrapper", sorted(M_CALLS))
def test_kernel_matches_plain_at_the_michigan_width(card, wrapper, sq, dtype):
    """Every pair forward at C = 384, H = 6: Sq = 577 (the decoder) and 576
    (the encoder's self-attention), the cross layouts against 576 keys; the
    last key dominates and the output starts as NaN, as in
    ``test_kernel_matches_plain``."""
    cpu = _probed_inputs(sq + 7, sq, 576, dtype, c=MC, h=MH)
    before = A.launches[wrapper]
    _check_forward(wrapper, MH, cpu, card, dtype)
    assert A.launches[wrapper] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [576, 577])
@pytest.mark.parametrize("wrapper", sorted(VJPS))
def test_backward_kernel_matches_plain_at_the_michigan_width(card, wrapper, s, dtype):
    """Each VJP at C = 384, H = 6, S = 577 / 576 (Michigan training: the
    decoder's qkv, its CLS row and the cross-attention against the
    encoder's 576 keys; the encoder's qkv at 576) against the CPU's plain
    backward, within the tolerances of
    ``test_backward_kernel_matches_plain``; two runs bit-equal."""
    rng = np.random.default_rng(s)
    shapes = {"qkv": (B, s, 3 * MC), "q": (B, s, MC), "kv": (B, 576, 2 * MC),
              "k": (B, 576, MC), "v": (B, 576, MC)}
    cpu = {n: torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
           for n, sh in shapes.items()}
    rows = 1 if wrapper == "qkv_cls" else s
    do = torch.from_numpy(rng.normal(size=(B, rows, MC)).astype(np.float32)).to(dtype)

    def grads(inputs, d):
        args = [inputs[n].detach().clone().requires_grad_() for n in VJPS[wrapper]]
        M_CALLS[wrapper](dict(zip(VJPS[wrapper], args))).backward(d)
        return [a.grad for a in args]

    dev = {n: t.to(card) for n, t in cpu.items()}
    before = A.launches[wrapper + "_dq"]
    got, again = grads(dev, do.to(card)), grads(dev, do.to(card))
    torch.cuda.synchronize()
    assert A.launches[wrapper + "_dq"] == before + 2
    for g, g2, r in zip(got, again, grads(cpu, do)):
        assert torch.equal(g, g2)
        assert g.dtype == dtype and g.shape == r.shape
        err = _grad_err(g, r)
        assert err <= BWD_TOL[dtype], err
    if wrapper == "qkv_cls":
        assert torch.count_nonzero(got[0][:, 1:, :MC]) == 0


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


# ---------------------------------------------------------------------------
# the 4-D route: head_dim 32 through every wrapper, 16 / 64 / 128 at one shape
# ---------------------------------------------------------------------------

HC, HH = 96, 3      # 3 heads of head_dim 32


def _heads_inputs(seed, s, dtype, c=HC, h=HH):
    rng = np.random.default_rng(seed)
    d = c // h
    shapes = {"qkv": (B, s, 3 * c), "q": (B, s, c), "kv": (B, s - 1, 2 * c),
              "kv1": (1, s - 1, 2 * c), "k": (B, s - 1, c), "v": (B, s - 1, c),
              "q4": (B, h, s, d), "k4": (B, h, s - 1, d), "v4": (B, h, s - 1, d),
              "q3": (B * h, s, d), "k3": (B * h, s - 1, d), "v3": (B * h, s - 1, d)}
    return {n: torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(dtype)
            for n, sh in shapes.items()}


HEADS_CALLS = {
    "qkv": lambda a: A.fused_attention_packed_qkv(a["qkv"], HH),
    "kv_shared": lambda a: A.fused_attention_packed_kv_shared(a["q"], a["kv1"], HH),
    "qkv_cls": lambda a: A.fused_attention_packed_qkv_cls(a["qkv"], HH),
    "kv": lambda a: A.fused_attention_packed_kv(a["q"], a["kv"], HH),
    "packed": lambda a: A.fused_attention_packed(a["q"], a["k"], a["v"], HH),
    "bhsd": lambda a: A.fused_attention(a["q4"], a["k4"], a["v4"]),
    "bhsd_eval": lambda a: A.fused_attention_heads(a["q4"], a["k4"], a["v4"]),
    "flat": lambda a: A.fused_attention_flat(a["q3"], a["k3"], a["v3"]),
}
HEADS_VJPS = {"qkv": ("qkv",), "qkv_cls": ("qkv",), "kv": ("q", "kv"),
              "packed": ("q", "k", "v"), "bhsd": ("q4", "k4", "v4"),
              "flat": ("q3", "k3", "v3")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 65, 261])
@pytest.mark.parametrize("wrapper", sorted(HEADS_CALLS))
def test_heads_kernel_matches_plain(card, wrapper, s, dtype):
    """Every wrapper at head_dim 32 on the card (heads_attention.cu) against
    the same call on the CPU (``heads_attention_plain``); S = 64 is the
    puzzle encoder's self-attention (no CLS token, one full tile)."""
    cpu = _probed_inputs(s, s, s - 1, dtype, c=HC, h=HH)
    before = A.launches["heads_" + wrapper]
    _check_forward(wrapper, HH, cpu, card, dtype)
    assert A.launches["heads_" + wrapper] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_shared_and_cls_are_bit_exact_on_card(card, dtype):
    a = {n: t.to(card) for n, t in _heads_inputs(1, 261, dtype).items()}
    with torch.inference_mode():
        shared = A.fused_attention_packed_kv_shared(a["q"], a["kv1"], HH)
        bcast = A.fused_attention_packed_kv(
            a["q"], a["kv1"].expand(B, -1, -1).contiguous(), HH)
        cls = A.fused_attention_packed_qkv_cls(a["qkv"], HH)
        full = A.fused_attention_packed_qkv(a["qkv"], HH)
        torch.cuda.synchronize()
    assert torch.equal(shared, bcast)
    assert torch.equal(cls, full[:, :1])


def _heads_grads(wrapper, inputs, do):
    args = [inputs[n].detach().clone().requires_grad_() for n in HEADS_VJPS[wrapper]]
    HEADS_CALLS[wrapper](dict(zip(HEADS_VJPS[wrapper], args))).backward(do)
    return [a.grad for a in args]


def _assert_grads_close(got, again, ref, dtype):
    for g, g2, r in zip(got, again, ref):
        assert torch.equal(g, g2)
        assert g.dtype == dtype and g.shape == r.shape
        err = _grad_err(g, r)
        assert err <= BWD_TOL[dtype], err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [64, 65, 261])
@pytest.mark.parametrize("wrapper", sorted(HEADS_VJPS))
def test_heads_backward_kernels_match_plain(card, wrapper, s, dtype):
    """Each VJP of the 4-D route on the card (heads_attention_bwd.cu: dq,
    then dk/dv) against the same VJP on the CPU
    (``attention_backward_plain``): f32 within 1e-4 and bf16 within 2e-2
    of each gradient's max; two runs give the same bits."""
    cpu = _heads_inputs(s + 1, s, dtype)
    ref_out = HEADS_CALLS[wrapper](cpu)
    do = torch.from_numpy(np.random.default_rng(s).normal(
        size=tuple(ref_out.shape)).astype(np.float32)).to(dtype)
    dev = {n: t.to(card) for n, t in cpu.items()}
    before = (A.launches[f"heads_{wrapper}_dq"], A.launches[f"heads_{wrapper}_dkv"])
    got = _heads_grads(wrapper, dev, do.to(card))
    again = _heads_grads(wrapper, dev, do.to(card))
    torch.cuda.synchronize()
    assert (A.launches[f"heads_{wrapper}_dq"],
            A.launches[f"heads_{wrapper}_dkv"]) == (before[0] + 2, before[1] + 2)
    _assert_grads_close(got, again, _heads_grads(wrapper, cpu, do), dtype)
    if wrapper == "qkv_cls":
        assert torch.count_nonzero(got[0][:, 1:, :HC]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 64, 128])
def test_other_head_dims_match_plain(card, d, dtype):
    """head_dim 16, 64 and 128 of the 4-D kernels, forward and the three
    gradients, on [B, H, S, D] and through the packed qkv wrapper (d = 64
    with C = 192 takes the 4-D route: C % 128 != 0)."""
    cpu = _probed_inputs(d, 70, 69, dtype, c=3 * d, h=3)
    dev = {n: t.to(card) for n, t in cpu.items()}
    for names, call in ((("q4", "k4", "v4"), lambda *a: A.fused_attention(*a)),
                        (("qkv",), lambda x: A.fused_attention_packed_qkv(x, 3))):
        def run(src):
            args = [src[n].detach().clone().requires_grad_() for n in names]
            out = call(*args)
            do = torch.from_numpy(np.random.default_rng(0).normal(
                size=tuple(out.shape)).astype(np.float32)).to(out)
            out.backward(do)
            return out.detach(), [a.grad for a in args]

        before = dict(A.launches)
        _, got = run(dev)
        _, again = run(dev)
        torch.cuda.synchronize()
        assert sum(A.launches.values()) == sum(before.values()) + 6
        assert all(A.launches[k] == before[k] for k in before if not k.startswith("heads_"))
        _, ref = run(cpu)
        _assert_grads_close(got, again, ref, dtype)
    # the forward, each launch writing into an output filled with NaN
    _check_forward("bhsd", 3, cpu, card, dtype)
    _check_forward("qkv", 3, cpu, card, dtype)


@pytest.mark.cuda
def test_puzzle_model_trains_on_card_like_cpu(card):
    """A small 4-class ViT-ED with head_dim 32 in training mode on a stacked
    pair: f32 logits and gradients through the 4-D kernels against the CPU's
    plain versions."""
    from vit_ed_tpu_torch.models.vit_ed import ViTED

    kw = dict(embed_dim=64, num_heads=2, depth=1, c_depth=2, img_size=32,
              patch_size=8, num_classes=4)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 2, 32, 32, 3)).astype(np.float32))

    def run(device):
        torch.manual_seed(0)
        model = ViTED(**kw).to(device).train()
        model.seed_drop_path(3)
        out = model(x.to(device))
        out.square().sum().backward()
        return out.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()}

    A.reset_launch_counts()
    (out_cpu, cpu), (out_dev, dev) = run("cpu"), run(card)
    assert A.launches["heads_qkv"] == 2 and A.launches["heads_qkv_cls"] == 1
    assert A.launches["heads_kv"] == 2 and A.launches["heads_kv_dkv"] == 2
    np.testing.assert_allclose(out_dev.numpy(), out_cpu.numpy(), atol=1e-5)
    for n in cpu:
        err = (dev[n] - cpu[n]).abs().max().item()
        assert err <= 1e-4 * max(cpu[n].abs().max().item(), 1e-12), n


# ---------------------------------------------------------------------------
# the backward kernels alone (heads_attention_dq, then heads_attention_dkv):
# dq, dk, dv and the row statistics dq hands to dkv, at ragged lengths
# ---------------------------------------------------------------------------

BWD_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1025]
# (Sq, Sk): every length against itself, and a few lengths against others
BWD_SHAPES = ([(s, s) for s in BWD_LENGTHS]
              + [(1, 65), (65, 1), (17, 129), (129, 17), (64, 1025), (1025, 63)])


def _stats_plain(q, k, v, do, scale):
    """[3, B, H, Sq]: the softmax row max of s = q k^T * scale, 1 / sum
    exp(s - max) and delta = rowsum(dp * p), in f32 from the same inputs."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    m = s.amax(-1)
    il = 1.0 / torch.exp(s - m[..., None]).sum(-1)
    dp = do.float() @ v.float().transpose(-1, -2)
    return torch.stack([m, il, (dp * torch.softmax(s, -1)).sum(-1)])


def _bwd_kernels(layout, q, k, v, do, scale, grads):
    """Both backward launches on [B, H, S, D] views; ``grads`` are the dq, dk,
    dv views they write. Returns (dq, dk, dv, stats) as fresh tensors."""
    dq, dk, dv = grads
    stats = A._launch_heads_dq(layout, q, k, v, do, dq, scale)
    A._launch_heads_dkv(layout, q, k, v, do, dk, dv, stats, scale)
    torch.cuda.synchronize()
    return [x.clone() for x in (dq, dk, dv, stats)]


def _assert_bwd_matches(got, again, q, k, v, do, scale, dtype):
    """Kernel gradients and statistics against ``attention_backward_plain``
    and ``_stats_plain`` on the same views (gradients within the tolerance of
    their max, as the wrappers' tests; the f32 statistics within 1e-4 of
    theirs), and two runs bit for bit."""
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    ref = [*A.attention_backward_plain(q, k, v, do, scale),
           _stats_plain(q, k, v, do, scale)]
    for name, g, r in zip(("dq", "dk", "dv", "stats"), got, ref):
        assert g.shape == r.shape and torch.isfinite(g).all(), name
        if name == "stats":
            for i in range(3):
                err = (g[i] - r[i]).abs().max().item()
                assert err <= 1e-4 * max(r[i].abs().max().item(), 1e-6), (name, i, err)
            continue
        assert g.dtype == dtype, name
        err = _grad_err(g, r)
        assert err <= BWD_TOL[dtype], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sq,sk", BWD_SHAPES)
def test_backward_kernels_at_ragged_lengths(card, sq, sk, d, dtype):
    """dq, dk, dv and the statistics buffer on contiguous [B, H, S, D]
    tensors, for query and key counts around the 16- and 64-row tiles (a
    ragged last tile computes only its groups that hold a real row)."""
    rng = np.random.default_rng(sq * 7919 + sk * 31 + d)
    shapes = ((2, 2, sq, d), (2, 2, sk, d), (2, 2, sk, d), (2, 2, sq, d))
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(np.float32)).to(card, dtype)
                   for sh in shapes)
    scale = d ** -0.5

    def run():
        grads = [torch.empty_like(x) for x in (q, k, v)]
        return _bwd_kernels("bhsd", q, k, v, do, scale, grads)

    _assert_bwd_matches(run(), run(), q, k, v, do, scale, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [1, 17, 65, 129])
@pytest.mark.parametrize("layout", ["qkv", "qkv_cls", "kv", "packed", "bhsd", "flat",
                                    "kv_stride0"])
def test_backward_kernels_through_layout_views(card, layout, s, d, dtype):
    """The two launches on the views each wrapper hands them: column slices
    of a fused qkv / kv projection (and its CLS row), separate tensors,
    [B, H, S, D], [B*H, S, D], and k / v of batch stride 0 (a batch-1 kv
    read by every q; dk and dv go to buffers of their own)."""
    h = 3
    cpu = _heads_inputs(100 * s + d, s + 1, dtype, c=h * d, h=h)
    t = {n: x.to(card) for n, x in cpu.items()}
    if layout == "kv_stride0":
        q = t["q4"]
        k, v = (x[:1].expand(B, -1, -1, -1) for x in (t["k4"], t["v4"]))
        views = (q, k, v)
        grads = [torch.empty(x.shape, dtype=dtype, device=card) for x in views]
        assert k.stride(0) == 0
        name = "bhsd"
    else:
        tensors = [t[n] for n in HEADS_VJPS[layout]]
        views = A._heads_views(layout, tensors, h)
        bufs = [torch.empty_like(x) for x in tensors]
        grads = A._heads_views(layout, bufs, h)
        name = layout
    q, k, v = views
    do = torch.from_numpy(np.random.default_rng(s).normal(
        size=tuple(q.shape)).astype(np.float32)).to(card, dtype)
    scale = d ** -0.5
    got = _bwd_kernels(name, q, k, v, do, scale, grads)
    again = _bwd_kernels(name, q, k, v, do, scale, grads)
    _assert_bwd_matches(got, again, q, k, v, do, scale, dtype)


# ---------------------------------------------------------------------------
# the forward kernels at ragged lengths (the last key of every (batch, head)
# dominant): heads_attention.cu's one-pass instantiations (Sk <= 64: one
# resident key tile, <= 128: two) and its ring (Sk > 128), and
# pair_attention.cu's ragged key tiles and last query tiles
# ---------------------------------------------------------------------------

FWD_LENGTHS = [1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1025]


def _probed_bhsd(seed, sq, sk, d, dtype, b=2, h=2):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(b, h, n, d)).astype(np.float32))
               for n in (sq, sk, sk))
    dominant_last_key(q, k, v)
    return {"q4": q.to(dtype), "k4": k.to(dtype), "v4": v.to(dtype)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("sk", FWD_LENGTHS)
@pytest.mark.parametrize("sq", FWD_LENGTHS)
def test_heads_forward_at_ragged_lengths(card, sq, sk, d, dtype):
    """The 4-D forward on contiguous [B, H, S, D] (``fused_attention_heads``)
    for every pair of query and key counts around the 16-row warps, the
    64-key tiles and the 128-key limit of the one-pass scheme."""
    cpu = _probed_bhsd(sq * 7919 + sk * 31 + d, sq, sk, d, dtype)
    _check_forward("bhsd_eval", HH, cpu, card, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("s", [1, 17, 65, 129, 1025])
@pytest.mark.parametrize("wrapper", sorted(HEADS_CALLS))
def test_heads_forward_through_layout_views(card, wrapper, s, d, dtype):
    """Every wrapper of the 4-D route at S query rows and S keys: column
    slices of a fused qkv / kv projection and its CLS row, a batch-1 kv read
    with batch stride 0, separate tensors, [B, H, S, D] and [B*H, S, D]
    (d = 64 at C = 192 takes the 4-D route: C % 128 != 0)."""
    cpu = _probed_inputs(100 * s + d, s, s, dtype, c=3 * d, h=HH)
    before = A.launches["heads_" + wrapper]
    _check_forward(wrapper, HH, cpu, card, dtype)
    assert A.launches["heads_" + wrapper] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 17, 65, 129, 1025])
@pytest.mark.parametrize("wrapper", sorted(CALLS))
def test_pair_forward_at_ragged_lengths(card, wrapper, s, dtype):
    """Every pair-route wrapper at S query rows and S keys: a key tile of
    1 or 17 real keys, and (S = 1025) a last query tile of one row."""
    cpu = _probed_inputs(s + 7, s, s, dtype)
    before = A.launches[wrapper]
    _check_forward(wrapper, H, cpu, card, dtype)
    assert A.launches[wrapper] == before + 2


def _contract_runs(a, h):
    """(shared kv, its materialised broadcast, CLS, full self-attention),
    twice."""
    with torch.inference_mode():
        runs = [(A.fused_attention_packed_kv_shared(a["q"], a["kv1"], h),
                 A.fused_attention_packed_kv(
                     a["q"], a["kv1"].expand(B, -1, -1).contiguous(), h),
                 A.fused_attention_packed_qkv_cls(a["qkv"], h),
                 A.fused_attention_packed_qkv(a["qkv"], h)) for _ in range(2)]
        torch.cuda.synchronize()
    for x, y in zip(*runs):
        assert torch.equal(x, y)
    return runs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("s", [17, 64, 65, 128, 129, 1025])
def test_heads_cls_and_shared_are_bit_exact_at_every_scheme(card, s, d, dtype):
    """CLS == row 0 of the full launch and a shared kv == its broadcast, bit
    for bit, and each launch == its rerun: at one resident key tile (S <=
    64), two (S <= 128) and the ring (S > 128)."""
    a = {n: x.to(card) for n, x in _probed_inputs(s, s, s, dtype, c=3 * d, h=HH).items()}
    shared, bcast, cls, full = _contract_runs(a, HH)
    assert torch.equal(shared, bcast)
    assert torch.equal(cls, full[:, :1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [17, 65, 1025])
def test_pair_cls_and_shared_are_bit_exact_at_ragged_lengths(card, s, dtype):
    a = {n: x.to(card) for n, x in _probed_inputs(s, s, s, dtype).items()}
    shared, bcast, cls, full = _contract_runs(a, H)
    assert torch.equal(shared, bcast)
    assert torch.equal(cls, full[:, :1])


# ---------------------------------------------------------------------------
# the bf16 GELU chain and the reproducible train step
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_gelu_chain_on_card_equals_cpu_on_every_bf16_input(card):
    """``_gelu_chain`` (ops/gelu.py) on the card against the CPU on all
    65,536 bf16 bit patterns, bit for bit; a NaN equals any NaN (its payload
    is no value). ``-s`` prints the count of differing patterns."""
    from vit_ed_tpu_torch.ops.gelu import _gelu_chain

    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    x = bits.view(torch.bfloat16)
    cpu = _gelu_chain(x)
    dev = _gelu_chain(x.to(card)).cpu()
    both_nan = torch.isnan(cpu) & torch.isnan(dev)
    differ = (cpu.view(torch.int16) != dev.view(torch.int16)) & ~both_nan
    print(f"gelu chain: {int(differ.sum())} of 65536 bf16 inputs differ, card "
          f"against CPU; first {x[differ][:8].float().tolist()}")
    assert int(differ.sum()) == 0


@pytest.mark.cuda
def test_hisfrag_train_steps_are_bit_reproducible(card, tmp_path):
    """Two trainers from one seed (weights, DropPath generator, mined pairs)
    take three bf16 steps with drop path 0.1 on the same batches: every
    parameter and optimizer moment is equal bit for bit (the pair gather's
    backward sums in a fixed order, ops/gather.py)."""
    import types

    from vit_ed_tpu_torch.hisfrag import HisfragTrainer

    opts = ["MODEL.PJS.EMBED_DIM", "128", "MODEL.PJS.NUM_HEADS", "2",
            "MODEL.PJS.DEPTH", "2", "MODEL.PJS.C_DEPTH", "2", "DATA.IMG_SIZE", "64",
            "MODEL.PJS.PATCH_SIZE", "16", "MODEL.DROP_PATH_RATE", "0.1",
            "TRAIN.AUTO_RESUME", "False"]

    def run(tag):
        trainer = HisfragTrainer(types.SimpleNamespace(
            cfg=None, device="cuda", mode="train", batch_size=8,
            accumulation_steps=1, disable_amp=False, output=str(tmp_path / tag),
            tag=tag, opts=opts))
        trainer.setup_training(3)
        rng = np.random.default_rng(0)
        np.random.seed(0)
        for _ in range(3):
            samples = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
            targets = rng.permutation(np.repeat(np.arange(4), 2)).astype(np.int32)
            trainer.train_step([trainer.prepare_data(samples, targets)])
        torch.cuda.synchronize()
        state = {f"param {n}": p.detach().cpu()
                 for n, p in trainer.model.named_parameters()}
        for i, s in trainer.optimizer.state_dict()["state"].items():
            state.update({f"opt {i} {k}": v.cpu() for k, v in s.items()
                          if torch.is_tensor(v)})
        return trainer.model.dtype, state

    (dtype, a), (_, b) = run("a"), run("b")
    assert dtype == torch.bfloat16
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    assert not differ, differ
