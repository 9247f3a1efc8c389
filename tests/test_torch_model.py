"""The port's ViT-ED (vit_ed_tpu_torch/models) against the JAX ViTED on the
CPU: params made from a seed by flax go through ``jax_params_to_state_dict``
and load with ``strict=True``; the JAX side runs its Pallas pair kernel in
interpret mode, the port its plain attention.

Each calling mode gets the same numpy inputs on both sides (the JAX
reference's upstream outputs, for the token-taking methods), so a failure
points at one method. float32 is compared at 1e-4; bf16 logits at 5e-2,
which covers the rounding points the two frameworks place differently
(vit_ed_tpu_torch/models/layers.py lists them).
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ed_tpu.ops.attention as jattn
from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED

KW = dict(embed_dim=128, num_heads=2, depth=2, c_depth=2, img_size=64,
          patch_size=16, num_classes=1)
F32_TOL, BF16_LOGIT_TOL = 1e-4, 5e-2


@pytest.fixture(scope="module")
def env():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 2, 64, 64, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, size=(2, 2, 64, 64, 3), dtype=np.uint8)
    # the param tree does not depend on use_pallas; init on the XLA path
    params = jax.jit(JaxViTED(**KW, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    params = jax.tree.map(np.asarray, params)
    model = load_jax_params(ViTED(**KW), params).eval()
    saved = jattn._INTERPRET
    jattn._INTERPRET = True
    try:
        feats = _jax_apply(params, "encode", "float32", jnp.asarray(x[:, 0]))
        adv = _jax_apply(params, "prepare_x2_scan", "float32",
                         jnp.asarray(x[:, 1]))
        kv_row = _jax_apply(params, "context_kv_cache", "float32",
                            jnp.asarray(feats))
        # JAX outputs already computed, keyed like _run_both's cache
        refs = {("encode", "x", "float32"): feats,
                ("prepare_x2_scan", "x", "float32"): adv,
                ("context_kv_cache", "x", "float32"): kv_row}
        yield dict(x=x, x_u8=x_u8, params=params, model=model, feats=feats,
                   adv=adv, kv_row=kv_row[:, :1], refs=refs)
    finally:
        jattn._INTERPRET = saved


def _jax_apply(params, name, dtype, *args):
    """One jitted JAX apply (jit compiles the interpret-mode kernels once;
    eager interpret re-traces them at every call) -> float32 numpy."""
    jm = JaxViTED(**KW, use_pallas=True, dtype=getattr(jnp, dtype))
    method = None if name == "__call__" else getattr(JaxViTED, name)
    fn = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=method))
    return np.asarray(fn(params, *args).astype(jnp.float32))


# mode -> (jax method name, args builder); args are numpy and go to both
MODES = {
    "encode": ("encode", lambda e, img: (img[:, 0],)),
    "prepare_x2_scan": ("prepare_x2_scan", lambda e, img: (img[:, 1],)),
    "context_kv_cache": ("context_kv_cache", lambda e, img: (e["feats"],)),
    "score_tokens_row": ("score_tokens_row",
                         lambda e, img: (e["kv_row"], e["adv"])),
    "score_tokens_scan": ("score_tokens_scan",
                          lambda e, img: (e["feats"], e["adv"])),
    "decode_head": ("decode_head", lambda e, img: (e["feats"], img[:, 1])),
    "call": ("__call__", lambda e, img: (img,)),
}
IMAGE_MODES = ("encode", "prepare_x2_scan", "decode_head", "call")
LOGIT_MODES = ("score_tokens_row", "score_tokens_scan", "decode_head", "call")


def _run_both(env, mode, images, dtype):
    name, build = MODES[mode]
    args = build(env, env[images])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def is_image(a):  # images stay float32/uint8: the model casts them
        return a.ndim == 5 or (a.ndim == 4 and a.shape[-1] == 3)

    ref = env["refs"].get((mode, images, dtype))
    if ref is None:
        jargs = [jnp.asarray(a) if is_image(a) else jnp.asarray(a, jdt)
                 for a in args]
        ref = _jax_apply(env["params"], name, dtype, *jargs)
    model = env["model"]
    model.dtype = tdt
    targs = [torch.from_numpy(np.array(a)) for a in args]
    targs = [t if is_image(a) else t.to(tdt) for a, t in zip(args, targs)]
    with torch.inference_mode():
        fn = model if name == "__call__" else getattr(model, name)
        out = fn(*targs)
    assert out.dtype == tdt
    assert tuple(out.shape) == ref.shape
    return out.float().numpy(), ref


@pytest.mark.parametrize("mode,images", [(m, "x") for m in sorted(MODES)]
                         + [(m, "x_u8") for m in IMAGE_MODES])
def test_mode_matches_jax_f32(env, mode, images):
    out, ref = _run_both(env, mode, images, "float32")
    np.testing.assert_allclose(out, ref, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("mode", LOGIT_MODES + ("call_u8",))
def test_logits_match_jax_bf16(env, mode):
    images = "x_u8" if mode == "call_u8" else "x"
    out, ref = _run_both(env, mode.replace("_u8", ""), images, "bfloat16")
    np.testing.assert_allclose(out, ref, atol=BF16_LOGIT_TOL, rtol=0)


def test_state_dict_layout_is_the_reference_one(env):
    sd = jax_params_to_state_dict(env["params"])
    assert set(sd) == set(env["model"].state_dict())
    for key in ("blocks.0.attn.qkv.weight", "cross_blocks.1.cross_attn.kv.bias",
                "cross_blocks.0.norm_context.weight", "patch_embed.proj.weight",
                "pos_embed", "cls_token", "head.weight"):
        assert key in sd
    assert tuple(sd["blocks.0.attn.qkv.weight"].shape) == (384, 128)
    assert tuple(sd["patch_embed.proj.weight"].shape) == (128, 3, 16, 16)


def test_scan_decompositions_equal_plain_paths(env):
    """prepare_x2_scan + score_tokens_scan == prepare_x2 + score_tokens,
    context_kv_cache + score_tokens_kv == score_tokens_scan, and the
    row-shared score_tokens_row == score_tokens_scan with the row
    broadcast (the JAX suite's tests/test_model.py contracts)."""
    model = env["model"]
    model.dtype = torch.float32
    x = torch.from_numpy(env["x"])
    with torch.inference_mode():
        feats = model.encode(x[:, 0])
        ref = model.score_tokens(feats, model.prepare_x2(x[:, 1]))
        adv = model.prepare_x2_scan(x[:, 1])
        assert torch.equal(model.score_tokens_scan(feats, adv), ref)
        kv = model.context_kv_cache(feats)
        assert torch.equal(model.score_tokens_kv(kv, adv), ref)
        for row in range(feats.shape[0]):
            out_row = model.score_tokens_row(kv[:, row:row + 1], adv)
            feats_b = feats[row:row + 1].expand(adv.shape[0], -1, -1)
            ref_row = model.score_tokens_scan(feats_b, adv)
            np.testing.assert_allclose(out_row.numpy(), ref_row.numpy(),
                                       atol=1e-6, rtol=0)
        # the CLS short-circuit computes the same function as the full path
        model.cls_shortcut = False
        try:
            full = model.score_tokens_scan(feats, adv)
        finally:
            model.cls_shortcut = True
        np.testing.assert_allclose(full.numpy(), ref.numpy(), atol=1e-6)


def test_uint8_images_normalize_on_device(env):
    model = env["model"]
    model.dtype = torch.float32
    u8 = torch.from_numpy(env["x_u8"])
    f32 = (u8.float() / 255.0 - 0.5) / 0.5
    with torch.inference_mode():
        np.testing.assert_allclose(model(u8).numpy(), model(f32).numpy(),
                                   rtol=1e-5, atol=1e-6)
