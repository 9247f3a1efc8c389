"""The port's explainability against the JAX package: ``keep_attn`` maps and
logits (tests/test_keep_attn.py), ``ops/explain.py``'s probe forward,
attention gradients, rollout and Chefer relevance
(``vit_ed_tpu/ops/explain.py``), and the two script entries
``python -m vit_ed_tpu_torch.visualise_attentions`` and
``.visualise_dataset`` against ``scripts/visualise_*.py``; all in float32
on the CPU, on the same params and seeded inputs."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import importlib.util
import logging
import random
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.ops import explain as jax_explain
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.ops import explain

ROOT = Path(__file__).resolve().parent.parent
D, HEADS, DEPTH, CDEPTH, PATCH, IMG, NCLS = 32, 2, 1, 2, 16, 32, 4
KW = dict(img_size=IMG, patch_size=PATCH, num_classes=NCLS, embed_dim=D,
          depth=DEPTH, c_depth=CDEPTH, num_heads=HEADS)
N1 = (IMG // PATCH) ** 2


@pytest.fixture(scope="module")
def setup():
    jm = JaxViTED(**KW, use_pallas=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, IMG, IMG, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    x_pair = np.random.default_rng(0).normal(size=(2, 2, IMG, IMG, 3)).astype(np.float32)
    return jm, params, jax_params_to_state_dict(params), x_pair


def _rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_keep_attn_maps_and_logits_match_jax(setup):
    jm, params, _sd, x_pair = setup
    ref, state = jm.clone(keep_attn=True).apply(
        {"params": params}, jnp.asarray(x_pair), mutable=["intermediates"])
    inter = state["intermediates"]
    model = load_jax_params(ViTED(**KW, keep_attn=True), params).eval()
    fused = load_jax_params(ViTED(**KW), params).eval()
    x = torch.from_numpy(x_pair)
    with torch.no_grad():
        out = model(x)
        maps = model.attention_maps()
        fused_out = fused(x)
    assert not model._cls_last and fused._cls_last
    # f32 logits: the explicit path against JAX's, and against the fused one
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), fused_out.numpy(), atol=1e-5, rtol=0)
    want = {f"blocks.{i}.attn": inter[f"blocks_{i}"]["attn"]["attn"][0] for i in range(DEPTH)}
    for i in range(CDEPTH):
        blk = inter[f"cross_blocks_{i}"]
        want[f"cross_blocks.{i}.attn"] = blk["attn"]["attn"][0]
        want[f"cross_blocks.{i}.cross_attn"] = blk["cross_attn"]["attn"][0]
    assert sorted(maps) == sorted(want)
    assert maps["blocks.0.attn"].shape == (2, HEADS, N1, N1)
    assert maps["cross_blocks.0.cross_attn"].shape == (2, HEADS, N1 + 1, N1)
    for name, m in maps.items():
        assert m.dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), np.asarray(want[name]), atol=1e-6, rtol=0)
        np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, atol=1e-5)


def test_keep_attn_scan_equals_its_pair_forward(setup):
    """The scan decomposition under keep_attn (no CLS short-circuit, the
    shared-kv cross-attention on the broadcast) gives the pair forward's
    logits, and keeps the last decoder block's full maps."""
    _jm, params, _sd, x_pair = setup
    model = load_jax_params(ViTED(**KW, keep_attn=True), params).eval()
    x = torch.from_numpy(x_pair)
    with torch.no_grad():
        direct = model(x)
        feats = model.encode(x[:1, 0])
        kv = model.context_kv_cache(feats)
        row = model.score_tokens_row(kv, model.prepare_x2_scan(x[:, 1]))
        full = model.score_tokens(feats.expand(2, -1, -1), model.prepare_x2(x[:, 1]))
    np.testing.assert_allclose(row.numpy()[:1], direct.numpy()[:1], atol=1e-5, rtol=0)
    np.testing.assert_allclose(full.numpy()[:1], direct.numpy()[:1], atol=1e-5, rtol=0)
    assert model.cross_blocks[-1].attn.attn_map.shape == (2, HEADS, N1 + 1, N1 + 1)


def test_probe_forward_matches_jax_and_the_model(setup):
    jm, params, sd, x_pair = setup
    b = x_pair.shape[0]

    def probes(zeros):
        return {"enc": [zeros((b, HEADS, N1, N1)) for _ in range(DEPTH)],
                "dec_self": [zeros((b, HEADS, N1 + 1, N1 + 1)) for _ in range(CDEPTH)],
                "dec_cross": [zeros((b, HEADS, N1 + 1, N1)) for _ in range(CDEPTH)]}

    ref, ref_attns = jax_explain.forward_with_probes(
        params, jnp.asarray(x_pair), probes(jnp.zeros), PATCH, HEADS, DEPTH, CDEPTH)
    got, attns = explain.forward_with_probes(
        explain.state_dict_on(sd), torch.from_numpy(x_pair), probes(torch.zeros),
        PATCH, HEADS, DEPTH, CDEPTH)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for key in ref_attns:
        for a, r in zip(attns[key], ref_attns[key]):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    with torch.no_grad():   # the port's own model, fused attention
        model_out = load_jax_params(ViTED(**KW), params).eval()(torch.from_numpy(x_pair))
    np.testing.assert_allclose(got.numpy(), model_out.numpy(), atol=1e-5, rtol=0)


def test_attention_gradients_and_relevance_match_jax(setup):
    """f32 on both sides: the maps within 1e-6, the gradients and the
    relevance within 1e-4 of their max (different summation orders)."""
    jm, params, sd, x_pair = setup
    ref_attns, ref_grads, ref_value = jax_explain.attention_maps_and_gradients(
        params, x_pair, PATCH, HEADS, DEPTH, CDEPTH, target_index=1)
    model = load_jax_params(ViTED(**KW), params)
    attns, grads, value = explain.attention_maps_and_gradients(
        model, x_pair, PATCH, HEADS, DEPTH, CDEPTH, target_index=1, device="cpu")
    np.testing.assert_allclose(value, ref_value, rtol=1e-5)
    for key in ("enc", "dec_self", "dec_cross"):
        for a, r in zip(attns[key], ref_attns[key]):
            np.testing.assert_allclose(a, np.asarray(r), atol=1e-6, rtol=0)
        for g, r in zip(grads[key], ref_grads[key]):
            assert _rel(g, r) < 1e-4
    assert np.abs(grads["dec_cross"][0]).max() > 0

    # the relevance of both rule variants: the JAX pipeline's rules on the
    # maps and gradients it computed above (its eager autodiff is slow)
    cached = (ref_attns, ref_grads, ref_value)
    for kw in ({}, {"normalize_self_attention": False, "apply_self_in_rule_10": False}):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_explain, "attention_maps_and_gradients", lambda *a: cached)
            ref = jax_explain.generate_relevance(params, x_pair, PATCH, HEADS, DEPTH,
                                                 CDEPTH, target_index=1, **kw)
        got = explain.generate_relevance(sd, x_pair, PATCH, HEADS, DEPTH, CDEPTH,
                                         target_index=1, **kw)
        assert got.shape == ref.shape == (N1, N1)
        assert _rel(got, ref) < 1e-4


def test_rollout_and_rules_equal_jax():
    rng = np.random.default_rng(2)
    mats = [rng.random((6, 6)) for _ in range(3)]
    np.testing.assert_array_equal(explain.compute_rollout_attention(mats, 1),
                                  jax_explain.compute_rollout_attention(mats, 1))
    cam, grad = rng.normal(size=(1, 2, 6, 5)), rng.normal(size=(1, 2, 6, 5))
    np.testing.assert_array_equal(explain.avg_heads(cam, grad),
                                  jax_explain.avg_heads(cam, grad))
    r_ss, r_qq, cam_sq = rng.random((6, 6)), rng.random((5, 5)), rng.random((6, 5))
    for kw in ({}, {"apply_normalization": False, "apply_self_in_rule_10": False}):
        np.testing.assert_array_equal(
            explain.apply_mm_attention_rules(r_ss, r_qq, cam_sq.copy(), **kw),
            jax_explain.apply_mm_attention_rules(r_ss, r_qq, cam_sq.copy(), **kw))


# ---------------------------------------------------------------- entries
def _script(name):
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape,size", [((4, 4, 3), 32), ((2, 2, 3), 64),
                                        ((32, 32, 3), 512), ((32, 32, 3), 32)])
def test_resize_linear_equals_opencv(shape, size):
    """OpenCV's bilinear taps and weights exactly; its float arithmetic
    (vectorised, in an order that is not reproduced) to within 2 ulp of
    the [0, 1) values; the same size is an exact copy."""
    import cv2

    from vit_ed_tpu_torch.visualise_attentions import resize_linear

    rng = np.random.default_rng(size)
    mask = rng.random(shape).astype(np.float32)
    np.testing.assert_allclose(resize_linear(mask, size), cv2.resize(mask, (size, size)),
                               atol=2 ** -22, rtol=0)
    img = rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
    np.testing.assert_array_equal(resize_linear(img, size), cv2.resize(img, (size, size)))


def test_visualise_attentions_writes_the_jax_scripts_images(setup, tmp_path):
    from vit_ed_tpu_torch import visualise_attentions as port
    from vit_ed_tpu_torch.utils.logger import create_logger

    _jm, _params, sd, _x = setup
    pth = tmp_path / "w.pth"
    torch.save({"model": {k: v.clone() for k, v in sd.items()}}, pth)
    rng = np.random.default_rng(4)
    paths = []
    for i, shape in enumerate(((40, 50), (36, 36))):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8)).save(paths[-1])
    opts = ["MODEL.PJS.EMBED_DIM", str(D), "MODEL.PJS.NUM_HEADS", str(HEADS),
            "MODEL.PJS.DEPTH", str(DEPTH), "MODEL.PJS.C_DEPTH", str(CDEPTH),
            "MODEL.PJS.PATCH_SIZE", str(PATCH), "DATA.IMG_SIZE", str(IMG),
            "MODEL.NUM_CLASSES", str(NCLS)]
    cfg = str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml")
    x_pair = np.stack([port.T.normalize(port.T.to_tensor(port.T.center_crop(
        Image.open(p).convert("RGB"), IMG))) for p in paths])[None]
    # a threshold inside the relevance's range, so that colours land
    threshold = float(np.quantile(explain.generate_relevance(
        sd, x_pair, PATCH, HEADS, DEPTH, CDEPTH), 0.6))
    args, config = port.parse_option(
        ["--cfg", cfg, "--pretrained", str(pth), "--images", *paths, "--output_dir",
         str(tmp_path / "port"), "--threshold", str(threshold), "--device", "cpu",
         "--tag", "vis", "--opts", *opts])
    assert config.MODEL.PJS.KEEP_ATTN
    random.seed(7)
    cam = port.main(args, config, create_logger(None, name="port_vis"))

    from vit_ed_tpu.config import get_config as jax_get_config

    jax_script = _script("visualise_attentions")
    jax_args = types.SimpleNamespace(**{**vars(args), "output_dir": str(tmp_path / "jax"),
                                        "keep_attn": True})
    del jax_args.device
    # the JAX script on the same relevance (held to the JAX pipeline's in
    # test_attention_gradients_and_relevance_match_jax; its eager autodiff
    # is slow), after checking what it would be given
    seen = {}

    def relevance(params, x, **kw):
        seen["args"] = (x, kw)
        return cam

    random.seed(7)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_script, "generate_relevance", relevance)
        jax_script.main(jax_args, jax_get_config(jax_args), logging.getLogger("jax_vis"))
    np.testing.assert_array_equal(seen["args"][0], x_pair)
    assert seen["args"][1] == dict(patch=PATCH, heads=HEADS, depth=DEPTH, c_depth=CDEPTH,
                                   target_index=0)
    assert (cam > threshold).any() and not (cam > threshold).all()
    # the overlays: the same colours on the same patches; the pixels to
    # within one grey level (resize_linear is OpenCV's to 2 ulp, and the
    # images truncate 255 x their values to uint8)
    for name in ("attn_x1.png", "attn_x2.png"):
        ours = np.asarray(Image.open(tmp_path / "port" / name)).astype(int)
        ref = np.asarray(Image.open(tmp_path / "jax" / name)).astype(int)
        assert ours.shape == ref.shape == (IMG, IMG, 3)
        assert np.abs(ours - ref).max() <= 1


def test_visualise_dataset_writes_the_jax_scripts_samples(tmp_path):
    from test_torch_michigan import write_michigan
    from vit_ed_tpu_torch import visualise_dataset as port

    data = str(tmp_path / "mich")
    write_michigan(data)
    jax_script = _script("visualise_dataset")
    random.seed(3)
    jax_script.main(jax_script.parser.parse_args(
        ["--data-path", data, "--output-path", str(tmp_path / "jax"), "--n-samples", "4"]))
    random.seed(3)
    paths = port.main(["--data-path", data, "--output-path", str(tmp_path / "port"),
                       "--n-samples", "4"])
    assert len(paths) == 4
    for p in paths:
        name = Path(p).name
        ours, ref = np.asarray(Image.open(p)), np.asarray(Image.open(tmp_path / "jax" / name))
        assert ours.shape == ref.shape == (512, 512, 3)
        np.testing.assert_array_equal(ours, ref)
