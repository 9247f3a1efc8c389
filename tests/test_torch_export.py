"""The port's serving export (vit_ed_tpu_torch/serve/export.py, scan.py,
export_serving.py) against the JAX package's (tests/test_export.py) on the
CPU: JAX params made from a seed are carried across with
``jax_params_to_state_dict``, the JAX side runs its attention through XLA
(``use_pallas=False``, as its own serve tests do), the port's replayed
graphs run the registered operators' plain versions.

Tolerances: f32 stage outputs within 1e-5 of the JAX ``stage_fns`` (the
JAX tests' bound); ``pair_u8`` against host-normalised ``pair`` rtol 1e-4,
atol 1e-5 (tests/test_export.py:248-260); ``scan_pairs`` float16 matrices
within 2e-2 of ``score_dataset``'s and of the JAX ``scan_pairs``'s.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.export.passes

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.serve import export_scorer as jax_export_scorer
from vit_ed_tpu.serve import load_scorer as jax_load_scorer
from vit_ed_tpu.serve import scan_pairs as jax_scan_pairs
from vit_ed_tpu.serve import stage_fns as jax_stage_fns
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.ops import attention as A
from vit_ed_tpu_torch.serve import (STAGES, export_scorer, load_scorer, scan_pairs,
                                    stage_fns)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# head_dim 64, C % 128 == 0: the pair route; the 4-D route below at d = 32
KW = dict(img_size=32, patch_size=16, num_classes=4, embed_dim=128, depth=1,
          c_depth=2, num_heads=2)


def _jax_model(**kw):
    jm = JaxViTED(**{**KW, **kw}, use_pallas=False)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 2, 32, 32, 3)))["params"])
    return jm, params


def _port(params, **kw):
    return load_jax_params(ViTED(**{**KW, **kw}), params).eval()


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The JAX model and params, the port's model on them and its symbolic
    bundle of every stage."""
    jm, params = _jax_model()
    model = _port(params)
    out = tmp_path_factory.mktemp("bundle")
    meta = export_scorer(model, None, str(out), device="cpu")
    return jm, params, model, out, meta


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def test_symbolic_bundle_roundtrip(tiny):
    jm, params, _, out, meta = tiny
    assert meta["batch_mode"] == "symbolic" and meta["format_version"] == 1
    assert set(meta["stages"]) == set(STAGES)
    assert meta["stages"]["pair"][0]["device"] == "cpu"
    assert meta["stages"]["pair"][0]["inputs"] == [["b", "2", "32", "32", "3", "float32"]]
    scorer = load_scorer(str(out), device="cpu")
    fns = jax_stage_fns(jm)
    rng = np.random.default_rng(0)
    # one artifact serves every batch size
    for b in (1, 3, 8):
        x = rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32)
        got = scorer("pair", x)
        assert got.shape == (b, 4) and got.device.type == "cpu"
        np.testing.assert_allclose(_np(got), _np(fns["pair"](params, jnp.asarray(x))),
                                   atol=1e-5, rtol=0)
    # the staged pipeline == the JAX staged calls (the scan schedule)
    x1 = rng.normal(size=(1, 32, 32, 3)).astype(np.float32)
    x2 = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
    kv = scorer("kv", scorer("encode", x1))
    assert kv.shape == (2, 1, 4, 256)
    got = scorer("score_row", kv, scorer("prepare", x2))
    live = fns["score_row"](params, fns["kv"](params, fns["encode"](params, x1)),
                            fns["prepare"](params, x2))
    np.testing.assert_allclose(_np(got), _np(live), atol=1e-5, rtol=0)
    assert got.shape == (3, 4)


def test_bundle_stores_the_weights_once(tiny):
    """weights.pt holds the float32 weights; no artifact holds a copy (no
    state, no example inputs; its constants are the GELU's scalars)."""
    _, _, model, out, meta = tiny
    weights = torch.load(out / "weights.pt", weights_only=True)
    assert set(weights) == set(model.state_dict())
    assert all(v.dtype == torch.float32 for v in weights.values())
    n_bytes = sum(v.numel() * 4 for v in weights.values())
    for stage, (entry,) in meta["stages"].items():
        ep = torch.export.load(str(out / entry["file"]))
        assert not ep.state_dict and ep.example_inputs is None, stage
        assert sum(c.numel() for c in ep.constants.values()) < 16, stage
        assert os.path.getsize(out / entry["file"]) < n_bytes / 4, stage


def _attention_calls(fn, *args):
    """The wrapper calls (layouts) one live forward makes."""
    calls = []
    inner = A._attend

    def counting(layout, *a, **kw):
        calls.append(layout)
        return inner(layout, *a, **kw)

    A._attend = counting
    try:
        with torch.no_grad():
            fn(*args)
    finally:
        A._attend = inner
    return calls


@pytest.mark.parametrize("route", ["pair", "heads"])
def test_every_stage_graph_holds_the_registered_attention(tiny, tmp_path, route):
    """Every exported stage calls ``torch.ops.vit_ed.<route>_forward`` once per
    attention call of the live forward, with its layout, and holds no plain
    attention (no exp2, clamp or softmax): a bundle replayed on the card
    launches the kernels, never a plain version baked in at export."""
    _, params, model, out, meta = tiny
    if route == "heads":                  # head_dim 32: the 4-D route
        _, params = _jax_model(embed_dim=64)
        model = _port(params, embed_dim=64)
        out = tmp_path
        meta = export_scorer(model, None, str(out), device="cpu")
    target = getattr(torch.ops.vit_ed, f"{route}_forward").default
    fns = stage_fns(model)
    weights = model.state_dict()
    rng = np.random.default_rng(1)
    x_pair = torch.from_numpy(rng.normal(size=(2, 2, 32, 32, 3)).astype(np.float32))
    x_one = x_pair[:, 0]
    feats = fns["encode"](weights, x_one)
    inputs = {"pair": (x_pair,), "pair_u8": (x_pair.clamp(0, 1).mul(255).to(torch.uint8),),
              "encode": (x_one,), "prepare": (x_one,), "kv": (feats,),
              "score_row": (fns["kv"](weights, feats[:1]), fns["prepare"](weights, x_one))}
    for stage, (entry,) in meta["stages"].items():
        graph = torch.export.load(str(out / entry["file"])).graph
        targets = [n.target for n in graph.nodes if n.op == "call_function"]
        layouts = [n.args[1] for n in graph.nodes if n.target == target]
        want = _attention_calls(fns[stage], weights, *inputs[stage])
        assert layouts == want, (stage, layouts, want)
        names = {str(t) for t in targets}
        assert not any(op in name for name in names
                       for op in ("exp2", "clamp", "softmax")), (stage, names)
    assert want == ["kv_shared", "qkv_cls", "kv_shared"]     # score_row, c_depth 2


def test_bucketed_bundle_dispatch(tiny, tmp_path):
    jm, params, model, _, _ = tiny
    meta = export_scorer(model, None, str(tmp_path), batch_sizes=[4, 2, 2],
                         stages=("pair",), device="cpu")
    assert meta["batch_mode"] == [2, 4]
    assert [e["file"] for e in meta["stages"]["pair"]] == ["pair_b2.pt2", "pair_b4.pt2"]
    assert meta["stages"]["pair"][0]["inputs"] == [["2", "2", "32", "32", "3", "float32"]]
    scorer = load_scorer(str(tmp_path), device="cpu")
    assert [scorer.servable_batch(b) for b in (1, 2, 3, 4)] == [2, 2, 4, 4]
    with pytest.raises(ValueError, match="exceeds largest bucket 4"):
        scorer.servable_batch(5)
    fns = jax_stage_fns(jm)
    rng = np.random.default_rng(1)
    for b in (2, 4):
        x = rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(scorer("pair", x)),
                                   _np(fns["pair"](params, jnp.asarray(x))), atol=1e-5)
    with pytest.raises(ValueError, match="no pair artifact for batch 3"):
        scorer("pair", np.zeros((3, 2, 32, 32, 3), np.float32))
    with pytest.raises(ValueError, match="non-empty"):
        export_scorer(model, None, str(tmp_path), batch_sizes=[], stages=("pair",),
                      device="cpu")


def test_format_version_guard_and_unported_switches(tiny, tmp_path):
    _, _, model, out, _ = tiny
    export_scorer(model, None, str(tmp_path), stages=("pair",), device="cpu")
    meta_path = tmp_path / "serving_meta.json"
    meta = json.loads(meta_path.read_text())
    meta["format_version"] = 99
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="newer than this loader"):
        load_scorer(str(tmp_path), device="cpu")
    # multi-chip bundles (the JAX mesh=) wait for several cards
    with pytest.raises(NotImplementedError, match="item 12b"):
        export_scorer(model, None, str(tmp_path), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12b"):
        load_scorer(str(out), device="cpu", mesh=object())


def test_bundle_from_another_device_is_moved_or_refused(tiny, tmp_path, monkeypatch):
    """A bundle recorded as exported on another device is moved to the
    scorer's with move_to_device_pass, or refused where torch lacks it; it
    never replays quietly where the caller did not ask."""
    _, _, model, _, _ = tiny
    export_scorer(model, None, str(tmp_path), stages=("pair",), device="cpu")
    meta_path = tmp_path / "serving_meta.json"
    meta = json.loads(meta_path.read_text())
    meta["stages"]["pair"][0]["device"] = "cuda"
    meta_path.write_text(json.dumps(meta))
    moved = []
    real = torch.export.passes.move_to_device_pass

    def spy(ep, location):
        moved.append(str(location))
        return real(ep, location)

    monkeypatch.setattr(torch.export.passes, "move_to_device_pass", spy)
    scorer = load_scorer(str(tmp_path), device="cpu")
    assert moved == ["cpu"]
    assert scorer("pair", np.zeros((1, 2, 32, 32, 3), np.float32)).device.type == "cpu"
    monkeypatch.delattr(torch.export.passes, "move_to_device_pass")
    with pytest.raises(ValueError, match="exported on cuda"):
        load_scorer(str(tmp_path), device="cpu")


def test_pair_u8_stage_matches_host_normalize(tiny):
    _, _, _, out, _ = tiny
    scorer = load_scorer(str(out), device="cpu")
    x_u8 = np.random.default_rng(0).integers(0, 256, (3, 2, 32, 32, 3), np.uint8)
    x_f32 = (x_u8.astype(np.float32) / 255.0 - 0.5) / 0.5
    np.testing.assert_allclose(_np(scorer("pair_u8", x_u8)), _np(scorer("pair", x_f32)),
                               rtol=1e-4, atol=1e-5)


def test_scan_pairs_matches_scorer_and_jax(tiny, tmp_path):
    """The headless bundle scan reproduces the port's
    PairwiseScorer.score_dataset matrix and the JAX scan_pairs on the JAX
    bundle of the same params; an empty image set gives (0, 0)."""
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    class ArrayDataset:
        def __init__(self, imgs):
            self.imgs = imgs

        def __getitem__(self, i):
            return self.imgs[i], i

        def __len__(self):
            return len(self.imgs)

    jm, params, model, out, _ = tiny
    imgs = np.random.default_rng(4).normal(size=(7, 32, 32, 3)).astype(np.float32)
    ref = PairwiseScorer(model, num_outputs=4, pair_chunk=8).score_dataset(
        ArrayDataset(imgs), batch_size=3, num_workers=0)
    scorer = load_scorer(str(out), device="cpu")
    got = scan_pairs(scorer, imgs, batch_size=3)
    assert got.shape == (7, 7, 4) and got.dtype == np.float16
    np.testing.assert_allclose(got.astype(np.float32), ref.astype(np.float32), atol=2e-2)
    jax_export_scorer(jm, params, str(tmp_path))
    jax_got = jax_scan_pairs(jax_load_scorer(str(tmp_path)), imgs, batch_size=3)
    np.testing.assert_allclose(got.astype(np.float32), jax_got.astype(np.float32),
                               atol=2e-2)
    assert scan_pairs(scorer, imgs[:0], batch_size=3).shape == (0, 0)


def test_moe_bundle_roundtrip(tmp_path):
    """Expert banks export and replay like dense blocks (static capacity,
    no ragged shapes): the symbolic artifact serves any batch."""
    jm = JaxViTED(img_size=32, patch_size=16, num_classes=4, embed_dim=128, depth=2,
                  c_depth=1, num_heads=2, use_pallas=False, moe_experts=2,
                  moe_interval=1, moe_capacity=1.5)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 2, 32, 32, 3)))["params"])
    model = load_jax_params(ViTED(img_size=32, patch_size=16, num_classes=4,
                                  embed_dim=128, depth=2, c_depth=1, num_heads=2,
                                  moe_experts=2, moe_interval=1, moe_capacity=1.5),
                            params).eval()
    assert set(jax_params_to_state_dict(params)) == set(model.state_dict())
    export_scorer(model, None, str(tmp_path), stages=("pair",), device="cpu")
    scorer = load_scorer(str(tmp_path), device="cpu")
    fns = jax_stage_fns(jm)
    rng = np.random.default_rng(5)
    for b in (2, 5):
        x = rng.normal(size=(b, 2, 32, 32, 3)).astype(np.float32)
        np.testing.assert_allclose(_np(scorer("pair", x)),
                                   _np(fns["pair"](params, jnp.asarray(x))), atol=1e-5)


def test_int8_bundle_replays_the_int8_route(tiny, tmp_path):
    """TPU.INT8_SCORE bundles quantize the same float32 weights inside the
    graph: the replay equals the live model under ops.quant.int8_gemms."""
    from vit_ed_tpu_torch.ops.quant import int8_gemms

    _, _, model, _, _ = tiny
    export_scorer(model, None, str(tmp_path), stages=("pair", "score_row"),
                  device="cpu", int8=True)
    scorer = load_scorer(str(tmp_path), device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(3, 2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad(), int8_gemms(model):
        live = model(x)
    with torch.no_grad():
        dense = model(x)
    torch.testing.assert_close(scorer("pair", x), live, atol=1e-6, rtol=0)
    assert (live - dense).abs().max() > 0                 # the route is really int8


def test_export_cli_verifies(tmp_path):
    """python -m vit_ed_tpu_torch.export_serving end to end on the CPU, with
    --verify replaying the pair stage against the live model, in bf16 (the
    config's AMP); --platforms tpu and --mesh-data are refused."""
    from vit_ed_tpu_torch.export_serving import main

    argv = ["--cfg", os.path.join(ROOT, "configs", "hisfrag", "hisfrag20_patch16_512.yaml"),
            "--output", str(tmp_path / "bundle"), "--verify", "--device", "cpu",
            "--opts", "MODEL.PJS.EMBED_DIM", "128", "MODEL.PJS.NUM_HEADS", "2",
            "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32"]
    meta = main(argv)
    assert meta["model"]["dtype"] == "bfloat16" and meta["int8_score"] is False
    scorer = load_scorer(str(tmp_path / "bundle"), device="cpu")
    assert set(scorer.stages()) == set(STAGES)
    assert meta["stages"]["encode"][0]["outputs"] == [["b", "4", "128"]]
    assert meta["stages"]["kv"][0]["inputs"] == [["b", "4", "128", "bfloat16"]]
    with pytest.raises(NotImplementedError, match="TPU"):
        main(argv[:4] + ["--platforms", "tpu"])
    with pytest.raises(NotImplementedError, match="item 12b"):
        main(argv[:4] + ["--mesh-data", "2"])
