"""The port's Michigan / Geshaem slice against the JAX package on the CPU:
the datasets on the same synthetic trees, ``calc_map_prak``,
``OneImgEvalZoom``, the loader's multi-image branch, the Michigan pair
mining, loss and train transform, ``geshaem_test``'s metrics and
``eval_standard``'s distance matrix; then one CPU drive of each new entry
(``python -m vit_ed_tpu_torch.michigan --mode train|eval|test|throughput``,
``python -m vit_ed_tpu_torch.geshame_evaluation``)."""

import logging
import os
import random
import types
from pathlib import Path

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
CFG = str(ROOT / "configs" / "michigan" / "michigan_patch16_384.yaml")
SHRINK = ["MODEL.PJS.EMBED_DIM", "32", "MODEL.PJS.NUM_HEADS", "2",
          "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1",
          "DATA.IMG_SIZE", "32", "DATA.NUM_WORKERS", "2", "PRINT_FREQ", "2"]


def _jpeg(path, h, w, rng):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    base = rng.integers(0, 255, size=(3,))
    arr = np.clip(base + rng.integers(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path, quality=90)


def write_michigan(root, n_papyri=14, per=3, seed=0):
    """``<papyrus>/<side>/<kind>/<folder>/<medium>/x/<file>.jpg``: papyri 2
    and 3 share a folder (one group), papyrus 5 has summary scans only,
    papyrus 6 a summary scan beside its detail ones, papyrus 7 one detail
    scan; back sides and another medium are there to be skipped."""
    rng = np.random.default_rng(seed)
    for p in range(n_papyri):
        name = f"P{p:03d}"
        folder = "P002sub" if p == 3 else f"{name}sub"
        kind = "summary" if p == 5 else "detail"
        for f in range(1 if p == 7 else per):
            _jpeg(os.path.join(root, name, "front", kind, folder, "papyrus", "x",
                               f"{f}.jpg"), 70 + 3 * f, 90, rng)
        _jpeg(os.path.join(root, name, "back", "detail", folder, "papyrus", "x",
                           "b.jpg"), 70, 90, rng)
        _jpeg(os.path.join(root, name, "front", "detail", folder, "other", "x",
                           "o.jpg"), 70, 90, rng)
        if p == 6:
            _jpeg(os.path.join(root, name, "front", "summary", folder, "papyrus",
                               "x", "s.jpg"), 70, 90, rng)


GESHAEM = {"A_r_c1": 2, "B_r_c1": 1, "A_B_r_c1": 1, "C_r_c2": 1, "D_r_c1": 1,
           "C_D_r_c1": 1, "E_r_c1": 1, "F_v_c1": 1, "G_r_c1": 1}


def write_geshaem(root, seed=1, layout=("papyrus", "x")):
    """``<fragment>_<r|v>_<column>/papyrus/<x>/<file>.jpg``: A + B and C + D
    are grouped by the assembled A_B and C_D; E has no group; F is a verso;
    G's one image is under the size limit."""
    rng = np.random.default_rng(seed)
    for name, n in GESHAEM.items():
        for i in range(n):
            size = (60, 60) if name.startswith("G") else (120 + 5 * i, 130)
            _jpeg(os.path.join(root, name, *layout, f"im{i}.jpg"), *size, rng)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("michigan_torch")
    mich, gesh = str(tmp / "michigan"), str(tmp / "geshaem")
    write_michigan(mich)
    write_geshaem(gesh)
    return tmp, mich, gesh


# ------------------------------------------------------------------ datasets
def test_michigan_datasets_match_jax(trees):
    from vit_ed_tpu.data import michigan as J
    from vit_ed_tpu_torch.data import michigan as P

    _tmp, mich, _gesh = trees
    ident = lambda im: np.asarray(im, np.uint8)   # noqa: E731
    for split in ("train", "validation", "all"):
        for n_val in (None, 2, 0):
            ref = J.MichiganDataset(mich, J.Split.from_string(split), ident,
                                    val_n_items_per_writer=n_val)
            ours = P.MichiganDataset(mich, P.Split.from_string(split), ident,
                                     val_n_items_per_writer=n_val)
            assert ours.data == ref.data and ours.data_labels == ref.data_labels
            assert ours.image_names == ref.image_names
            assert ours.fragment_to_group_id == ref.fragment_to_group_id
            assert ours.fragment_to_group == ref.fragment_to_group
            assert ours.groups == ref.groups
    train = P.MichiganDataset(mich, P.Split.TRAIN, ident)
    assert len(set(train.data_labels)) < len(train.image_names)   # P002 + P003
    assert not any("summary" in p for p in train.data if "P006" in p)
    assert any("summary" in p for p in train.data if "P005" in p)
    ref = J.MichiganTest(mich, J.Split.VAL, ident, lower_bound=1)
    ours = P.MichiganTest(mich, P.Split.VAL, ident, lower_bound=1)
    assert len(ours) == len(ref) and ours.data == ref.data
    for i in range(len(ours)):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a[0], b[0])
        assert int(a[1]) == int(b[1]) == i + 1
        np.testing.assert_array_equal(ours.raw_image(i), ref.raw_image(i))
        assert ours.item_meta(i)[0] == ref.item_meta(i)[0]


def test_geshaem_datasets_match_jax(trees, tmp_path):
    from vit_ed_tpu.data import geshaem as J
    from vit_ed_tpu_torch.data import geshaem as P

    _tmp, _mich, gesh = trees
    for name in ("G123_r_col1", "G1_G2_v_col2", "A_r_c1 x", "###"):
        try:
            ref = J.parse_name(name)
        except ValueError:
            with pytest.raises(ValueError):
                P.parse_name(name)
        else:
            assert P.parse_name(name) == ref
    cases = [(s, verso) for s in ("validation", "train", "test") for verso in (False, True)]
    for split, verso in cases:
        ref = J.GeshaemPatch(gesh, J.Split.from_string(split), include_verso=verso)
        ours = P.GeshaemPatch(gesh, P.Split.from_string(split), include_verso=verso)
        assert ours.fragments == ref.fragments and ours.data == ref.data
        assert ours.data_labels == ref.data_labels
        assert ours.fragment_to_group == ref.fragment_to_group
        assert ours.fragment_to_group_id == ref.fragment_to_group_id
        np.testing.assert_array_equal(ours.pairs, ref.pairs)
    val = P.GeshaemPatch(gesh, P.Split.VAL)
    assert val.fragment_to_group["A"] == {"A", "B", "A_B"}
    assert "E" not in val.fragment_to_group and "F" not in val.fragments
    assert "A_B" not in P.GeshaemPatch(gesh, P.Split.TRAIN).fragments
    for i in (0, 5, len(val) - 1):
        a, b = val[i], J.GeshaemPatch(gesh, J.Split.VAL)[i]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert [x.shape for x in val.raw_images(i)] == [x.shape[1:] for x in [a[0]] * 2]
        np.testing.assert_array_equal(val.item_meta(i)[0], a[1])
    merged = P.MergeDataset([val, val], transform=lambda im: np.asarray(im, np.float32))
    ref_merged = J.MergeDataset([J.GeshaemPatch(gesh, J.Split.VAL)] * 2,
                                transform=lambda im: np.asarray(im, np.float32))
    assert merged.data == ref_merged.data and merged.data_labels == ref_merged.data_labels
    np.testing.assert_array_equal(merged[3][0], ref_merged[3][0])
    # extract_relations reads the folder two levels above each file
    flat = str(tmp_path / "flat")
    write_geshaem(flat, layout=("x",))
    assert P.extract_relations(flat) == J.extract_relations(flat)


# ------------------------------------------------------------------- metrics
def test_calc_map_prak_matches_jax():
    from vit_ed_tpu.metrics import calc_map_prak as jax_calc
    from vit_ed_tpu_torch.metrics import calc_map_prak

    rng = np.random.default_rng(0)
    labels = [f"f{i % 7}" for i in range(20)]
    groups = {f"f{i}": {f"f{i}", f"f{(i + 1) % 7}"} for i in range(7)}
    negatives = {f"f{i}": {f"f{(i + 3) % 7}"} for i in range(7)}
    for trial in range(4):
        d = rng.random((20, 20))
        if trial % 2:
            d[rng.random((20, 20)) < 0.2] = np.nan    # pairs never scored
            d = np.round(d, 1)                         # ties
        np.fill_diagonal(d, 0.0)
        for neg in (None, negatives):
            ours = calc_map_prak(d, labels, groups, neg, prak=(1, 5, 10))
            assert ours == jax_calc(d, labels, groups, neg, prak=(1, 5, 10))
    # every item alone in its group: each query ranks itself first and
    # retrieves no positive after it
    lonely = {f"f{i}": {f"f{i}"} for i in range(7)}
    d = 1.0 - np.eye(7)
    with pytest.raises(ValueError, match="no query retrieved"):
        calc_map_prak(d, [f"f{i}" for i in range(7)], lonely)
    with pytest.raises(ValueError, match="no query retrieved"):
        jax_calc(d, [f"f{i}" for i in range(7)], lonely)


# ---------------------------------------------------------------- transforms
def test_one_img_eval_zoom_pooled_equals_call_and_jax():
    """Equality (bit for bit) of the pooled batch, ``__call__``, the plain
    chain and the JAX transform; short images take the padding path."""
    from vit_ed_tpu.data import transforms as JT
    from vit_ed_tpu_torch.data import transforms as TT
    from vit_ed_tpu_torch.data.loader import pool_batch
    from vit_ed_tpu_torch.native.pipeline import PipelinePool

    rng = np.random.default_rng(2)
    shapes = [(90, 110), (64, 64), (77, 65), (40, 90)]
    raws = [rng.integers(0, 255, s + (3,), dtype=np.uint8) for s in shapes]
    t, ref_t = TT.OneImgEvalZoom(64), JT.OneImgEvalZoom(64)
    outs = [t(Image.fromarray(a)) for a in raws]
    for a, out in zip(raws, outs):
        np.testing.assert_array_equal(out, ref_t(Image.fromarray(a)))
        assert out.shape == (64, 64, 3) and out.dtype == np.float32
    assert t.pool_crop((40, 90)) is None and t.pool_crop((90, 110)) == ref_t.pool_crop((90, 110))
    saved = TT._native_ok
    TT._native_ok = lambda x: False
    try:
        plain = [t(Image.fromarray(a)) for a in raws]
    finally:
        TT._native_ok = saved
    for a, b in zip(outs, plain):
        np.testing.assert_array_equal(a, b)
    with PipelinePool(2) as pool:
        np.testing.assert_array_equal(pool_batch(pool, t, raws[:3]), np.stack(outs[:3]))
        np.testing.assert_array_equal(pool_batch(pool, t, raws), np.stack(outs))
    u8 = TT.OneImgEvalZoom(64, emit_u8=True)
    assert u8.pool_crop((90, 110)) is None
    for a in raws:
        got = u8(Image.fromarray(a))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, JT.OneImgEvalZoom(64, emit_u8=True)(Image.fromarray(a)))


def test_loader_multi_image_branch_equals_per_item(trees):
    """GeshaemPatch's stacked pairs: the pooled multi-image batches equal
    the per-item ``__getitem__`` batches bit for bit; a batch with items of
    different image counts is made item by item."""
    from vit_ed_tpu_torch.data import transforms as TT
    from vit_ed_tpu_torch.data.geshaem import GeshaemPatch
    from vit_ed_tpu_torch.data.loader import DataLoader, pools_batches

    _tmp, _mich, gesh = trees
    for transform in (TT.OneImgEvalZoom(48), TT.OneImgEval(48, crop=True)):
        ds = GeshaemPatch(gesh, GeshaemPatch.Split.VAL, transform=transform)
        assert pools_batches(ds)
        pooled = list(DataLoader(ds, batch_size=5, num_workers=2))
        items = list(DataLoader(ds, batch_size=5, num_workers=0))
        assert len(pooled) == len(items) == -(-len(ds) // 5)
        for (a, la), (b, lb) in zip(pooled, items):
            assert a.shape[1:] == (2, 48, 48, 3)
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)

    class Ragged:
        transform = TT.OneImgEval(48, crop=True)

        def __init__(self):
            self.ds = GeshaemPatch(gesh, GeshaemPatch.Split.VAL, transform=self.transform)
            self.calls = 0

        def __len__(self):
            return 4

        def raw_images(self, i):
            return self.ds.raw_images(i)[: 1 + i % 2]

        def item_meta(self, i):
            return (np.asarray(i),)

        def __getitem__(self, i):
            self.calls += 1
            return self.ds[0][0][: 1 + i % 2][:1], np.asarray(i)

    ragged = Ragged()
    batches = list(DataLoader(ragged, batch_size=4, num_workers=2))
    assert ragged.calls == 4 and batches[0][0].shape == (4, 1, 48, 48, 3)


# ------------------------------------------------------------------ training
def _jax_stub(img_size=32, dev_norm=False):
    return types.SimpleNamespace(
        config=types.SimpleNamespace(
            DATA=types.SimpleNamespace(IMG_SIZE=img_size),
            TPU=types.SimpleNamespace(DEVICE_NORMALIZE=dev_norm)),
        NEG_PAIR_RATIO=1.0, NEG_FULL_ROW=True, max_pairs=2 * 12 + 1)


@pytest.mark.parametrize("max_pairs", [25, 9])
def test_prepare_data_matches_jax(max_pairs):
    """Michigan's mining (negatives over the whole row, at most one per
    positive), one np.random seed: equal pairs in the same order; the
    buffer of (1 + 1) * B + 1 holds every pair it mines at m = 3."""
    from michigan import MichiganTrainer as JaxTrainer
    from vit_ed_tpu_torch.michigan import MichiganTrainer

    stub = _jax_stub()
    stub.max_pairs = max_pairs
    samples = np.random.default_rng(0).normal(size=(12, 8, 8, 3)).astype(np.float32)
    targets = np.repeat(np.asarray([4, 1, 7, 2], np.int32), 3)
    np.random.seed(5)
    ref = JaxTrainer.prepare_data(stub, samples, targets)
    np.random.seed(5)
    ours = MichiganTrainer.prepare_data(stub, samples, targets)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    live = int(ours["pair_mask"].sum())
    assert live == min(max_pairs, 12 + 12)     # 12 positives, 12 negatives
    neg = ours["pair_mask"].astype(bool) & (ours["pair_targets"][:, 0] == 0)
    assert (ours["gj"][neg] < ours["gi"][neg]).any()   # below the diagonal too


def test_sum_loss_matches_jax():
    """The summed masked BCE of the mined pairs on converted params: f32,
    relative 1e-5 (the logits agree to ~1e-6)."""
    from hisfrag import HisfragTrainer as JaxHisfrag
    from michigan import MichiganTrainer as JaxTrainer
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu_torch.michigan import MichiganTrainer
    from vit_ed_tpu_torch.models.convert import load_jax_params
    from vit_ed_tpu_torch.models.vit_ed import ViTED
    from vit_ed_tpu_torch.train.losses import bce_with_logits

    kw = dict(embed_dim=32, num_heads=2, depth=1, c_depth=2, img_size=32,
              patch_size=16, num_classes=1)
    jm = JaxViTED(**kw, use_pallas=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = load_jax_params(ViTED(**kw), params).train()

    stub = _jax_stub()
    stub.LOSS_REDUCTION = "sum"
    stub.config.MODEL = types.SimpleNamespace(
        TYPE="pjs", PJS=types.SimpleNamespace(MOE=types.SimpleNamespace(
            EXPERTS=0, AUX_WEIGHT=0.0, Z_WEIGHT=0.0)))
    samples = np.random.default_rng(4).normal(size=(12, 32, 32, 3)).astype(np.float32)
    np.random.seed(1)
    batch = JaxTrainer.prepare_data(stub, samples, np.repeat(np.arange(4), 3).astype(np.int32))
    assert JaxTrainer.LOSS_REDUCTION == MichiganTrainer.LOSS_REDUCTION == "sum"
    ref = JaxHisfrag.make_loss_fn(stub, None)(
        jm, params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    ours = MichiganTrainer.make_loss_fn(stub, bce_with_logits)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    ref = float(ref)
    assert abs(ours.item() - ref) <= 1e-5 * abs(ref)
    assert ref > 1.0    # a sum over the live pairs, not their mean


@pytest.mark.parametrize("dev_norm", [False, True])
def test_train_transform_matches_jax(dev_norm):
    """Michigan's train chain under one ``random`` seed: equal arrays."""
    from michigan import MichiganTrainer as JaxTrainer
    from vit_ed_tpu_torch.michigan import MichiganTrainer

    stub = _jax_stub(img_size=48, dev_norm=dev_norm)
    ref_t = JaxTrainer.get_transforms(stub)["train"]
    ours_t = MichiganTrainer.get_transforms(stub)["train"]
    rng = np.random.default_rng(6)
    for seed, shape in enumerate([(90, 120), (40, 70), (48, 48)] * 3):
        img = Image.fromarray(rng.integers(0, 255, shape + (3,), dtype=np.uint8))
        random.seed(seed)
        ref = ref_t(img)
        random.seed(seed)
        ours = ours_t(img)
        assert ours.dtype == ref.dtype == (np.uint8 if dev_norm else np.float32)
        np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------- evaluation
class _Product(torch.nn.Module):
    """A stand-in model whose pair score is exact in both frameworks (one
    float32 product of two pixels), so that both entries rank the same
    distances."""

    def forward(self, x):
        return x[:, 0, 0, 0, :1] * x[:, 1, 0, 0, 1:2]


def _jax_product(variables, x):
    return x[:, 0, 0, 0, :1] * x[:, 1, 0, 0, 1:2]


def _port_trainer(gesh, out, mich=None):
    from vit_ed_tpu_torch.michigan import MichiganTrainer, parse_option

    trainer = MichiganTrainer(parse_option([
        "--cfg", CFG, "--data-path", mich or gesh, "--output", out,
        "--tag", "t", "--device", "cpu", "--disable_amp", "--batch-size", "4",
        "--opts", *SHRINK, "DATA.NUM_WORKERS", "0"]))
    trainer.geshaem_data_path = gesh
    trainer.model = _Product()
    return trainer


def test_geshaem_test_metrics_match_jax(trees, monkeypatch):
    """The same pair scores through both entries' aggregation: the
    pandas-free matrices equal the JAX entry's pandas matrices (NaN where
    a fragment pair was never scored, float64), and mean / min mAP, top-1,
    Pr@k5 and Pr@k10 are equal."""
    import michigan as jax_michigan
    from vit_ed_tpu_torch import michigan as port_michigan

    tmp, _mich, gesh = trees
    seen = {"jax": [], "port": []}

    def recorder(key, fn):
        def calc(d, labels, pos, *a, **k):
            out = fn(d, labels, pos, *a, **k)
            seen[key].append((np.asarray(d), list(labels), out))
            return out
        return calc

    monkeypatch.setattr(jax_michigan, "calc_map_prak",
                        recorder("jax", jax_michigan.calc_map_prak))
    monkeypatch.setattr(port_michigan, "calc_map_prak",
                        recorder("port", port_michigan.calc_map_prak))
    stub = _jax_stub(img_size=32)
    stub.config.DATA.TEST_BATCH_SIZE = 4
    stub.config.DATA.NUM_WORKERS = 0
    stub.config.PRINT_FREQ = 100
    stub.data_loader_registers = {}
    stub.geshaem_data_path = gesh
    stub.logger = logging.getLogger("jax_geshaem")
    stub.model = types.SimpleNamespace(apply=_jax_product)
    stub.local_params = lambda: {}
    stub.get_transforms = lambda: jax_michigan.MichiganTrainer.get_transforms(stub)
    ref = jax_michigan.MichiganTrainer.geshaem_test(stub)
    ours = _port_trainer(gesh, str(tmp / "out_gt")).geshaem_test()
    assert ours == ref
    assert len(seen["jax"]) == len(seen["port"]) == 2      # MEAN, MIN
    for (dj, lj, rj), (dp, lp, rp) in zip(seen["jax"], seen["port"]):
        assert dp.dtype == dj.dtype
        np.testing.assert_array_equal(dp, dj)
        assert lp == lj and rp == rj


def test_fragment_distance_matrix_equals_pandas():
    """The pandas-free matrix of ``geshaem_test`` against the JAX entry's
    ``pd.DataFrame.from_dict(orient="index").reindex(columns=index)``:
    the same values, NaN cells, order and dtype (float32 when every pair is
    there, float64 when a NaN is needed)."""
    pd = pytest.importorskip("pandas")
    from vit_ed_tpu_torch.michigan import fragment_distance_matrix

    rng = np.random.default_rng(7)
    names = ["Zeta", "A_B", "B", "c", "A", "C_D", "D"]
    for trial in range(40):
        dmap = {}
        for s in rng.permutation(names):
            for d in rng.permutation(names):   # each row's own dest order
                if trial < 4 or rng.random() < 0.6 or s == d:
                    v = rng.random()
                    v = float(v) if trial % 5 == 4 else np.float32(v)
                    dmap.setdefault(str(s), {})[str(d)] = v
        df = pd.DataFrame.from_dict(dmap, orient="index")
        df = df.reindex(columns=df.index)
        ours, labels = fragment_distance_matrix(dmap)
        ref = df.to_numpy()
        assert labels == list(df.columns) == list(df.index)
        assert ours.dtype == ref.dtype, (trial, ours.dtype, ref.dtype)
        np.testing.assert_array_equal(ours, ref)      # NaN == NaN
        assert np.isnan(ours).any() == (trial >= 4)


def test_eval_standard_matches_jax(trees):
    """The float16 similarity matrix of the same pair scores: the distance
    matrices, image names and fragment labels are equal."""
    import geshame_evaluation as jax_eval
    from vit_ed_tpu_torch import geshame_evaluation as port_eval

    _tmp, _mich, gesh = trees
    config = types.SimpleNamespace(DATA=types.SimpleNamespace(
        IMG_SIZE=32, DATA_PATH=gesh, TEST_BATCH_SIZE=5, NUM_WORKERS=2), PRINT_FREQ=100)
    logger = logging.getLogger("eval_standard")
    jax_trainer = types.SimpleNamespace(model=types.SimpleNamespace(apply=_jax_product),
                                        local_params=lambda: {})
    port_trainer = types.SimpleNamespace(
        model=_Product(),
        _to_device=lambda b: {k: torch.from_numpy(v) for k, v in b.items()})
    ref = jax_eval.eval_standard(config, jax_trainer, logger, 1, 0)
    ours = port_eval.eval_standard(config, port_trainer, logger)
    assert ours[0].dtype == ref[0].dtype == np.float32
    np.testing.assert_array_equal(ours[0], ref[0])
    assert ours[1] == ref[1]
    np.testing.assert_array_equal(ours[2], ref[2])
    # several processes gather their shares (tests/test_torch_multiprocess.py);
    # without the processes in a group there is nothing to gather from
    with pytest.raises(ValueError, match="process group"):
        port_eval.eval_standard(config, port_trainer, logger, world_size=2)


# ---------------------------------------------------------------- CPU drives
def test_entries_run_on_the_cpu(trees):
    """Each mode of both entries once at a small width: train (one epoch,
    the MFU line logged), eval (with the Geshaem test first), test,
    throughput, and geshame_evaluation; the JAX entries' log lines appear."""
    from vit_ed_tpu_torch import geshame_evaluation, michigan

    tmp, mich, gesh = trees
    out = str(tmp / "out_drive")

    def run(mode, *extra):
        return michigan.main(["--cfg", CFG, "--data-path", mich, "--mode", mode,
                              "--output", out, "--tag", "drive", "--device", "cpu",
                              "--disable_amp", "--batch-size", "6", *extra,
                              "--opts", *SHRINK, "TRAIN.EPOCHS", "1",
                              "TRAIN.WARMUP_EPOCHS", "0"])

    trainer = run("train")
    # 11 train papyri (31 images) x 20 items per epoch at batch 6
    assert trainer.step == len(trainer.get_dataloader("train")) == 100
    assert not trainer.preempted
    assert trainer.max_pairs == 2 * 6 + 1
    log = Path(trainer.config.OUTPUT, "log_rank0train.txt").read_text()
    assert "Michigan eval: mAP" in log and "model-FLOP MFU not computed" in log
    loss = run("eval", "--geshaem-data-path", gesh)
    assert 0.0 <= loss <= 1.0
    log = Path(trainer.config.OUTPUT, "log_rank0eval.txt").read_text()
    assert "Geshaem test MEAN: mAP" in log and "Geshaem test MIN: mAP" in log
    assert 0.0 <= run("test", "--geshaem-data-path", gesh) <= 1.0
    assert run("throughput") > 0
    metrics, dm, names, frags = geshame_evaluation.main([
        "--cfg", CFG, "--data-path", gesh, "--output", out, "--tag", "gesh",
        "--device", "cpu", "--disable_amp", "--opts", *SHRINK])
    assert dm.shape == (7, 7) and np.isfinite(dm).all() and len(names) == 7
    assert all(0.0 <= m <= 1.0 for m in metrics)
