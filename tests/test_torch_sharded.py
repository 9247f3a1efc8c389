"""The port's one-process sharded test path against the JAX package: the
row-slab wi19 metrics (``metrics/wi19_sharded.py``), the scorer's complete
rows (``assemble=False``) in memory and on disk with their resume, and
``python -m vit_ed_tpu_torch.hisfrag --mode test`` under
``TPU.SHARDED_EVAL_METRICS`` against the JAX entry's ``_test_sharded``."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import glob
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_ed_tpu.metrics import get_metrics as jax_get_metrics
from vit_ed_tpu.metrics.wi19_sharded import merge_partials as jax_merge
from vit_ed_tpu.metrics.wi19_sharded import row_partials as jax_row_partials
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.metrics.wi19_sharded import merge_partials, row_partials
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

ROOT = Path(__file__).resolve().parent.parent
KW = dict(img_size=32, patch_size=16, num_classes=1, embed_dim=128,
          depth=1, c_depth=2, num_heads=2)
N, BATCH = 10, 4


def _fixture(n=40, n_classes=7, seed=0, with_singletons=False):
    """tests/test_metrics_sharded.py's distance matrix and labels."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, size=n)
    if with_singletons:
        labels[:3] = [100, 101, 102]
    emb = rng.normal(size=(n, 8)) + labels[:, None] * 0.8
    return np.linalg.norm(emb[:, None] - emb[None, :], axis=-1), labels


def _same(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        if np.isnan(w):
            assert np.isnan(g)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol)


@pytest.mark.parametrize("with_singletons", [False, True])
@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_row_partials_match_jax_and_the_full_metrics(world, with_singletons):
    D, labels = _fixture(with_singletons=with_singletons)
    bounds = np.linspace(0, len(D), world + 1).astype(int)
    slabs = list(zip(bounds[:-1], bounds[1:]))
    ours = [row_partials(D[lo:hi], labels, row_labels=labels[lo:hi]) for lo, hi in slabs]
    ref = [jax_row_partials(D[lo:hi], labels, row_labels=labels[lo:hi])
           for lo, hi in slabs]
    for o, r in zip(ours, ref):
        assert o.keys() == r.keys()
        _same([o[k] for k in sorted(o)], [r[k] for k in sorted(r)])
    _same(merge_partials(ours), jax_merge(ref))
    _same(merge_partials(ours), get_metrics(D, labels))
    if with_singletons:   # Pr@k is NaN as soon as one query is a singleton
        assert np.isnan(merge_partials(ours)[2])


def test_all_singleton_queries_give_nan_map():
    rng = np.random.default_rng(1)
    labels = np.arange(12)
    emb = rng.normal(size=(12, 8))
    D = np.linalg.norm(emb[:, None] - emb[None, :], axis=-1)
    got = merge_partials([row_partials(D[:6], labels, row_labels=labels[:6]),
                          row_partials(D[6:], labels, row_labels=labels[6:])])
    ref = jax_get_metrics(D, labels)
    assert np.isnan(got[0]) and np.isnan(ref[0])
    _same(got, ref)


# ---------------------------------------------------------------- the scorer
class ArrayDataset:
    """(image, index) items; raises at load ``fail_at`` (a killed scan)."""

    def __init__(self, imgs, fail_at=None):
        self.imgs, self.fail_at, self.loads = imgs, fail_at, 0

    def __getitem__(self, i):
        self.loads += 1
        if self.fail_at is not None and self.loads > self.fail_at:
            raise RuntimeError("dataset failed")
        return self.imgs[i], i

    def __len__(self):
        return len(self.imgs)


@pytest.fixture(scope="module")
def scan():
    torch.manual_seed(0)
    model = ViTED(**KW)
    imgs = np.random.default_rng(0).normal(size=(N, 32, 32, 3)).astype(np.float32)
    scorer = PairwiseScorer(model, num_outputs=1, pair_chunk=16)
    full = scorer.score_dataset(ArrayDataset(imgs), batch_size=BATCH, num_workers=0)
    return scorer, imgs, full


def _rows(scorer, imgs, out_dir=None, **kw):
    rows, row_range = scorer.score_dataset(
        ArrayDataset(imgs), batch_size=BATCH, num_workers=0, out_dir=out_dir,
        tag="t", assemble=False, **kw)
    assert row_range == range(0, N)
    return rows


def test_complete_rows_equal_the_assembled_matrix(scan, tmp_path):
    scorer, imgs, full = scan
    rows = _rows(scorer, imgs)
    assert rows.shape == (N, N) and rows.dtype == np.float16
    np.testing.assert_array_equal(rows, full)
    # the blocked mirror at blocks smaller than the matrix
    slab = np.triu(full)[..., None].copy()
    np.testing.assert_array_equal(scorer._complete_rows(slab, mirror_block=3), full)
    # .npz blocks resume as in the assembled path
    np.testing.assert_array_equal(_rows(scorer, imgs, str(tmp_path)), full)
    assert len(glob.glob(str(tmp_path / "t_rank0_rows*.npz"))) == 3
    np.testing.assert_array_equal(_rows(scorer, imgs, str(tmp_path)), full)
    assert scorer.pairs_done == 0


def test_slab_on_disk_rows_equal_in_memory_rows(scan, tmp_path):
    scorer, imgs, full = scan
    rows = _rows(scorer, imgs, str(tmp_path), slab_on_disk=True)
    assert isinstance(rows, np.memmap)
    np.testing.assert_array_equal(rows, _rows(scorer, imgs))
    np.testing.assert_array_equal(rows, full)
    assert sorted(os.listdir(tmp_path)) == [
        "t_rank0_rows0.done", "t_rank0_rows4.done", "t_rank0_rows8.done",
        "t_rank0_slab.dat", "t_rank0_slab.dat.json"]
    with open(tmp_path / "t_rank0_slab.dat.json") as f:
        assert json.load(f) == {"shape": [N, N, 1], "dtype": "float16"}
    # the JAX scorer's argument rules
    with pytest.raises(ValueError, match="assemble=False"):
        scorer.score_dataset(ArrayDataset(imgs), batch_size=BATCH, out_dir=str(tmp_path),
                             slab_on_disk=True)
    with pytest.raises(ValueError, match="out_dir"):
        _rows(scorer, imgs, None, slab_on_disk=True)


def test_killed_scan_resumes_to_the_uninterrupted_slab(scan, tmp_path):
    scorer, imgs, full = scan
    out = str(tmp_path)
    # the token cache reads all N images, then each block its rows: the
    # load after block 1's rows fails, with blocks 0 and 1 on disk
    with pytest.raises(RuntimeError, match="dataset failed"):
        scorer.score_dataset(ArrayDataset(imgs, fail_at=N + 2 * BATCH),
                             batch_size=BATCH, num_workers=0, out_dir=out,
                             tag="t", assemble=False, slab_on_disk=True)
    assert sorted(glob.glob(os.path.join(out, "*.done"))) == [
        os.path.join(out, "t_rank0_rows0.done"), os.path.join(out, "t_rank0_rows4.done")]
    resumed = _rows(scorer, imgs, out, slab_on_disk=True)
    assert scorer.pairs_done == sum(N - i for i in range(2 * BATCH, N))
    np.testing.assert_array_equal(resumed, full)
    # a finished scan loads, builds and scores nothing
    ds = ArrayDataset(imgs)
    again, _ = scorer.score_dataset(ds, batch_size=BATCH, num_workers=0, out_dir=out,
                                    tag="t", assemble=False, slab_on_disk=True)
    assert ds.loads == 0 and scorer.pairs_done == 0
    np.testing.assert_array_equal(again, full)
    # resume=False starts over
    _rows(scorer, imgs, out, slab_on_disk=True, resume=False)
    assert scorer.pairs_done == N * (N + 1) // 2


def test_stale_meta_recreates_the_slab(scan, tmp_path):
    scorer, imgs, full = scan
    out = str(tmp_path)
    _rows(scorer, imgs, out, slab_on_disk=True)
    meta = tmp_path / "t_rank0_slab.dat.json"
    meta.write_text(json.dumps({"shape": [N + 1, N + 1, 1], "dtype": "float16"}))

    class Log:
        lines = []

        def info(self, msg):
            self.lines.append(msg)

        warning = info

    log = Log()
    rows, _ = scorer.score_dataset(ArrayDataset(imgs), batch_size=BATCH, num_workers=0,
                                   out_dir=out, tag="t", assemble=False,
                                   slab_on_disk=True, logger=log)
    assert any(m.startswith("Recreating stale slab") for m in log.lines)
    assert not any("complete on disk" in m for m in log.lines)
    assert scorer.pairs_done == N * (N + 1) // 2
    np.testing.assert_array_equal(rows, full)
    with open(meta) as f:
        assert json.load(f)["shape"] == [N, N, 1]


# ---------------------------------------------------------------- the entry
SHRINK = ["MODEL.PJS.EMBED_DIM", "128", "MODEL.PJS.NUM_HEADS", "2",
          "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1",
          "DATA.IMG_SIZE", "64", "MODEL.PJS.PATCH_SIZE", "16",
          "DATA.NUM_WORKERS", "2", "DATA.BATCH_SIZE", "6"]
CFG = str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml")
LINE = re.compile(r"mAP (\S+)\tTop 1 (\S+)\tPr@k10 (\S+)\tPr@k100 (\S+)")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """tests/test_torch_hisfrag.py's corpus: 16 JPEGs of 4 writers and one
    ``.pth`` written from JAX params, which both entries load."""
    import jax
    import jax.numpy as jnp
    from test_torch_hisfrag import _write_corpus
    from vit_ed_tpu.models.convert import params_to_torch_state_dict
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED

    tmp = tmp_path_factory.mktemp("sharded_torch")
    data = str(tmp / "data")
    _write_corpus(data)
    jm = JaxViTED(img_size=64, patch_size=16, num_classes=1, embed_dim=128,
                  depth=1, c_depth=1, num_heads=2, use_pallas=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(5),
                              jnp.zeros((1, 2, 64, 64, 3)))["params"]
    sd = params_to_torch_state_dict(jax.tree.map(np.asarray, params))
    pth = str(tmp / "weights.pth")
    torch.save({"model": {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}}, pth)
    return tmp, data, pth


def _log_metrics(out_dir):
    text = open(os.path.join(out_dir, "log_rank0test.txt")).read()
    return [tuple(float(v) for v in m) for m in LINE.findall(text)], text


def test_sharded_test_mode_matches_the_jax_entry(corpus):
    from hisfrag import HisfragTrainer
    from test_torch_hisfrag import JaxArgs
    from vit_ed_tpu_torch.hisfrag import main

    tmp, data, pth = corpus
    args = JaxArgs()
    args.data_path, args.pretrained, args.output = data, pth, str(tmp / "out_sharded")
    args.opts = SHRINK + ["TPU.SHARDED_EVAL_METRICS", "True"]
    jax_trainer = HisfragTrainer(args)
    jax_map = jax_trainer._test_sharded()
    jax_logged, _ = _log_metrics(jax_trainer.config.OUTPUT)

    def port(tag, *keys):
        out = tmp / "out_sharded" / "hisfrag20_patch16_512" / tag
        res = main(["--cfg", CFG, "--data-path", data, "--mode", "test",
                    "--output", str(tmp / "out_sharded"), "--tag", tag, "--device",
                    "cpu", "--disable_amp", "--pretrained", pth,
                    "--opts", *SHRINK, *keys])
        return res, out

    (metrics, rows, names, scorer), out = port(
        "mem", "TPU.SHARDED_EVAL_METRICS", "True")
    assert not glob.glob(str(out / "*.csv"))
    assert rows.shape == (16, 16) and scorer.pairs_done == 16 * 17 // 2
    np.testing.assert_allclose(metrics[0], jax_map, rtol=1e-12)
    logged, _ = _log_metrics(out)
    assert logged == jax_logged and len(logged) == 1
    # the same metrics as the assembled path, and on disk
    (assembled, dm, _, _), out_asm = port("assembled")
    _same(metrics, assembled)
    np.testing.assert_array_equal(
        (1.0 - rows.astype(np.float32)).astype(np.float16), dm)
    (on_disk, rows_disk, _, _), out_disk = port(
        "disk", "TPU.SHARDED_EVAL_METRICS", "True", "TPU.EVAL_SLAB_ON_DISK", "True")
    assert isinstance(rows_disk, np.memmap)
    np.testing.assert_array_equal(rows_disk, rows)
    assert [float(v) for v in on_disk] == [float(v) for v in metrics]
    assert (out_disk / "test_rank0_slab.dat").exists()
    assert len(glob.glob(str(out_disk / "test_rank0_rows*.done"))) == 3
    assert not glob.glob(str(out_disk / "*.csv"))
    # EVAL_SLAB_ON_DISK alone warns and takes the assembled path
    (alone, _, _, _), out_alone = port("alone", "TPU.EVAL_SLAB_ON_DISK", "True")
    _, text = _log_metrics(out_alone)
    assert "TPU.EVAL_SLAB_ON_DISK has no effect without" in text
    assert (out_alone / "distance_matrix_rank0.csv").exists()
    assert [float(v) for v in alone] == [float(v) for v in assembled]
