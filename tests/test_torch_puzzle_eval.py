"""Puzzle evaluation in the port (``python -m vit_ed_tpu_torch.evaluation``)
against the JAX package's, on the CPU: the pieces cut from a PNG and a JPEG
and the network's input made of them, ``PairwiseScorer.score_dense`` on a
tiny float32 model (atol 1e-4), the row-shared and mixed-chunk schedules of
the port against each other (``score_dense`` atol 1e-6, the JAX suite's
bound; ``score_dataset`` equal), and the whole ``evaluation.testing`` on two
3 x 3 puzzles per subset with the same seed and weights: the same
placements, reconstructions, accuracies and Perfect count. The JAX model
runs its plain attention (``use_pallas=False``), as tests/test_puzzle_eval.py
does; the weights go through ``models/convert.py::jax_params_to_state_dict``.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import logging
import os
import types
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ed_tpu.data.pieces import PiecesImages as JaxPiecesImages
from vit_ed_tpu.data.transforms import TwoImgSyncEval as JaxTwoImgSyncEval
from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.parallel.mesh import create_mesh
from vit_ed_tpu.parallel.pairs import PairwiseScorer as JaxPairwiseScorer
from vit_ed_tpu.solver.importer import Puzzle as JaxPuzzle
from vit_ed_tpu_torch.data.pieces import PiecesImages
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.parallel import pairs
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.solver.importer import Puzzle

# anchored to the repository: a test that changes the working directory
# may run before this file in the same process
ROOT = Path(__file__).resolve().parent.parent
CFG = str(ROOT / "configs" / "puzzle" / "puzzle_eval_4bin_patch8_64.yaml")
KW = dict(img_size=32, patch_size=16, num_classes=4, embed_dim=32, depth=1,
          c_depth=1, num_heads=2)
SHRINK = ["MODEL.PJS.EMBED_DIM", "32", "MODEL.PJS.NUM_HEADS", "2",
          "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32",
          "MODEL.PJS.PATCH_SIZE", "16", "DATA.BATCH_SIZE", "4"]


@pytest.fixture(scope="module")
def models():
    jm = JaxViTED(**KW, use_pallas=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    return jm, params, load_jax_params(ViTED(**KW), params).eval()


def _puzzle_image(path, seed, size=96):
    """A smooth colour field (neighbouring pieces share their borders)."""
    small = np.random.default_rng(seed).integers(0, 256, (5, 5, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((size, size + 2), Image.BICUBIC)
    if path.endswith(".jpg"):
        img.save(path, quality=92)
    else:
        img.save(path)
    return path


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_pieces_and_network_input_equal_jax(tmp_path, ext):
    path = _puzzle_image(str(tmp_path / f"p.{ext}"), 1)
    ref = JaxPuzzle(0, path, 32, starting_piece_id=0, erosion=0.07)
    ours = Puzzle(0, path, 32, starting_piece_id=0, erosion=0.07)
    assert ours.grid_size == ref.grid_size == (3, 3)
    assert len(ours.pieces) == 9 and ours.pieces[0].width == 30
    for a, b in zip(ref.pieces, ours.pieces):
        assert b.original_piece_id == a.original_piece_id
        np.testing.assert_array_equal(b.lab_image, a.lab_image)
        np.testing.assert_array_equal(b.bgr_image(), a.bgr_image())
    x_ref = JaxPiecesImages(ref.pieces, transform=JaxTwoImgSyncEval(32)).all_images()
    x = PiecesImages(ours.pieces, transform=TwoImgSyncEval(32)).all_images()
    assert x.shape == x_ref.shape == (9, 32, 32, 3) and x.dtype == np.float32
    np.testing.assert_array_equal(x, x_ref)


def _piece_images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(np.float32)


def test_score_dense_matches_jax(models):
    jm, params, model = models
    imgs = _piece_images(9)
    ref = JaxPairwiseScorer(jm, params, create_mesh(), num_outputs=4,
                            pair_chunk=16).score_dense(imgs, batch_size=4)
    out = PairwiseScorer(model, num_outputs=4, pair_chunk=16).score_dense(
        imgs, batch_size=4)
    assert out.shape == ref.shape == (9, 9, 4) and out.dtype == np.float32
    assert not out[np.arange(9), np.arange(9)].any()
    np.testing.assert_allclose(out, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("schedule", ["mixed", "mixed_kv_cache", "budget"])
def test_score_dense_schedules_agree(models, monkeypatch, schedule):
    """The mixed-chunk schedule (asked for, with per-pair K/V gathers, or
    taken because the K/V block passes the budget) against the row-shared
    one, and the diagonal when asked for."""
    _jm, _params, model = models
    imgs = _piece_images(7, seed=1)
    row = PairwiseScorer(model, num_outputs=4, pair_chunk=8)
    kwargs = {"mixed": {"row_shared": False},
              "mixed_kv_cache": {"use_kv_cache": True}, "budget": {}}[schedule]
    other = PairwiseScorer(model, num_outputs=4, pair_chunk=8, **kwargs)
    assert other.row_shared == (schedule == "budget")
    d_row = row.score_dense(imgs, batch_size=3, include_diagonal=True)
    if schedule == "budget":
        monkeypatch.setattr(pairs, "_KV_BLOCK_BUDGET", 0)
    calls = []
    inner = other.score_pairs_block
    monkeypatch.setattr(other, "score_pairs_block",
                        lambda *a: calls.append(len(a[2])) or inner(*a))
    d_other = other.score_dense(imgs, batch_size=3, include_diagonal=True)
    assert calls == [49]
    np.testing.assert_allclose(d_other, d_row, atol=1e-6, rtol=0)


class ArrayDataset:
    def __init__(self, imgs):
        self.imgs = imgs

    def __getitem__(self, i):
        return self.imgs[i], i

    def __len__(self):
        return len(self.imgs)


@pytest.mark.parametrize("schedule", ["mixed", "mixed_kv_cache", "budget"])
def test_score_dataset_mixed_fallback_equals_row_shared(models, monkeypatch, schedule):
    """tests/test_pairs.py:66-80 in the port: the mixed-chunk schedule gives
    the row-sharded schedule's float16 matrix exactly. ``budget`` is the
    fallback that replaced the port's raise: a K/V block past the budget."""
    jm, params, model = models
    m1 = load_jax_params(ViTED(**dict(KW, num_classes=1)),
                         {**params, "head": {"kernel": params["head"]["kernel"][:, :1],
                                             "bias": params["head"]["bias"][:1]}})
    ds = ArrayDataset(_piece_images(11, seed=2))
    s_row = PairwiseScorer(m1, pair_chunk=8).score_dataset(ds, batch_size=4,
                                                            num_workers=0)
    kwargs = {"mixed": {"row_shared": False},
              "mixed_kv_cache": {"use_kv_cache": True}, "budget": {}}[schedule]
    scorer = PairwiseScorer(m1, pair_chunk=8, **kwargs)
    if schedule == "budget":
        monkeypatch.setattr(pairs, "_KV_BLOCK_BUDGET", 0)
    warnings = []
    logger = types.SimpleNamespace(info=lambda m: None, warning=warnings.append)
    calls = []
    inner = scorer.score_pairs_block
    monkeypatch.setattr(scorer, "score_pairs_block",
                        lambda *a: calls.append(len(a[2])) or inner(*a))
    s_mixed = scorer.score_dataset(ds, batch_size=4, num_workers=0, logger=logger)
    assert sum(calls) == scorer.pairs_done == 11 * 12 // 2
    assert bool(warnings) == (schedule == "budget")
    np.testing.assert_array_equal(s_mixed, s_row)


def _write_puzzles(root):
    for k, subset in enumerate(("Cho", "McGill", "BGU")):
        os.makedirs(os.path.join(root, subset))
        for i in range(2):
            _puzzle_image(os.path.join(root, subset, f"{i}.png"), 10 * k + i)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _bb(puzzle):
    return sorted((i, s.value, j, t.value) for i, s, j, t in puzzle.best_buddy_pairs)


def test_evaluation_matches_jax_evaluation(tmp_path, monkeypatch, models):
    import evaluation as jax_evaluation
    from vit_ed_tpu.config import get_config as jax_get_config
    from vit_ed_tpu.utils import set_seed as jax_set_seed
    from vit_ed_tpu_torch import evaluation

    jm, params, _model = models
    data = str(tmp_path / "data")
    _write_puzzles(data)
    pth = str(tmp_path / "w.pth")
    torch.save(jax_params_to_state_dict(params), pth)

    # the JAX entry's testing(), with its solver calls recorded
    solved = []
    inner = jax_evaluation.paikin_tal_driver
    monkeypatch.setattr(jax_evaluation, "paikin_tal_driver",
                        lambda *a, **k: solved.append(inner(*a, **k)) or solved[-1])
    config = jax_get_config(types.SimpleNamespace(
        cfg=CFG, data_path=data, disable_amp=True, output=str(tmp_path / "jo"),
        tag="t", opts=SHRINK + ["TPU.USE_PALLAS_ATTENTION", "False"]))
    jax_lines = Lines()
    jax_logger = logging.getLogger("jax_puzzle_eval")
    jax_logger.addHandler(jax_lines)
    jax_logger.setLevel(logging.INFO)
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    jax_set_seed(config.SEED)
    jax_evaluation.testing(config, jm, params, jax_logger)

    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    records = evaluation.main([
        "--cfg", CFG, "--data-path", data, "--pretrained", pth, "--device", "cpu",
        "--disable_amp", "--output", str(tmp_path / "po"), "--tag", "t",
        "--opts", *SHRINK])
    assert [(r["subset"], r["pieces"], r["pairs"]) for r in records] == \
        [(s, 9, 72) for s in ("Cho", "McGill", "BGU") for _ in range(2)]
    assert len(solved) == len(records) == 6
    for ref, rec in zip(solved, records):
        ours = rec["puzzle"]
        assert sorted((p.original_piece_id, p.location) for p in ours.pieces) == \
            sorted((p.original_piece_id, p.location) for p in ref.pieces)
        assert _bb(ours) == _bb(ref)
    jax_avg = [m for m in jax_lines.lines if m.startswith("Average_Results")]
    port_log = (tmp_path / "po" / "eval_erosion7_4bin_patch8_64" / "t" / "log_rank0_test.txt")
    port_avg = [line.split(" INFO ", 1)[1] for line in port_log.read_text().splitlines()
                if " INFO Average_Results" in line]
    assert len(jax_avg) == 3 and port_avg == jax_avg
    # the same reconstructions and accuracy images, pixel for pixel
    for sub in ("Cho", "McGill", "BGU"):
        for name in ("0.png", "1.png", "accuracy_0.png", "accuracy_1.png"):
            a = cv2.imread(str(tmp_path / "jax" / "output" / "reconstructed" / sub / name))
            b = cv2.imread(str(tmp_path / "port" / "output" / "reconstructed" / sub / name))
            assert a is not None and b is not None
            np.testing.assert_array_equal(b, a)


def test_entry_needs_its_weights_and_a_card(tmp_path, monkeypatch):
    from vit_ed_tpu_torch import evaluation

    argv = ["--cfg", CFG, "--data-path", str(tmp_path), "--pretrained",
            str(tmp_path / "missing.pth"), "--output", str(tmp_path / "o"), "--opts", *SHRINK]
    with pytest.raises(FileNotFoundError, match="Pretrained model does not exist"):
        evaluation.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        evaluation.main(argv)
