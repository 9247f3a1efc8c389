"""The Pajigsaw fragment entry of the port (``python -m
vit_ed_tpu_torch.pajigsaw``, data/pajigsaw.py, data/pieces.py::PiecesDataset)
against the root ``pajigsaw.py`` and ``vit_ed_tpu/data/pajigsaw.py`` of the
JAX package on the CPU, on two 3 x 4 fragment grids (the manifest of
tests/test_datasets_misc.py's Pajigsaw test, widened to two images of
3 x 4 fragments):

- ``Pajigsaw`` items (the stacked pair and its label) equal the JAX
  dataset's at every index under three ``random.seed``s, and the build
  factory gives the same dataset;
- ``PajigsawPieces``' LAB pixels equal the JAX package's ``cv2.imread`` +
  ``COLOR_BGR2LAB`` bit for bit, with the same grid locations;
- ``PiecesDataset`` items equal the JAX package's (its LAB -> RGB by
  ``cv2.cvtColor``);
- the tiny trainer of tests/test_entries.py trains one epoch from the JAX
  trainer's converted weights: every update's loss within 1e-4 of the JAX
  trainer's (f32, DropPath 0; both draw the same items, since both
  validate, solve and draw from ``random`` in the same order);
- validation solves the same puzzles: the same neighbour accuracy and
  ``Average_Results`` line for the same shuffles;
- the CLI in every mode on the CPU, and no run without a card unless asked
  for the CPU.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import json
import logging
import os
import random
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ed_tpu_torch import pajigsaw
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.pajigsaw import Pajigsaw, PajigsawPieces, Split
from vit_ed_tpu_torch.data.pieces import PiecesDataset
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict

ROOT = Path(__file__).resolve().parent.parent
CFG = """
MODEL:
  TYPE: pjs
  NAME: tiny_pajigsaw
  NUM_CLASSES: 4
  DROP_PATH_RATE: 0.0
  PJS:
    EMBED_DIM: 32
    PATCH_SIZE: 32
    NUM_HEADS: 2
    DEPTH: 1
    C_DEPTH: 1
DATA:
  DATASET: pajigsaw
  IMG_SIZE: 64
  BATCH_SIZE: 8
  NUM_WORKERS: 0
TRAIN:
  EPOCHS: 1
  WARMUP_EPOCHS: 0
  BASE_LR: 0.05
SAVE_FREQ: 10
PRINT_FREQ: 1
"""


def write_pajigsaw(root, images=2, rows=3, cols=4, size=64, seed=0):
    """``images`` smooth images cut into a rows x cols grid of ``size`` px
    JPEG fragments, one manifest for train, val and test."""
    rng = np.random.default_rng(seed)
    manifest = {}
    for im in range(images):
        small = rng.integers(0, 256, (rows + 1, cols + 1, 3), dtype=np.uint8)
        big = np.asarray(Image.fromarray(small).resize((cols * size, rows * size),
                                                       Image.BICUBIC))
        os.makedirs(os.path.join(root, f"img{im}"), exist_ok=True)
        fragments = []
        for r in range(rows):
            for c in range(cols):
                rel = f"img{im}/{r}_{c}.jpg"
                Image.fromarray(big[r * size:(r + 1) * size, c * size:(c + 1) * size]).save(
                    os.path.join(root, rel), quality=92)
                fragments.append({"im_path": rel, "row": r, "col": c, "degree": 0,
                                  "white_percentage": 0.0})
        manifest[f"img{im}"] = {"Fragment1v1Rotate90": fragments}
    for split in ("train", "val", "test"):
        with open(os.path.join(root, f"{split}.json"), "w") as f:
            json.dump(manifest, f)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("pajigsaw")
    write_pajigsaw(str(root))
    return root


def test_pajigsaw_items_equal_jax(data):
    from vit_ed_tpu.data.pajigsaw import Pajigsaw as JaxPajigsaw
    from vit_ed_tpu.data.transforms import TwoImgSyncEval as JaxTwoImgSyncEval

    ours = Pajigsaw(str(data), Split.TRAIN, transform=TwoImgSyncEval(64))
    ref = JaxPajigsaw(str(data), JaxPajigsaw.Split.TRAIN, transform=JaxTwoImgSyncEval(64))
    assert len(ours) == len(ref) == 24 and ours.im_names == ref.im_names
    assert np.array_equal(ours._sample_ids, ref._sample_ids)
    positives = 0
    for seed in (0, 1, 2):
        for i in range(len(ours)):
            random.seed(seed * 1000 + i)
            a, la = ours[i]
            random.seed(seed * 1000 + i)
            b, lb = ref[i]
            assert a.dtype == b.dtype == np.float32 and a.shape == (2, 64, 64, 3)
            assert np.array_equal(a, b) and np.array_equal(la, lb)
            positives += int(la.sum())
    assert 0 < positives < 3 * len(ours)          # both kinds were drawn
    config = types.SimpleNamespace(DATA=types.SimpleNamespace(
        DATASET="pajigsaw", DATA_PATH=str(data), IMG_SIZE=64))
    built, repeat = build_dataset("train", config, {"train": None})
    assert repeat == 1 and isinstance(built, Pajigsaw) and len(built) == 24


def test_pieces_equal_jax_cv2(data):
    from vit_ed_tpu.data.pajigsaw import PajigsawPieces as JaxPieces
    from vit_ed_tpu.data.pieces import PiecesDataset as JaxPiecesDataset
    from vit_ed_tpu.data.transforms import TwoImgSyncEval as JaxTwoImgSyncEval

    ours = PajigsawPieces(str(data), Split.VAL)
    ref = JaxPieces(str(data), JaxPieces.Split.VAL)
    assert len(ours) == len(ref) == 2
    for i in range(len(ours)):
        pieces, name, grid = ours[i]
        ref_pieces, ref_name, ref_grid = ref[i]
        assert (name, grid) == (ref_name, ref_grid) and grid == (3, 4)
        for p, q in zip(pieces, ref_pieces, strict=True):
            assert p.lab_image.dtype == q.lab_image.dtype == np.uint8
            assert np.array_equal(p.lab_image, q.lab_image)
            assert p.original_piece_id == q.original_piece_id
            assert p.location == q.location
    pieces, _, _ = ours[0]
    ref_pieces, _, _ = ref[0]
    ds = PiecesDataset(pieces[:4], transform=TwoImgSyncEval(64))
    ref_ds = JaxPiecesDataset(ref_pieces[:4], transform=JaxTwoImgSyncEval(64))
    assert len(ds) == len(ref_ds) == 12 and ds.entries == ref_ds.entries
    for i in range(len(ds)):
        (a, ia), (b, ib) = ds[i], ref_ds[i]
        assert a.shape == (2, 64, 64, 3) and np.array_equal(a, b) and int(ia) == int(ib)


def _args(cfg, data, out, mode="train"):
    return types.SimpleNamespace(
        cfg=str(cfg), opts=None, data_path=str(data), output=str(out), tag="t",
        mode=mode, device="cpu", disable_amp=True, batch_size=None, pretrained=None,
        resume=None, accumulation_steps=None, use_checkpoint=False, optim=None)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def test_training_epoch_and_validation_track_jax(tmp_path, data, monkeypatch):
    from pajigsaw import PajigsawTrainer as JaxPajigsawTrainer

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CFG)
    # the JAX trainer's batch is DATA.BATCH_SIZE per device of its mesh (the
    # tests' CPU mesh has 8): 8 items per update on both sides
    jax_cfg = tmp_path / "jax_cfg.yaml"
    n_dev = jax.device_count()
    assert 8 % n_dev == 0
    jax_cfg.write_text(CFG.replace("BATCH_SIZE: 8", f"BATCH_SIZE: {8 // n_dev}"))
    jax_trainer = JaxPajigsawTrainer(_args(jax_cfg, data, tmp_path / "j"))
    weights = jax_params_to_state_dict(jax.tree.map(np.asarray, jax.device_get(
        jax_trainer.params)))
    ref_losses = []
    inner = jax_trainer._aot_step

    def record(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        ref_losses.append(float(metrics["loss"]))
        return state, metrics

    monkeypatch.setattr(jax_trainer, "_aot_step", record)
    jax_lines = Lines()
    jax_trainer.logger.addHandler(jax_lines)
    jax_trainer.train()

    trainer = pajigsaw.PajigsawTrainer(_args(cfg, data, tmp_path / "p"))
    trainer.model.load_state_dict(weights, strict=True)
    losses = []
    port_step = trainer.train_step

    def port_record(micro_batches):
        loss, norm = port_step(micro_batches)
        losses.append(loss.item())
        return loss, norm

    monkeypatch.setattr(trainer, "train_step", port_record)
    lines = Lines()
    trainer.logger.addHandler(lines)
    trainer.train()

    # 24 anchors / batch 8 = 3 updates, each on the same drawn items
    assert len(losses) == len(ref_losses) == 3 and trainer.step == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    assert abs(ref_losses[-1] - ref_losses[0]) > 1e-4        # the loss moved
    # two validates each (before and after the epoch), the same solved puzzles
    avg = [m for m in lines.lines if m.startswith("Average_Results")]
    ref_avg = [m for m in jax_lines.lines if m.startswith("Average_Results")]
    assert len(avg) == 2 and avg[0] == ref_avg[0]
    assert (Path(trainer.config.OUTPUT) / "checkpoint.ckpt").is_file()


def test_validation_solves_like_jax(tmp_path, data):
    """The same weights and shuffles give the same puzzles and accuracies."""
    from pajigsaw import PajigsawTrainer as JaxPajigsawTrainer
    from vit_ed_tpu.data.pajigsaw import PajigsawPieces as JaxPieces

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CFG)
    jax_trainer = JaxPajigsawTrainer(_args(cfg, data, tmp_path / "j", mode="eval"))
    trainer = pajigsaw.PajigsawTrainer(_args(cfg, data, tmp_path / "p", mode="eval"))
    trainer.model.load_state_dict(jax_params_to_state_dict(jax.tree.map(
        np.asarray, jax.device_get(jax_trainer.params))), strict=True)
    random.seed(3)
    ref_acc, ref_puzzles, ref_names = jax_trainer.validate_dataloader(
        JaxPieces(str(data), JaxPieces.Split.VAL))
    random.seed(3)
    acc, puzzles, names = trainer.validate_dataloader(PajigsawPieces(str(data), Split.VAL))
    assert names == ref_names and acc == ref_acc and 0.0 <= acc <= 1.0
    for p, q in zip(puzzles, ref_puzzles):
        assert sorted((x.original_piece_id, x.location) for x in p.pieces) == \
            sorted((x.original_piece_id, x.location) for x in q.pieces)
    assert len(trainer.puzzle_seconds) == 2 and "score" in trainer.puzzle_seconds[0]


def test_cli_runs_every_mode(tmp_path, data, monkeypatch):
    """train (6 updates of 4 pairs, a validate before and after, the MFU
    line), eval
    and test from the checkpoint (the reconstructions decode), throughput;
    and no run without a card unless asked for the CPU."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(CFG)
    out = tmp_path / "o"

    def argv(mode, tag, *extra):
        return ["--cfg", str(cfg), "--data-path", str(data), "--mode", mode,
                "--output", str(out), "--tag", tag, "--device", "cpu", *extra]

    trainer = pajigsaw.main(argv("train", "t", "--batch-size", "4"))
    assert trainer.step == 6
    run_dir = Path(trainer.config.OUTPUT)
    log = (run_dir / "log_rank0train.txt").read_text()
    assert log.count("Average_Results") == 2 and "Model FLOPs" in log
    ckpt = str(run_dir / "checkpoint.ckpt")
    loss = pajigsaw.main(argv("eval", "e", "--pretrained", ckpt))
    assert 0.0 <= loss <= 1.0
    acc, puzzles, names = pajigsaw.main(argv("test", "e", "--pretrained", ckpt))
    assert names == ["img0", "img1"] and 0.0 <= acc <= 1.0
    for name in names:
        with Image.open(run_dir.parent / "e" / "reconstructed" / f"{name}.jpg") as im:
            assert im.size[0] > 0
    assert pajigsaw.main(argv("throughput", "e")) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        pajigsaw.main([a for a in argv("eval", "e") if a not in ("--device", "cpu")])
