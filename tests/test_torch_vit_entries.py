"""The ViT embedding baselines as entries: ``python -m
vit_ed_tpu_torch.main_vit`` and ``python -m vit_ed_tpu_torch.hisfrag_vit``
against the root ``main_vit.py`` / ``hisfrag_vit.py`` of the JAX package on
the CPU, on the same weights (the JAX trainer's, converted) and data:

- main_vit's first 3 updates of the directional triplet loss against the
  JAX package's ``make_train_step`` with the JAX entry's loss (the harness
  of tests/test_torch_trajectory.py), DropPath 0, f32: losses relative
  1e-4;
- main_vit ``testing()`` on a 3 x 3 puzzle per subset: the same distance
  tensor (relative 1e-4; inf on the diagonal), the same placements and the
  same ``Average_Results`` lines;
- hisfrag_vit ``validate``: the same mAP, Top-1 and Pr@k;
- both CLIs in every mode on the CPU (the MFU line of a ViT run counts the
  ViT's own model FLOPs), and neither runs without a card unless asked for
  the CPU.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
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
from test_torch_trajectory import STEPS_PER_EPOCH, _jax_run, _port_run

from vit_ed_tpu_torch import hisfrag_vit, main_vit
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict
from vit_ed_tpu_torch.ops import attention as tattn
from vit_ed_tpu_torch.utils.flops import vit_step_flops

# anchored to the repository: a test that changes the working directory
# may run before this file in the same process
ROOT = Path(__file__).resolve().parent.parent
VIT_CFG = str(ROOT / "configs" / "puzzle" / "vit_div2k_erosion7_4bin_patch8_64.yaml")
HISFRAG_CFG = str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml")
VIT_SHRINK = ["MODEL.VIT.EMBED_DIM", "64", "MODEL.VIT.NUM_HEADS", "2",
              "MODEL.VIT.DEPTH", "2", "DATA.IMG_SIZE", "32", "MODEL.NUM_CLASSES", "24",
              "MODEL.DROP_PATH_RATE", "0.0"]
HISFRAG_SHRINK = ["MODEL.TYPE", "vit", "MODEL.NUM_CLASSES", "24", "MODEL.VIT.EMBED_DIM",
                  "128", "MODEL.VIT.NUM_HEADS", "2", "MODEL.VIT.PATCH_SIZE", "16",
                  "MODEL.VIT.DEPTH", "1", "DATA.IMG_SIZE", "64", "DATA.NUM_WORKERS", "2"]


def _args(cfg, opts, data, out, mode="train", **kw):
    return types.SimpleNamespace(
        cfg=cfg, opts=opts, data_path=str(data), output=str(out), tag="t", mode=mode,
        device="cpu", disable_amp=True, batch_size=kw.pop("batch_size", None),
        pretrained=None, resume=None, accumulation_steps=None, use_checkpoint=False,
        optim=None, eval_n_items_per_category=5, **kw)


class Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _listen(logger):
    lines = Lines()
    logger.addHandler(lines)
    return lines


def _port_params(jax_trainer):
    return jax_params_to_state_dict(jax.tree.map(np.asarray, jax.device_get(
        jax_trainer.params)))


def _smooth(path, seed, h, w, quality=None):
    small = np.random.default_rng(seed).integers(0, 256, (6, 6, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((w, h), Image.BICUBIC)
    img.save(path, **({"quality": quality} if quality else {}))


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DIV2K tree, one 3 x 3 puzzle per subset, and a HisFrag tree (30
    writers x 3 fragments in train/: 27 train writers, 3 val; 4 x 3 in
    test/)."""
    root = tmp_path_factory.mktemp("vit_entries")
    for sub, n in (("DIV2K_train_HR", 8), ("DIV2K_valid_HR", 3)):
        os.makedirs(root / "div2k" / sub)
        for i in range(n):
            _smooth(root / "div2k" / sub / f"{i:04d}.png", i, 110 + i, 120)
    for k, subset in enumerate(("Cho", "McGill", "BGU")):
        os.makedirs(root / "puzzles" / subset)
        _smooth(root / "puzzles" / subset / ("0.jpg" if k == 2 else "0.png"), 10 + k,
                98, 96, quality=92 if k == 2 else None)
    for sub, writers in (("train", 30), ("test", 4)):
        os.makedirs(root / "hisfrag" / sub)
        for w in range(writers):
            for f in range(3):
                _smooth(root / "hisfrag" / sub / f"w{w:03d}_0_{f}.jpg", 100 * w + f,
                        80 + 4 * f, 90, quality=90)
    return root


def test_triplet_trajectory_tracks_jax(tmp_path, trees):
    from main_vit import VitTripletTrainer as JaxVitTripletTrainer

    from vit_ed_tpu.models.build import build_model as jax_build_model

    opts = VIT_SHRINK + ["TRAIN.EPOCHS", "2", "TRAIN.WARMUP_EPOCHS", "0.4",
                         "TRAIN.BASE_LR", "2e-2", "TRAIN.WARMUP_LR", "1e-3",
                         "TRAIN.MIN_LR", "1e-4", "TRAIN.AUTO_RESUME", "False"]
    jax_trainer = JaxVitTripletTrainer(_args(VIT_CFG, opts, trees / "div2k", tmp_path / "j",
                                             batch_size=3))
    trainer = main_vit.VitTripletTrainer(_args(VIT_CFG, opts, trees / "div2k",
                                               tmp_path / "p", batch_size=3))
    trainer.model.load_state_dict(_port_params(jax_trainer), strict=True)
    trainer.setup_training(STEPS_PER_EPOCH)
    rng = np.random.default_rng(5)
    batches = [trainer.prepare_data(
        rng.normal(size=(3, 4, 3, 32, 32, 3)).astype(np.float32),
        np.arange(3, dtype=np.int32)) for _ in range(3)]
    ref_losses, ref_norms, _ = _jax_run(
        trainer.config, jax.device_get(jax_trainer.params), batches, 1,
        model=jax_build_model(jax_trainer.config),
        loss_fn=JaxVitTripletTrainer.make_loss_fn(None, None))
    before = dict(tattn.launches)
    losses, norms = _port_run(trainer, batches, 1)
    assert tattn.launches == before                    # CPU: plain versions only
    assert trainer.step == 3 and all(v > 0 for v in ref_losses)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4, atol=0)
    np.testing.assert_allclose(norms[0], ref_norms[0], rtol=1e-5)
    assert abs(ref_losses[-1] - ref_losses[0]) > 1e-5      # the loss moved


def test_testing_matches_the_jax_entry(tmp_path, trees, monkeypatch):
    import main_vit as jax_main_vit

    opts = VIT_SHRINK + ["DATA.BATCH_SIZE", "16", "DATA.NUM_WORKERS", "2"]
    solved = []
    inner = jax_main_vit.paikin_tal_driver

    def record(*a, **k):
        solved.append((k["distances"], inner(*a, **k)))
        return solved[-1][1]

    monkeypatch.setattr(jax_main_vit, "paikin_tal_driver", record)
    jax_trainer = jax_main_vit.VitTripletTrainer(
        _args(VIT_CFG, opts, trees / "puzzles", tmp_path / "j", mode="test"))
    jax_lines = _listen(jax_trainer.logger)
    os.makedirs(tmp_path / "jax")
    monkeypatch.chdir(tmp_path / "jax")
    random.seed(0)
    jax_trainer.testing()

    trainer = main_vit.VitTripletTrainer(
        _args(VIT_CFG, opts, trees / "puzzles", tmp_path / "p", mode="test"))
    trainer.model.load_state_dict(_port_params(jax_trainer), strict=True)
    lines = _listen(trainer.logger)
    os.makedirs(tmp_path / "port")
    monkeypatch.chdir(tmp_path / "port")
    random.seed(0)
    records = trainer.testing()

    assert [r["subset"] for r in records] == ["Cho", "McGill", "BGU"]
    assert len(solved) == 3
    for (ref_d, ref_puzzle), rec in zip(solved, records):
        d = rec["distances"]
        assert d.shape == ref_d.shape == (4, 9, 9)
        fin = np.isfinite(ref_d)
        assert (np.isfinite(d) == fin).all() and fin.sum() == 4 * 72
        np.testing.assert_allclose(d[fin], ref_d[fin], rtol=1e-4, atol=1e-3)
        assert sorted((p.original_piece_id, p.location) for p in rec["puzzle"].pieces) == \
            sorted((p.original_piece_id, p.location) for p in ref_puzzle.pieces)
    jax_avg = [m for m in jax_lines.lines if m.startswith("Average_Results")]
    avg = [m for m in lines.lines if m.startswith("Average_Results")]
    assert len(jax_avg) == 3 and avg == jax_avg
    for sub, name in (("Cho", "0.png"), ("BGU", "0.jpg")):
        assert (tmp_path / "port" / "output" / "reconstructed" / sub / name).is_file()


def test_hisfrag_validate_matches_jax(tmp_path, trees):
    from hisfrag_vit import HisfragVitTrainer as JaxHisfragVitTrainer

    opts = HISFRAG_SHRINK + ["DATA.BATCH_SIZE", "8", "DATA.TEST_BATCH_SIZE", "5"]
    jax_trainer = JaxHisfragVitTrainer(_args(HISFRAG_CFG, opts, trees / "hisfrag",
                                             tmp_path / "j", mode="eval"))
    ref = jax_trainer.validate_dataloader(jax_trainer.get_dataloader("val"))
    trainer = hisfrag_vit.HisfragVitTrainer(_args(HISFRAG_CFG, opts, trees / "hisfrag",
                                                  tmp_path / "p", mode="eval"))
    assert trainer.model.num_heads == 2 and trainer.model.embed_dim == 128
    trainer.model.load_state_dict(_port_params(jax_trainer), strict=True)
    metrics, dm, labels = trainer.validate_dataloader(trainer.get_dataloader("val"))
    assert dm.shape == (9, 9) and dm.dtype == np.float32 and len(np.unique(labels)) == 3
    assert all(0.0 <= float(m) <= 1.0 for m in metrics)
    np.testing.assert_allclose(np.asarray(metrics, np.float64),
                               np.asarray(ref, np.float64), atol=1e-6, rtol=0)


def _mfu_gflops(log):
    line = [m for m in log.read_text().splitlines() if "Model FLOPs" in m][-1]
    assert "counted from the vit geometry" in line
    return float(line.split("Model FLOPs: ", 1)[1].split(" GF/update", 1)[0])


def test_main_vit_cli_runs_every_mode(tmp_path, trees, monkeypatch):
    """train (5 updates of 8 items, a validate before and after, the MFU
    line of the ViT count: 8 x 12 images per update), eval from the
    checkpoint, throughput (8 items x 12 images per forward), test; and no
    run without a card unless asked for the CPU."""
    out = tmp_path / "o"
    monkeypatch.chdir(tmp_path)

    def argv(mode, data, tag, *extra):
        return ["--cfg", VIT_CFG, "--data-path", str(data), "--mode", mode,
                "--output", str(out), "--tag", tag, "--device", "cpu",
                "--batch-size", "8", *extra, "--opts", *VIT_SHRINK,
                "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "1",
                "DATA.NUM_WORKERS", "2"]

    trainer = main_vit.main(argv("train", trees / "div2k", "t"))
    assert trainer.step == 5 and trainer.model.dtype == torch.bfloat16
    run_dir = Path(trainer.config.OUTPUT)
    assert (run_dir / "checkpoint.ckpt").is_file() and (run_dir / "best_model.ckpt").is_file()
    log = run_dir / "log_rank0train.txt"
    assert log.read_text().count("Overall: Time") == 2
    assert _mfu_gflops(log) == round(sum(vit_step_flops(trainer.model, 8 * 12)) / 1e9, 3)
    loss = main_vit.main(argv("eval", trees / "div2k", "e", "--pretrained",
                              str(run_dir / "checkpoint.ckpt")))
    assert 0.0 <= loss < 1.0
    rate = main_vit.main(argv("throughput", trees / "div2k", "e"))
    assert rate > 0
    assert "batch_size 96 throughput" in (out / run_dir.parent.name / "e" /
                                          "log_rank0throughput.txt").read_text()
    records = main_vit.main(argv("test", trees / "puzzles", "e"))
    assert len(records) == 3 and all(np.isfinite(r["distances"]).sum() == 4 * 72
                                     for r in records)
    assert (tmp_path / "output" / "reconstructed" / "McGill" / "0.png").is_file()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        main_vit.main([a for a in argv("eval", trees / "div2k", "e") if a != "--device"
                       and a != "cpu"])


def test_hisfrag_vit_cli_runs_every_mode(tmp_path, trees, monkeypatch):
    """train (81 fragments x repeat 3 / batch 9 = 27 updates, u8 on the wire
    off), eval, test, throughput; and no run without a card unless asked
    for the CPU."""
    out = tmp_path / "o"

    def argv(mode, tag, *extra):
        return ["--cfg", HISFRAG_CFG, "--data-path", str(trees / "hisfrag"), "--mode",
                mode, "--output", str(out), "--tag", tag, "--device", "cpu",
                "--batch-size", "9", *extra, "--opts", *HISFRAG_SHRINK,
                "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "4"]

    trainer = hisfrag_vit.main(argv("train", "t"))
    assert trainer.step == 27
    log = Path(trainer.config.OUTPUT) / "log_rank0train.txt"
    assert log.read_text().count("Validation results: mAP") == 2
    assert _mfu_gflops(log) == round(sum(vit_step_flops(trainer.model, 9)) / 1e9, 3)
    ckpt = str(Path(trainer.config.OUTPUT) / "checkpoint.ckpt")
    assert 0.0 <= hisfrag_vit.main(argv("eval", "e", "--pretrained", ckpt)) <= 1.0
    metrics, dm, labels = hisfrag_vit.main(argv("test", "e", "--pretrained", ckpt))
    assert dm.shape == (12, 12) and all(0.0 <= float(m) <= 1.0 for m in metrics)
    assert np.array_equal(dm, dm.T)
    assert hisfrag_vit.main(argv("throughput", "e")) > 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        hisfrag_vit.main([a for a in argv("eval", "e") if a not in ("--device", "cpu")])
