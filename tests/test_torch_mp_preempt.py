"""Two ranks of the port (gloo, on the CPU) that lose one of them: a SIGTERM
to one rank of a DIV2K training, a crash in the middle of a pair scan, and
the entries that refuse several processes.

- SIGTERM to rank 1 only: both ranks save at the same update and exit 0
  (the guard's agreement, ``utils/preempt.py``); the rerun continues that
  epoch and ends at an uninterrupted run's update count, every update at
  that run's learning rate.
- Rank 1 dies after its first row block of a scan (``os._exit`` at its
  second block, so the crash is deterministic); the survivor fails in the
  merge or, past a short group timeout, is killed by the test. The rerun
  scores no block that has a file, and its matrix equals an uninterrupted
  run's bit for bit.
- On two ranks a BatchNorm type, MoE and ``hisfrag_vit`` build their
  trainers (their statistics and losses are the global batch's:
  tests/test_torch_mp_coupled.py), while ``lr_finder`` raises, saying why,
  and SEQ_PARALLEL on a ``[1, 2]`` mesh raises naming A12b part 2; an entry without a multi-process
  path raises under ``WORLD_SIZE`` 2.

Run as ``python tests/test_torch_mp_preempt.py <outdir> scan|refuse``, the
file is the worker of the last two.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import numpy as np
import pytest
import torch
from PIL import Image

from test_torch_multiprocess import launch

ROOT = Path(__file__).resolve().parent.parent
CFG = str(ROOT / "configs" / "puzzle" / "div2k_erosion7_4bin_patch8_64.yaml")
HISFRAG_CFG = str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml")
TINY = ["MODEL.PJS.EMBED_DIM", "32", "MODEL.PJS.NUM_HEADS", "2",
        "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32",
        "MODEL.PJS.PATCH_SIZE", "16", "DATA.NUM_WORKERS", "0"]
N_SCAN, SCAN_BATCH = 12, 2
EPOCHS, UPDATES_PER_EPOCH = 4, 5   # 4 images x repeat 5 / 2 ranks / batch 2


# ------------------------------------------------------------------ workers
def _scan_worker(outdir):
    """Score N_SCAN images on this rank's rows into ``outdir`` (block files
    there) and save the merged matrix and the blocks this run scored;
    ``MP_CRASH`` makes the rank exit at its second block."""
    from vit_ed_tpu_torch.models.vit_ed import ViTED
    from vit_ed_tpu_torch.parallel import mesh
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    mesh.maybe_init_distributed(backend="gloo", timeout=10)
    rank = mesh.process_index()
    torch.manual_seed(0)
    model = ViTED(img_size=32, patch_size=16, embed_dim=32, depth=1, c_depth=1,
                  num_heads=2, num_classes=1)
    scored = []

    class Counting(PairwiseScorer):
        def score_rows_block(self, kv_block, tokens, rows_cols):
            if os.environ.get("MP_CRASH") and len(scored) == 1:
                os._exit(17)
            scored.append(len(rows_cols))
            return super().score_rows_block(kv_block, tokens, rows_cols)

    imgs = np.random.default_rng(0).normal(size=(N_SCAN, 32, 32, 3)).astype(np.float32)

    class DS:
        def __getitem__(self, i):
            return imgs[i], i

        def __len__(self):
            return N_SCAN

    sim = Counting(model, num_outputs=1, pair_chunk=8).score_dataset(
        DS(), batch_size=SCAN_BATCH, out_dir=outdir, tag="resume", num_workers=0,
        rank=rank, world_size=2)
    np.save(os.path.join(outdir, f"rank{rank}_sim.npy"), sim)
    np.save(os.path.join(outdir, f"rank{rank}_scored.npy"), np.asarray(scored))


def _refuse_worker(outdir):
    """Each trainer's construction on two ranks: None where it builds, the
    message it raises with where it refuses."""
    from vit_ed_tpu_torch import hisfrag_vit, lr_finder, main
    from vit_ed_tpu_torch.parallel import mesh

    mesh.maybe_init_distributed(backend="gloo", timeout=30)
    rank = mesh.process_index()
    common = ["--device", "cpu", "--output", os.path.join(outdir, "o"),
              "--tag", f"r{rank}"]
    vit = ["MODEL.TYPE", "vit", "MODEL.VIT.EMBED_DIM", "32", "MODEL.VIT.NUM_HEADS", "2",
           "MODEL.VIT.DEPTH", "1", "DATA.IMG_SIZE", "32"]
    cases = {
        "resnet": (main, ["--cfg", CFG, "--opts", "MODEL.TYPE", "resnet",
                          "MODEL.RES.ARCH", "resnet18"]),
        "moe": (main, ["--cfg", CFG, "--opts", *TINY, "MODEL.PJS.MOE.EXPERTS", "4"]),
        "hisfrag_vit": (hisfrag_vit, ["--cfg", HISFRAG_CFG, "--opts", *vit]),
        "lr_finder": (lr_finder, ["--cfg", CFG]),
        "mesh": (hisfrag_vit, ["--cfg", HISFRAG_CFG, "--opts", *vit, "TPU.MESH_SHAPE",
                               "[1, 2]", "TPU.SEQ_PARALLEL", "True"]),
    }
    said = {}
    for name, (entry, argv) in cases.items():
        cls = {main: main.DefaultTrainer, hisfrag_vit: hisfrag_vit.HisfragVitTrainer,
               lr_finder: lr_finder.LrFinderTrainer}[entry]
        try:
            cls(entry.parse_option(argv[:2] + common + argv[2:]))
            said[name] = None
        except NotImplementedError as e:
            said[name] = str(e)
    with open(os.path.join(outdir, f"refuse_rank{rank}.json"), "w") as f:
        json.dump(said, f)


# ------------------------------------------------------------------ helpers
def _finish(procs, timeout=120):
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outs


@pytest.fixture(scope="module")
def div2k(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k_mp")
    rng = np.random.default_rng(0)
    for sub in ("DIV2K_train_HR", "DIV2K_valid_HR"):
        os.makedirs(root / sub)
        for i in range(4 if sub.endswith("train_HR") else 1):
            Image.fromarray(rng.integers(0, 256, (110, 120, 3), dtype=np.uint8)
                            ).save(root / sub / f"{i:04d}.png")
    return root


def _train(root, tag):
    return launch(["-m", "vit_ed_tpu_torch.main", "--cfg", CFG, "--data-path",
                   str(root), "--mode", "train", "--output", str(root / "out"),
                   "--tag", tag, "--device", "cpu", "--disable_amp",
                   "--batch-size", "2", "--opts"] + TINY +
                  ["TRAIN.EPOCHS", str(EPOCHS), "TRAIN.WARMUP_EPOCHS", "1",
                   "PRINT_FREQ", "1", "SAVE_FREQ", "100"])


def _run_dir(root, tag):
    return root / "out" / "div2k_erosion7_4bin_patch8_64" / tag


def _updates(log):
    """(epoch, index, lr) of every ``Train:`` line of a log."""
    return re.findall(r"Train: \[(\d+)/\d+\]\[(\d+)/\d+\]\s+eta \S+ lr (\S+)", log)


# ------------------------------------------------------------------ tests
def test_sigterm_to_one_rank_agrees_and_resumes(div2k):
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    uninterrupted = _train(div2k, "full")     # runs beside the cut one
    procs = _train(div2k, "cut")
    cut = _run_dir(div2k, "cut")
    log1 = cut / "log_rank1train.txt"
    deadline = time.time() + 60
    while not (log1.exists() and "Train:" in log1.read_text()):
        assert all(p.poll() is None for p in procs), "a rank ended before its first update"
        assert time.time() < deadline, "no update within 60 s"
        time.sleep(0.02)
    procs[1].send_signal(signal.SIGTERM)     # one rank only
    _finish(procs)
    _finish(uninterrupted)
    full = _run_dir(div2k, "full")
    total = EPOCHS * UPDATES_PER_EPOCH
    assert load_checkpoint(str(full / "checkpoint.ckpt"))["step"] == total
    full_updates = _updates((full / "log_rank0train.txt").read_text())
    assert len(full_updates) == total
    said = [re.findall(r"Preempted during epoch (\d+) after optimizer step (\d+)",
                       (cut / f"log_rank{r}train.txt").read_text()) for r in range(2)]
    assert len(said[0]) == 1 and said[0] == said[1]
    epoch, skip = map(int, said[0][0])
    tree = load_checkpoint(str(cut / "checkpoint.ckpt"))
    assert (tree["epoch"], tree["in_epoch_opt_steps"]) == (epoch, skip)
    assert 0 < tree["step"] == epoch * UPDATES_PER_EPOCH + skip < total

    _finish(_train(div2k, "cut"))
    log0 = (cut / "log_rank0train.txt").read_text()
    assert f"continuing from optimizer step {skip}" in log0
    assert load_checkpoint(str(cut / "checkpoint.ckpt"))["step"] == total
    # the update on which the guard tripped is saved, not logged
    assert _updates(log0) == [u for u in full_updates
                              if (int(u[0]), int(u[1])) != (epoch, skip - 1)]


def test_crashed_scan_resumes_bit_equal(tmp_path):
    crash, clean = tmp_path / "crash", tmp_path / "clean"
    crash.mkdir()
    clean.mkdir()
    uninterrupted = launch([__file__, str(clean), "scan"])   # runs beside
    procs = launch([__file__, str(crash), "scan"], [{}, {"MP_CRASH": "1"}])
    out1 = procs[1].communicate(timeout=120)[0]
    assert procs[1].returncode == 17, out1[-3000:]
    try:   # the survivor fails in the merge, or is killed here
        procs[0].communicate(timeout=2)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()
    assert procs[0].returncode != 0
    done = sorted(p.name for p in crash.glob("resume_rank1_rows*.npz"))
    assert len(done) == 1, done

    _finish(launch([__file__, str(crash), "scan"]))
    _finish(uninterrupted)
    blocks = np.load(clean / "rank1_scored.npy")
    resumed = np.load(crash / "rank1_scored.npy")
    assert len(resumed) == len(blocks) - 1 and len(blocks) > 1
    for rank in range(2):
        np.testing.assert_array_equal(np.load(crash / f"rank{rank}_sim.npy"),
                                      np.load(clean / f"rank{rank}_sim.npy"))


def test_coupled_batches_refuse_two_ranks(tmp_path):
    _finish(launch([__file__, str(tmp_path), "refuse"]))
    for rank in range(2):
        said = json.loads((tmp_path / f"refuse_rank{rank}.json").read_text())
        assert set(said) == {"resnet", "moe", "hisfrag_vit", "lr_finder", "mesh"}
        # the coupled batches run on two ranks (SyncBN, the global aux
        # terms, the gathered mining); lr_finder says why it refuses
        assert said["resnet"] is None and said["moe"] is None and said["hisfrag_vit"] is None
        assert "no collective" in said["lr_finder"] and "one process" in said["lr_finder"]
        assert "item 12b" in said["mesh"]


def test_entry_without_processes_refuses_world(monkeypatch):
    from vit_ed_tpu_torch.device import resolve_device

    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="joins no process group"):
        resolve_device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert resolve_device("cpu").type == "cpu"


if __name__ == "__main__":
    {"scan": _scan_worker, "refuse": _refuse_worker}[sys.argv[2]](sys.argv[1])
