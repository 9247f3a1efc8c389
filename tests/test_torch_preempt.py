"""The port's preemption guard (``vit_ed_tpu_torch/utils/preempt.py``) and
mid-epoch exact-step resume, the twins of tests/test_preempt.py; and the
trainer's model-FLOP count and MFU line (``utils/flops.py``)."""

import os
import signal
import types
from pathlib import Path

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parent.parent
CFG = str(ROOT / "configs" / "puzzle" / "div2k_erosion7_4bin_patch8_64.yaml")


def test_guard_real_sigterm_roundtrip():
    """A real SIGTERM sets the flag instead of ending the process, and
    uninstall puts the previous handler back."""
    from vit_ed_tpu_torch.utils.preempt import PreemptionGuard

    before = signal.getsignal(signal.SIGTERM)
    guard = PreemptionGuard(check_freq=1).install()
    try:
        assert not guard.preempted_locally
        os.kill(os.getpid(), signal.SIGTERM)
        assert guard.preempted_locally
        assert guard.should_stop(0)
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before


def test_guard_check_freq_cadence():
    """Steps off the cadence answer False even when flagged."""
    from vit_ed_tpu_torch.utils.preempt import PreemptionGuard

    guard = PreemptionGuard(check_freq=4)   # not installed: no handler
    guard.signal()
    assert [guard.should_stop(s) for s in range(1, 9)] == [
        False, False, False, True, False, False, False, True]


@pytest.fixture(scope="module")
def div2k(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k_preempt")
    rng = np.random.default_rng(0)
    for sub in ("DIV2K_train_HR", "DIV2K_valid_HR"):
        os.makedirs(root / sub)
        for i in range(4 if sub.endswith("train_HR") else 1):
            Image.fromarray(rng.integers(0, 256, (110, 120, 3), dtype=np.uint8)
                            ).save(root / sub / f"{i:04d}.png")
    return root


def _run(root, tag, preempt_after=None):
    """One ``train()`` of the port's DIV2K trainer (3 epochs of 4 images x
    repeat 5 / batch 2 = 10 updates), recording the learning rate of every
    update it applies; with ``preempt_after`` the guard trips after that
    many updates (in all), the deterministic equivalent of a SIGTERM."""
    from vit_ed_tpu_torch.main import DefaultTrainer, parse_option

    lrs = []

    class Recording(DefaultTrainer):
        def train_step(self, micro_batches):
            lrs.append(self.schedule(self.step))
            out = super().train_step(micro_batches)
            if preempt_after is not None and self.step == preempt_after:
                self._preempt.signal()
            return out

    trainer = Recording(parse_option([
        "--cfg", CFG, "--data-path", str(root), "--mode", "train", "--output",
        str(root / "out"), "--tag", tag, "--device", "cpu", "--disable_amp",
        "--batch-size", "2", "--opts", "MODEL.PJS.EMBED_DIM", "32",
        "MODEL.PJS.NUM_HEADS", "2", "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH",
        "1", "DATA.IMG_SIZE", "32", "MODEL.PJS.PATCH_SIZE", "16",
        "DATA.NUM_WORKERS", "0", "TRAIN.EPOCHS", "3", "TRAIN.WARMUP_EPOCHS", "1",
        "PRINT_FREQ", "1", "SAVE_FREQ", "100"]))
    return trainer.train(), lrs


@pytest.mark.parametrize("preempt_after", [1, 13])
def test_preempted_training_saves_and_resumes(div2k, preempt_after):
    """Preempted after update 1 (epoch 0) or 13 (epoch 1, its 3rd update):
    a mid-epoch checkpoint, a clean return with the previous SIGTERM handler
    back; a fresh trainer in the same directory resumes the SAME epoch after
    the updates it applied and ends with an uninterrupted run's update count
    (10 per epoch x 3), each update at the uninterrupted run's learning
    rate."""
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    full, full_lrs = _run(div2k, f"full{preempt_after}")
    assert full.step == 30 and len(full_lrs) == 30 and not full.preempted
    log = Path(full.config.OUTPUT, "log_rank0train.txt").read_text()
    assert log.count("model-FLOP MFU not computed") == 3      # one per epoch

    tag = f"cut{preempt_after}"
    before = signal.getsignal(signal.SIGTERM)
    cut, lrs = _run(div2k, tag, preempt_after)
    assert cut.preempted and cut.step == preempt_after
    assert signal.getsignal(signal.SIGTERM) is before
    tree = load_checkpoint(os.path.join(cut.config.OUTPUT, "checkpoint.ckpt"))
    epoch, skip = divmod(preempt_after, 10)
    assert tree["in_epoch_opt_steps"] == skip and tree["epoch"] == epoch
    assert tree["step"] == preempt_after
    assert not os.path.exists(os.path.join(cut.config.OUTPUT, "best_model.ckpt")) \
        or preempt_after > 10

    resumed, more = _run(div2k, tag)
    assert resumed.config.MODEL.RESUME and not resumed.preempted
    assert resumed.start_epoch == epoch
    assert resumed._resume_skip_opt_steps == skip
    assert resumed.step == 30
    assert lrs + more == full_lrs
    log = Path(resumed.config.OUTPUT, "log_rank0train.txt").read_text()
    assert f"continuing from optimizer step {skip}" in log


def test_checkpoint_without_the_key_resumes_at_the_next_epoch(div2k):
    """A checkpoint written before mid-epoch saves (no
    ``in_epoch_opt_steps``) resumes at the epoch after its own."""
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    done, _ = _run(div2k, "old")
    path = os.path.join(done.config.OUTPUT, "checkpoint.ckpt")
    tree = load_checkpoint(path)
    del tree["in_epoch_opt_steps"]
    tree["epoch"] = 1
    torch.save(tree, path)
    for f in os.listdir(done.config.OUTPUT):
        if f.startswith("best_model"):
            os.unlink(os.path.join(done.config.OUTPUT, f))
    resumed, more = _run(div2k, "old")
    assert resumed.start_epoch == 2 and resumed._resume_skip_opt_steps == 0
    assert len(more) == 10 and resumed.step == 40


# ------------------------------------------------------------------- FLOPs
@pytest.mark.parametrize("cls_shortcut", [True, False])
def test_model_flops_equal_the_flop_counter(cls_shortcut):
    """The analytic count against ``FlopCounterMode`` on the plain CPU loss
    of mined pairs (encode, prepare_x2, gathers, decoder, head): the
    forward equal; the backward equal after adding the two products the
    plain CPU backward runs that are not model FLOPs: the attention
    backward's recomputed Q K^T (one per attention) and the pair gather's
    one-hot products."""
    from vit_ed_tpu_torch.models.vit_ed import ViTED
    from vit_ed_tpu_torch.ops.gather import gather_rows
    from vit_ed_tpu_torch.utils.flops import pjs_step_flops

    torch.manual_seed(0)
    c, depth, c_depth = 32, 2, 3
    m = ViTED(img_size=48, patch_size=16, num_classes=2, embed_dim=c, depth=depth,
              c_depth=c_depth, num_heads=2, cls_shortcut=cls_shortcut)
    b, s_e = 4, 9
    s_d = s_e + 1
    gi = torch.tensor([0, 1, 2, 3, 0, 1, 3])
    gj = torch.tensor([1, 2, 3, 0, 2, 2, 3])
    p = len(gi)
    x = torch.randn(b, 48, 48, 3)
    with FlopCounterMode(display=False) as fwd:
        logits = m.score_tokens(gather_rows(m.encode(x), gj),
                                gather_rows(m.prepare_x2(x), gi))
    with FlopCounterMode(display=False) as bwd:
        logits.square().sum().backward()
    forward, backward = pjs_step_flops(m, b, p)
    assert fwd.get_total_flops() == forward
    n_full = c_depth - (1 if cls_shortcut else 0)
    recompute = (b * depth * 2 * s_e * s_e * c
                 + p * n_full * 2 * (s_d * s_d + s_d * s_e) * c
                 + (p * 2 * (s_d + s_e) * c if cls_shortcut else 0))
    gathers = 2 * b * p * (s_e + s_d) * c
    assert bwd.get_total_flops() == backward + recompute + gathers
    # the stacked-pair forward (DIV2K, Geshaem): one pair per image
    with FlopCounterMode(display=False) as pairs:
        m(torch.randn(3, 2, 48, 48, 3))
    assert pairs.get_total_flops() == pjs_step_flops(m, 3, 3)[0]


def _mfu_line(monkeypatch, device_name, device="cuda", dtype=torch.bfloat16,
              configured=0.0):
    from vit_ed_tpu_torch.train.engine import Trainer

    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: device_name)
    lines = []
    stub = types.SimpleNamespace(
        device=torch.device(device), model=types.SimpleNamespace(dtype=dtype),
        config=types.SimpleNamespace(TPU=types.SimpleNamespace(PEAK_TFLOPS=configured)),
        logger=types.SimpleNamespace(info=lines.append))
    out = Trainer._log_mfu(stub, 0.1, 4.947e13, "pjs")    # 494.7 TF/s
    assert lines == [out]
    return out


def test_mfu_line_reads_the_cards_peak(monkeypatch):
    """989.4 TF/s dense bf16 for "NVIDIA H100 80GB HBM3" (50.0% here); an
    unknown card, f32 compute or the CPU print no percentage; a configured
    TPU.PEAK_TFLOPS wins; no TPU figure is a default."""
    from vit_ed_tpu_torch.config import default_config
    from vit_ed_tpu_torch.utils.flops import BF16_DENSE_PEAK_TFLOPS

    line = _mfu_line(monkeypatch, "NVIDIA H100 80GB HBM3")
    assert "494.70 TF/s" in line
    assert "50.0% model-FLOP MFU of NVIDIA H100 80GB HBM3 989.4 TF/s" in line
    assert "counted from the pjs geometry" in line
    for args in (("Some Other GPU",), ("NVIDIA H100 80GB HBM3", "cuda", torch.float32),
                 ("NVIDIA H100 80GB HBM3", "cpu")):
        line = _mfu_line(monkeypatch, *args)
        assert "%" not in line and "unknown" in line and "494.70 TF/s" in line
    line = _mfu_line(monkeypatch, "Some Other GPU", configured=1000.0)
    assert "49.5% model-FLOP MFU of Some Other GPU 1000.0 TF/s" in line
    assert default_config().TPU.PEAK_TFLOPS == 0.0
    assert BF16_DENSE_PEAK_TFLOPS == {"NVIDIA H100 80GB HBM3": 989.4}
