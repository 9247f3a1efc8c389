"""The DIV2K puzzle-pair slice of the port as a whole: a 4-class ViT-ED with
head_dim 32 (the 4-D attention route) against the JAX model on converted
parameters, a 5-step trajectory of the default supervised pair loss with
``bce_with_logits`` against the JAX package's ``make_train_step`` (the
harness of tests/test_torch_trajectory.py), and the command line
``python -m vit_ed_tpu_torch.main`` in its three modes on the CPU.

The JAX side runs its 4-D Pallas kernels in interpret mode under ``jax.jit``;
float32 logits are compared at 1e-4, the trajectory at that file's bounds.
"""

import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_trajectory import K, STEPS_PER_EPOCH, _jax_run, _port_run

import vit_ed_tpu.ops.attention as jattn
from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.train.losses import bce_with_logits as jax_bce_with_logits
from vit_ed_tpu_torch.main import DefaultTrainer, main, parse_option
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.ops import attention as tattn

# anchored to the repository: a test that changes the working directory
# may run before this file in the same process
ROOT = Path(__file__).resolve().parent.parent
CFG = str(ROOT / "configs" / "puzzle" / "div2k_erosion7_4bin_patch8_64.yaml")
KW = dict(embed_dim=64, num_heads=2, depth=1, c_depth=1, img_size=32,
          patch_size=8, num_classes=4)
SHRINK = ["MODEL.PJS.EMBED_DIM", "64", "MODEL.PJS.NUM_HEADS", "2",
          "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32"]
BATCH = 6


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


@pytest.fixture(scope="module")
def jax_params():
    params = jax.jit(JaxViTED(**KW, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 32, 32, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def _trainer(tmp_path, jax_params, drop_path="0.0"):
    args = types.SimpleNamespace(
        cfg=CFG, device="cpu", mode="train", batch_size=BATCH, disable_amp=True,
        output=str(tmp_path), tag="t",
        opts=SHRINK + ["MODEL.DROP_PATH_RATE", drop_path, "TRAIN.EPOCHS", "2",
                       "TRAIN.WARMUP_EPOCHS", "0.4", "TRAIN.BASE_LR", "2e-2",
                       "TRAIN.WARMUP_LR", "1e-3", "TRAIN.MIN_LR", "1e-4",
                       "TRAIN.AUTO_RESUME", "False"])
    trainer = DefaultTrainer(args)
    load_jax_params(trainer.model, jax_params)
    trainer.setup_training(STEPS_PER_EPOCH)
    return trainer


def test_logits_match_jax_model(tmp_path, jax_params):
    """Stacked pairs [B, 2, H, W, 3] through both models (12-token streams,
    head_dim 32: the 4-D kernels on the JAX side)."""
    x = np.random.default_rng(0).normal(size=(3, 2, 32, 32, 3)).astype(np.float32)
    jm = JaxViTED(**KW, use_pallas=True)
    ref = np.asarray(jax.jit(lambda p, a: jm.apply({"params": p}, a))(
        jax_params, jnp.asarray(x)))
    model = _trainer(tmp_path, jax_params).model
    assert model.num_heads == 2 and model.embed_dim // model.num_heads == 32
    with torch.no_grad():
        out = model.eval()(torch.from_numpy(x))
    assert tuple(out.shape) == ref.shape == (3, 4)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_config_path_does_not_depend_on_the_working_directory(tmp_path, monkeypatch,
                                                              jax_params):
    """From another working directory (tests/test_entries.py changes it and
    does not change it back; under ``--dist loadfile`` this file may run
    after it in the same worker) the config and a trainer still build."""
    from vit_ed_tpu_torch.config import get_config

    monkeypatch.chdir(tmp_path)
    config = get_config(types.SimpleNamespace(cfg=CFG, opts=SHRINK))
    assert config.MODEL.NAME == "div2k_erosion7_4bin_patch8_64"
    assert config.DATA.DATASET == "div2k" and config.DATA.IMG_SIZE == 32
    trainer = _trainer(tmp_path, jax_params)
    assert trainer.model.num_heads == 2 and trainer.config.MODEL.NUM_CLASSES == 4


def test_training_forward_on_a_stacked_pair():
    """``ViTED.forward`` on [B, 2, H, W, 3] in training mode at 4 classes:
    the CLS short-circuit, and DropPath drawing from the seeded generator
    (two runs from one seed agree and differ from the eval logits)."""
    from vit_ed_tpu_torch.models.vit_ed import ViTED

    torch.manual_seed(0)
    model = ViTED(**{**KW, "depth": 2, "c_depth": 2}, drop_path_rate=0.5)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(16, 2, 32, 32, 3)).astype(np.float32))
    with torch.no_grad():
        ref = model.eval()(x)
        model.cls_shortcut = False
        np.testing.assert_allclose(model(x).numpy(), ref.numpy(), atol=1e-5)
        model.cls_shortcut = True
    model.train()
    runs = []
    for _ in range(2):
        model.seed_drop_path(5)
        runs.append(model(x))
    assert tuple(runs[0].shape) == (16, 4) and runs[0].requires_grad
    assert torch.equal(runs[0], runs[1])
    assert not torch.allclose(runs[0], ref, atol=1e-4)
    runs[0].sum().backward()
    assert all(p.grad is not None for p in model.parameters())


def test_default_pair_loss_trajectory_tracks_jax(tmp_path, jax_params):
    trainer = _trainer(tmp_path, jax_params)
    rng = np.random.default_rng(1)
    batches = []
    for _ in range(K):
        bins = rng.integers(0, 5, size=BATCH)          # 4 = a negative
        batches.append(trainer.prepare_data(
            rng.normal(size=(BATCH, 2, 32, 32, 3)).astype(np.float32),
            np.eye(5, dtype=np.float32)[bins][:, :4]))
    ref_losses, ref_norms, state = _jax_run(
        trainer.config, jax_params, batches, 1, kw=KW,
        criterion=jax_bce_with_logits)
    before = dict(tattn.launches)
    losses, norms = _port_run(trainer, batches, 1)
    assert tattn.launches == before                    # CPU: plain versions only

    assert len(losses) == len(ref_losses) == K and trainer.step == K
    assert abs(losses[0] - ref_losses[0]) < 1e-5
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(norms[:2], ref_norms[:2], rtol=1e-5)
    np.testing.assert_allclose(norms, ref_norms, rtol=2e-2)
    assert abs(ref_losses[-1] - ref_losses[0]) > 1e-5      # the loss moved
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    got = trainer.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-3, err_msg=name)


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("div2k_cli")
    rng = np.random.default_rng(0)
    for sub, n in (("DIV2K_train_HR", 8), ("DIV2K_valid_HR", 3)):
        (root / sub).mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (110, 120, 3), dtype=np.uint8)
                            ).save(root / sub / f"{i:04d}.png")
    return root


def _argv(root, mode, *extra, tag="cli"):
    return ["--cfg", CFG, "--data-path", str(root), "--mode", mode,
            "--output", str(root / "out"), "--tag", tag, "--device", "cpu",
            "--batch-size", "8", *extra, "--opts", *SHRINK,
            "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2",
            "DATA.NUM_WORKERS", "2"]


def test_cli_trains_evaluates_and_times(div2k_root):
    """One epoch on the CPU in bf16: 8 images x repeat 5 / batch 8 = 5
    updates with a validate before and after (3 images x repeat 10 = 30
    pairs in 4 batches); then ``--mode eval`` from the checkpoint and
    ``--mode throughput`` with a profiler trace."""
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    trainer = main(_argv(div2k_root, "train"))
    assert trainer.step == 5 and trainer.model.dtype == torch.bfloat16
    assert len(trainer.get_dataloader("train")) == 5
    assert len(trainer.get_dataloader("validation")) == 4
    run_dir = trainer.config.OUTPUT
    for name in ("checkpoint.ckpt", "best_model.ckpt"):
        assert os.path.isfile(os.path.join(run_dir, name)), name
    tree = load_checkpoint(os.path.join(run_dir, "checkpoint.ckpt"))
    assert tree["step"] == 5 and tree["epoch"] == 0
    log = Path(run_dir, "log_rank0train.txt").read_text()
    assert log.count("Overall: Time") == 2 and "Train: [0/1][4/5]" in log
    overall = [l for l in log.splitlines() if "Overall:" in l][-1]
    for key in ("Loss", "ACC", "F1", "Precision", "Recall"):
        assert f"\t{key} " in overall
    assert 0.0 <= trainer.val_metrics["acc"] <= 100.0
    assert 0.0 <= trainer.val_metrics["f1"] <= 1.0

    # eval under another tag: as in the JAX entry a run directory's own
    # checkpoint is resumed by train only and keeps --pretrained from loading
    eval_argv = _argv(div2k_root, "eval", "--pretrained",
                      os.path.join(run_dir, "checkpoint.ckpt"), tag="cli_eval")
    loss = main(eval_argv)
    assert 0.0 < loss < 2.0
    eval_dir = os.path.join(os.path.dirname(run_dir), "cli_eval")
    assert "Overall: Time" in Path(eval_dir, "log_rank0eval.txt").read_text()
    loaded = DefaultTrainer(parse_option(eval_argv)).model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in tree["model"].items())

    prof = div2k_root / "prof"
    rate = main(_argv(div2k_root, "throughput", tag="cli_eval")
                + ["TPU.PROFILE_DIR", str(prof)])
    assert rate > 0 and (prof / "throughput.json").is_file()
    assert "batch_size 8 throughput" in Path(
        eval_dir, "log_rank0throughput.txt").read_text()


def test_cli_raises_without_a_card(monkeypatch, div2k_root):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _argv(div2k_root, "train") if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(argv)
