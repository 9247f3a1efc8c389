"""``python -m vit_ed_tpu_torch.lr_finder`` against the root
``lr_finder.py`` of the JAX package on the CPU: the tiny DIV2K and model of
tests/test_entries.py's lr_finder test (head_dim 16, the smallest the port
runs), the JAX trainer's weights converted, DropPath 0. Both draw the same
items (the same seeds, the same loader order), so the smoothed losses of
the sweep and the suggestion must agree: the losses within 1e-4 relative,
the suggestion exactly (the same index of the same rates). Then the CLI,
which logs whether the plot was written or skipped, and no run without a
card unless asked for the CPU.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import os
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from vit_ed_tpu_torch import lr_finder
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict

CFG = """
MODEL:
  TYPE: pjs
  NAME: tiny_lrfind
  NUM_CLASSES: 4
  DROP_PATH_RATE: 0.0
  PJS:
    EMBED_DIM: 32
    PATCH_SIZE: 32
    NUM_HEADS: 2
    DEPTH: 1
    C_DEPTH: 1
DATA:
  DATASET: div2k
  IMG_SIZE: 64
  BATCH_SIZE: {batch}
  NUM_WORKERS: 0
TRAIN:
  EPOCHS: 1
  WARMUP_EPOCHS: 0
"""


def _write_div2k(root, n=4, size=220):
    rng = np.random.default_rng(0)
    for sub in ["DIV2K_train_HR", "DIV2K_valid_HR"]:
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        for i in range(n):
            arr = rng.integers(0, 255, size=(size, size, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:04d}.png"))


def _args(cfg, data, out, **kw):
    return types.SimpleNamespace(cfg=str(cfg), opts=None, data_path=str(data),
                                 output=str(out), tag="t", mode="lr_finder", device="cpu",
                                 disable_amp=True, batch_size=None, optim=None, **kw)


def test_sweep_matches_the_jax_entry(tmp_path, monkeypatch):
    """The smoothed losses (the JAX entry keeps them local: they are read at
    its ``np.gradient`` call), the rates and the suggestion."""
    import lr_finder as jax_lr_finder

    data = tmp_path / "div2k"
    _write_div2k(str(data))
    # the JAX trainer's batch is DATA.BATCH_SIZE per device of its mesh
    n_dev = jax.device_count()
    assert 8 % n_dev == 0
    (tmp_path / "jax.yaml").write_text(CFG.format(batch=8 // n_dev))
    (tmp_path / "port.yaml").write_text(CFG.format(batch=8))
    monkeypatch.chdir(tmp_path)
    seen = []
    real_gradient = np.gradient

    def spy(losses, *a, **k):
        seen.append(np.array(losses))
        return real_gradient(losses, *a, **k)

    sweep = dict(num_iter=9, start_lr=1e-5, end_lr=5e-2)
    jax_trainer = jax_lr_finder.LrFinderTrainer(_args(tmp_path / "jax.yaml", data,
                                                      tmp_path / "j"))
    weights = jax_params_to_state_dict(jax.tree.map(np.asarray, jax.device_get(
        jax_trainer.params)))
    monkeypatch.setattr(jax_lr_finder.np, "gradient", spy)
    ref_suggestion = jax_trainer.find_lr(**sweep)
    monkeypatch.setattr(jax_lr_finder.np, "gradient", real_gradient)
    assert len(seen) == 1

    trainer = lr_finder.LrFinderTrainer(_args(tmp_path / "port.yaml", data, tmp_path / "p"))
    trainer.model.load_state_dict(weights, strict=True)
    suggestion = trainer.find_lr(**sweep)
    assert len(trainer.losses) == len(seen[0]) == 9
    np.testing.assert_allclose(trainer.losses, seen[0], rtol=1e-4, atol=0)
    assert abs(trainer.losses[-1] - trainer.losses[0]) > 1e-4      # the loss moved
    np.testing.assert_allclose(trainer.lrs, 1e-5 * 5000.0 ** (np.arange(9) / 8), rtol=1e-12)
    assert suggestion == ref_suggestion


def test_cli_and_plot(tmp_path, monkeypatch):
    data = tmp_path / "div2k"
    _write_div2k(str(data))
    (tmp_path / "port.yaml").write_text(CFG.format(batch=8))
    argv = ["--cfg", str(tmp_path / "port.yaml"), "--data-path", str(data), "--output",
            str(tmp_path / "o"), "--tag", "t", "--device", "cpu", "--numb-iter", "5",
            "--start-lr", "1e-6", "--end-lr", "1e-3"]
    trainer = lr_finder.main(argv)
    assert len(trainer.losses) == 5 and 1e-6 <= trainer.suggestion <= 1e-3
    log = (tmp_path / "o" / "tiny_lrfind" / "t" / "log_rank0lr_finder.txt").read_text()
    assert f"Lr suggestion: {trainer.suggestion}" in log
    plot = tmp_path / "o" / "tiny_lrfind" / "t" / "lr_finder_result.jpg"
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert "lr_finder_result.jpg was skipped" in log and not plot.exists()
    else:
        assert plot.is_file()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        lr_finder.main([a for a in argv if a not in ("--device", "cpu")])
