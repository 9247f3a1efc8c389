"""Checkpoint I/O of the training slice (``vit_ed_tpu/train/checkpoint.py``)
on ``torch.save``.

A checkpoint is one file ``OUTPUT/<name>.ckpt`` holding ``model`` (the
parameters and, for the BatchNorm model types, the running statistics) and
``optimizer`` state dicts, ``step`` (optimizer updates applied), ``epoch``,
``min_loss``, ``in_epoch_opt_steps`` (an int: the updates of ``epoch``
already applied by a mid-epoch preemption save, 0 at an epoch's end) and
``drop_path_generator`` (the state of the model's stochastic-depth
generator); the config is dumped beside it as YAML. ``np.random``'s state
is not saved: the trainer seeds it at start, and a resume draws and
prepares the skipped batches again, which realigns its draws.
``auto_resume_helper`` picks the newest checkpoint of a directory by
mtime. Files are written to a temporary name and renamed, so a killed run
never leaves a half-written checkpoint under the final name.
``load_pretrained`` (models/convert.py) reads both these files and
reference ``.pth`` files, re-initialising a mismatched classifier head and
upcycling a dense checkpoint into a model with expert banks (every expert
from its block's fc1 / fc2, as the JAX ``_upcycle_moe``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from vit_ed_tpu_torch.models.convert import load_pretrained

__all__ = ["CKPT_SUFFIX", "auto_resume_helper", "load_checkpoint",
           "load_pretrained", "save_checkpoint"]

CKPT_SUFFIX = ".ckpt"


def save_checkpoint(config, epoch: int, state: Dict[str, Any],
                    min_loss: float, logger, name: str) -> str:
    """Save ``state`` plus ``epoch`` and ``min_loss`` to
    ``OUTPUT/<name>.ckpt``; returns the path."""
    path = os.path.abspath(os.path.join(config.OUTPUT, name + CKPT_SUFFIX))
    logger.info(f"{path} saving......")
    tree = dict(state)
    tree["epoch"] = int(epoch)
    tree["min_loss"] = float(min_loss)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    with open(os.path.join(config.OUTPUT, "config.yaml"), "w") as f:
        f.write(config.dump())
    logger.info(f"{path} saved !!!")
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The tree ``save_checkpoint`` wrote, on the CPU (tensors, numbers and
    containers only, so it loads with ``weights_only=True``)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def auto_resume_helper(output_dir: str) -> Optional[str]:
    """Newest ``*.ckpt`` file in ``output_dir`` by mtime, or None."""
    if not os.path.isdir(output_dir):
        return None
    ckpts = [os.path.join(output_dir, f) for f in os.listdir(output_dir)
             if f.endswith(CKPT_SUFFIX)]
    ckpts = [c for c in ckpts if os.path.isfile(c)]
    return max(ckpts, key=os.path.getmtime) if ckpts else None
