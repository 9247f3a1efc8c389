"""Optimizers and LR schedules of the training slice
(``vit_ed_tpu/train/optim.py``).

- the four step-wise schedules (cosine with a warm-up prefix, linear,
  step, multistep) as plain functions of the accumulated-step counter;
- weight decay on every parameter except 1-D ones and ``*.bias``, as two
  parameter groups (the JAX package's ``weight_decay_mask``);
- gradient clipping with ``torch.nn.utils.clip_grad_norm_`` semantics
  (scale by ``min(1, max_norm / (norm + 1e-6))``), which the JAX package's
  ``clip_by_global_norm_torch`` was written to match;
- AdamW, and SGD with nesterov momentum and coupled L2 on the decayed
  group.

The learning rate is not baked into the optimizer: the trainer evaluates
the schedule on the number of updates already applied and writes it into
the parameter groups before each update, which is when optax evaluates it.
Linear LR scaling by batch size is applied by the trainer before these
are built.
"""

from __future__ import annotations

import bisect
import math
from typing import Callable, Iterable, List, Sequence

import torch
from torch import nn

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# Schedules (lr as a function of the accumulated update step)
# ---------------------------------------------------------------------------

def _warmup(step, base_lr, warmup_lr, warmup_steps):
    return warmup_lr + (base_lr - warmup_lr) * step / max(warmup_steps, 1)


def cosine_schedule(base_lr: float, min_lr: float, warmup_lr: float,
                    total_steps: int, warmup_steps: int,
                    warmup_prefix: bool = True) -> Schedule:
    """timm CosineLRScheduler with cycle_limit=1, t_in_epochs=False. With
    ``warmup_prefix`` the cosine phase spans (total - warmup) steps and t
    counts from the end of the warm-up."""
    t_initial = (total_steps - warmup_steps) if warmup_prefix else total_steps

    def schedule(step):
        if step < warmup_steps:
            return _warmup(step, base_lr, warmup_lr, warmup_steps)
        t = step - warmup_steps if warmup_prefix else step
        t = min(max(t, 0), t_initial)
        return min_lr + 0.5 * (base_lr - min_lr) * (
            1 + math.cos(math.pi * t / max(t_initial, 1)))

    return schedule


def linear_schedule(base_lr: float, warmup_lr: float, total_steps: int,
                    warmup_steps: int, lr_min_rate: float = 0.01) -> Schedule:
    def schedule(step):
        if step < warmup_steps:
            return _warmup(step, base_lr, warmup_lr, warmup_steps)
        t = step - warmup_steps
        total_t = max(total_steps - warmup_steps, 1)
        return base_lr - (base_lr - base_lr * lr_min_rate) * (t / total_t)

    return schedule


def step_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                  decay_steps: int, decay_rate: float) -> Schedule:
    """timm StepLRScheduler (t_in_epochs=False)."""

    def schedule(step):
        if step < warmup_steps:
            return _warmup(step, base_lr, warmup_lr, warmup_steps)
        return base_lr * decay_rate ** (step // max(decay_steps, 1))

    return schedule


def multistep_schedule(base_lr: float, warmup_lr: float, warmup_steps: int,
                       milestones: Sequence[int], gamma: float) -> Schedule:
    ms = sorted(milestones)

    def schedule(step):
        if step < warmup_steps:
            return _warmup(step, base_lr, warmup_lr, warmup_steps)
        return base_lr * gamma ** bisect.bisect_right(ms, step)

    return schedule


def build_schedule(config, n_iter_per_epoch: int) -> Schedule:
    """The schedule TRAIN.LR_SCHEDULER.NAME names, on accumulated steps."""
    train = config.TRAIN
    num_steps = int(train.EPOCHS * n_iter_per_epoch)
    warmup_steps = int(train.WARMUP_EPOCHS * n_iter_per_epoch)
    decay_steps = int(train.LR_SCHEDULER.DECAY_EPOCHS * n_iter_per_epoch)
    multi_steps = [i * n_iter_per_epoch for i in train.LR_SCHEDULER.MULTISTEPS]
    name = train.LR_SCHEDULER.NAME

    if name == "cosine":
        return cosine_schedule(train.BASE_LR, train.MIN_LR, train.WARMUP_LR,
                               num_steps, warmup_steps,
                               train.LR_SCHEDULER.WARMUP_PREFIX)
    if name == "linear":
        return linear_schedule(train.BASE_LR, train.WARMUP_LR, num_steps,
                               warmup_steps)
    if name == "step":
        return step_schedule(train.BASE_LR, train.WARMUP_LR, warmup_steps,
                             decay_steps, train.LR_SCHEDULER.DECAY_RATE)
    if name == "multistep":
        return multistep_schedule(train.BASE_LR, train.WARMUP_LR, warmup_steps,
                                  multi_steps, train.LR_SCHEDULER.GAMMA)
    raise NotImplementedError(f"Unknown scheduler {name}")


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------

def weight_decay_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """Two parameter groups: multi-dimensional weights (decayed) and 1-D
    parameters plus every ``*.bias`` (not decayed)."""
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        skip = p.ndim <= 1 or name.endswith(".bias")
        (no_decay if skip else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay},
            {"params": no_decay, "weight_decay": 0.0}]


def clip_grad_norm(parameters: Iterable[torch.Tensor],
                   max_norm: float) -> torch.Tensor:
    """The global L2 norm of the gradients BEFORE clipping; with a non-zero
    ``max_norm`` the gradients are scaled in place by
    ``min(1, max_norm / (norm + 1e-6))``."""
    params = [p for p in parameters if p.grad is not None]
    if max_norm:
        return torch.nn.utils.clip_grad_norm_(params, max_norm)
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(p.grad) for p in params]))


def build_optimizer(config, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW or SGD-nesterov over ``weight_decay_groups``; the lr written
    here is a placeholder the trainer overwrites before every update."""
    train = config.TRAIN
    name = train.OPTIMIZER.NAME.lower()
    groups = weight_decay_groups(model, train.WEIGHT_DECAY)
    if name == "adamw":
        return torch.optim.AdamW(groups, lr=train.BASE_LR,
                                 betas=tuple(train.OPTIMIZER.BETAS),
                                 eps=train.OPTIMIZER.EPS)
    if name == "sgd":
        return torch.optim.SGD(groups, lr=train.BASE_LR,
                               momentum=train.OPTIMIZER.MOMENTUM,
                               nesterov=True)
    raise NotImplementedError(f"Unknown optimizer {name}")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
