"""Training engine for one process and one device
(``vit_ed_tpu/train/engine.py``).

The template-method surface of the JAX ``Trainer`` is kept
(``get_criterion`` / ``get_transforms`` / ``get_dataloader`` /
``prepare_data`` / ``make_loss_fn`` / ``validate`` hooks, ``train()`` with an
initial validate, a checkpoint per epoch and a best-model save), on eager
PyTorch:

- compute runs in the model's dtype (bf16 under AMP_ENABLE) with float32
  parameters, gradients and optimizer state; bf16 needs no loss scaling;
- gradient accumulation is the mean of the micro-batch losses and of
  their gradients (each micro loss is divided by the count before
  ``backward``);
- the gradients are clipped with ``clip_grad_norm_`` semantics and the
  logged ``grad_norm`` is the global norm before clipping;
- the LR schedule is evaluated on the number of updates already applied
  and written into the optimizer before each update.

Not ported yet (ROADMAP, "what the training slice left out"): a device mesh and every
parallelism switch (they raise), BatchNorm running statistics, MoE aux
losses, the SIGTERM guard with mid-epoch exact-step resume
(``utils/preempt.py``), ``throughput()``, the MFU report and the profiler
hook.
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.train import checkpoint as ckpt
from vit_ed_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    clip_grad_norm,
    set_lr,
)
from vit_ed_tpu_torch.utils import AverageMeter, create_logger, set_seed

Batch = Dict[str, torch.Tensor]
LossFn = Callable[[torch.nn.Module, Batch], torch.Tensor]


class Trainer:
    """Template trainer. Subclasses override ``get_criterion`` / ``validate``
    and optionally the data and loss hooks."""

    def __init__(self, args):
        self.device = resolve_device(getattr(args, "device", None))
        self.config = get_config(args)
        if self.config.TPU.MESH_SHAPE or self.config.TPU.MESH_AXES:
            raise NotImplementedError(
                "TPU.MESH_SHAPE / TPU.MESH_AXES: the port trains on one "
                "device; meshes and parallelism are ROADMAP queue A item 12")

        set_seed(self.config.SEED)

        # linear LR scaling by batch / 256 (x accumulation), as the JAX
        # trainer does with one device
        scale = self.config.DATA.BATCH_SIZE / 256.0
        if self.config.TRAIN.ACCUMULATION_STEPS > 1:
            scale *= self.config.TRAIN.ACCUMULATION_STEPS
        self.config.defrost()
        self.config.TRAIN.BASE_LR = self.config.TRAIN.BASE_LR * scale
        self.config.TRAIN.WARMUP_LR = self.config.TRAIN.WARMUP_LR * scale
        self.config.TRAIN.MIN_LR = self.config.TRAIN.MIN_LR * scale
        self.config.freeze()

        os.makedirs(self.config.OUTPUT, exist_ok=True)
        self.logger = create_logger(output_dir=self.config.OUTPUT, dist_rank=0,
                                    name=f"{self.config.MODEL.NAME}_torch",
                                    affix=getattr(args, "mode", ""))
        path = os.path.join(self.config.OUTPUT, "config.json")
        with open(path, "w") as f:
            json.dump(self.config.to_dict(), f, indent=2, default=str)
        self.logger.info(f"Full config saved to {path}")

        self.logger.info(
            f"Creating model:{self.config.MODEL.TYPE}/{self.config.MODEL.NAME}")
        self.model = build_model(self.config, self.device)
        self.drop_path_generator = self.model.seed_drop_path(self.config.SEED)
        n_parameters = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"number of params: {n_parameters} on {self.device} "
                         f"(compute {self.model.dtype})")

        self.min_loss = 99999.0
        self.start_epoch = self.config.TRAIN.START_EPOCH
        self.step = 0          # optimizer updates applied
        self.optimizer: Optional[torch.optim.Optimizer] = None

        if self.config.TRAIN.AUTO_RESUME:
            resume_file = ckpt.auto_resume_helper(self.config.OUTPUT)
            if resume_file:
                if self.config.MODEL.RESUME:
                    self.logger.warning(
                        f"Auto-resume changing resume file from "
                        f"{self.config.MODEL.RESUME} to {resume_file}")
                self.config.defrost()
                self.config.MODEL.RESUME = resume_file
                self.config.freeze()
                self.logger.info(f"Auto resuming from {resume_file}")
            else:
                self.logger.info(f"No checkpoint found in {self.config.OUTPUT}, "
                                 f"ignoring auto resume")

        if self.config.MODEL.PRETRAINED and not self.config.MODEL.RESUME:
            ckpt.load_pretrained(self.model, self.config.MODEL.PRETRAINED,
                                 self.logger)

        self.data_loader_registers: Dict[str, DataLoader] = {}

    # ------------------------------------------------------------- data hooks
    def get_transforms(self) -> Dict[str, Callable]:
        raise NotImplementedError()

    def get_dataloader(self, mode: str) -> DataLoader:
        raise NotImplementedError()

    def prepare_data(self, samples: np.ndarray, targets: np.ndarray
                     ) -> Dict[str, np.ndarray]:
        """Host-side batch massaging before the copy to the device. Returns
        the dict batch the loss function consumes."""
        return {"samples": samples, "targets": targets}

    # ------------------------------------------------------------ train hooks
    def get_criterion(self) -> Callable:
        raise NotImplementedError()

    def make_loss_fn(self, criterion: Callable) -> LossFn:
        """``loss_fn(model, batch) -> scalar loss`` on the device tensors of
        one prepared batch."""
        raise NotImplementedError()

    def validate(self) -> float:
        raise NotImplementedError()

    # ------------------------------------------------------------------ train
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def train_step(self, micro_batches: List[Dict[str, np.ndarray]]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update from ``len(micro_batches)`` micro-batches:
        the mean of their losses and of their gradients, clipped. Returns
        (loss, pre-clip global grad norm) as device scalars."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        n = len(micro_batches)
        loss_sum = None
        for batch in micro_batches:
            loss = self.loss_fn(self.model, self._to_device(batch))
            (loss / n).backward()
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        grad_norm = clip_grad_norm(self.model.parameters(),
                                   self.config.TRAIN.CLIP_GRAD)
        set_lr(self.optimizer, self.schedule(self.step))
        self.optimizer.step()
        self.step += 1
        return loss_sum / n, grad_norm

    def setup_training(self, steps_per_epoch: int) -> None:
        """Build what ``train_step`` needs: the LR schedule over
        ``steps_per_epoch`` updates per epoch, the optimizer and the loss
        function."""
        self.schedule = build_schedule(self.config, steps_per_epoch)
        self.optimizer = build_optimizer(self.config, self.model)
        self.loss_fn = self.make_loss_fn(self.get_criterion())

    def train(self):
        config = self.config
        if config.TRAIN.PREEMPT_SAVE:
            self.logger.info(
                "TRAIN.PREEMPT_SAVE is not ported yet: no SIGTERM guard and "
                "no mid-epoch resume, a killed run resumes from its last "
                "epoch checkpoint")
        data_loader = self.get_dataloader("train")
        accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
        self.setup_training(len(data_loader) // accum)

        if config.MODEL.RESUME:
            self._load_resume()
            loss = self.validate()
            self.min_loss = min(loss, self.min_loss)
            self.logger.info(f"Loss of the network on the val set: {loss:.4f}")

        self.logger.info("Start training...")
        start_time = time.time()
        loss = self.validate()
        self.logger.info(f"Init loss: {loss}")
        for epoch in range(self.start_epoch, config.TRAIN.EPOCHS):
            self.train_one_epoch(epoch, data_loader)
            if (epoch % config.SAVE_FREQ == 0
                    or epoch == config.TRAIN.EPOCHS - 1):
                self._save(epoch, "checkpoint")
            loss = self.validate()
            if loss < self.min_loss:
                self._save(epoch, "best_model")
                self.logger.info(f"Loss is reduced from {self.min_loss} to {loss}")
            self.min_loss = min(self.min_loss, loss)

        total_time = str(datetime.timedelta(seconds=int(time.time() - start_time)))
        self.logger.info(f"Training time {total_time}")
        return self

    def _save(self, epoch: int, name: str) -> str:
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "step": self.step,
                 "drop_path_generator": self.drop_path_generator.get_state()}
        return ckpt.save_checkpoint(self.config, epoch, state, self.min_loss,
                                    self.logger, name)

    def _load_resume(self) -> None:
        path = self.config.MODEL.RESUME
        self.logger.info(f"==============> Resuming from {path}....")
        tree = ckpt.load_checkpoint(path)
        self.model.load_state_dict(tree["model"], strict=True)
        self.optimizer.load_state_dict(tree["optimizer"])
        self.step = int(tree["step"])
        self.drop_path_generator.set_state(tree["drop_path_generator"])
        self.min_loss = float(tree.get("min_loss", 99999.0))
        epoch = int(tree.get("epoch", -1))
        self.start_epoch = epoch + 1
        self.logger.info(f"=> loaded successfully (epoch {epoch}, "
                         f"{self.step} updates applied)")

    def train_one_epoch(self, epoch: int, data_loader: DataLoader) -> None:
        config = self.config
        accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
        num_steps = len(data_loader)
        batch_time = AverageMeter()
        loss_meter = AverageMeter()
        norm_meter = AverageMeter()

        start = time.time()
        end = time.time()
        micro_acc = []
        for idx, (samples, targets) in enumerate(data_loader):
            micro_acc.append(self.prepare_data(samples, targets))
            if len(micro_acc) < accum:
                continue
            loss, grad_norm = self.train_step(micro_acc)
            micro_acc = []

            if idx % config.PRINT_FREQ < accum or idx == num_steps - 1:
                # .item() waits for the device: the only sync of the loop
                loss_meter.update(loss.item(), np.shape(targets)[0] * accum)
                norm_meter.update(grad_norm.item())
                batch_time.update((time.time() - end) / accum)
                lr = self.schedule(self.step - 1)
                etas = batch_time.avg * (num_steps - idx)
                self.logger.info(
                    f"Train: [{epoch}/{config.TRAIN.EPOCHS}][{idx}/{num_steps}]\t"
                    f"eta {datetime.timedelta(seconds=int(etas))} lr {lr:.6f}\t"
                    f"time {batch_time.val:.4f} ({batch_time.avg:.4f})\t"
                    f"loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})\t"
                    f"grad_norm {norm_meter.val:.4f} ({norm_meter.avg:.4f})")
            else:
                batch_time.update((time.time() - end) / accum)
            end = time.time()

        epoch_time = time.time() - start
        self.logger.info(
            f"EPOCH {epoch} training takes "
            f"{datetime.timedelta(seconds=int(epoch_time))}")
