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

With ``TRAIN.PREEMPT_SAVE`` (the default) ``train()`` installs a SIGTERM
guard (``utils/preempt.py``) before anything else; after an update on which
it trips, the trainer saves ``checkpoint`` with ``in_epoch_opt_steps`` (the
updates of the epoch already applied) and returns. Resuming from such a
checkpoint continues the same epoch: its first ``in_epoch_opt_steps``
batches are drawn and prepared as in the interrupted run (so the sampler
and ``np.random`` stay aligned with an uninterrupted run) and skipped.
Each epoch ends with a model-FLOP MFU line (``utils/flops.py``) once it has
three or more intervals between the loop's syncs.

``throughput()`` times forwards of one validation batch; with
``TPU.PROFILE_DIR`` set it also writes a ``torch.profiler`` trace of the
timed region.

Not ported yet (ROADMAP, "what the slices left out"): a device mesh and every
parallelism switch (they raise), BatchNorm running statistics and MoE aux
losses.
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
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.samplers import (
    DistributedEvalSampler,
    DistributedRepeatSampler,
)
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
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
from vit_ed_tpu_torch.utils.flops import bf16_peak_tflops, pjs_step_flops
from vit_ed_tpu_torch.utils.preempt import PreemptionGuard
from vit_ed_tpu_torch.utils.profiler import maybe_trace

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
        self.preempted = False
        self._preempt: Optional[PreemptionGuard] = None
        self._resume_skip_opt_steps = 0

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
        transform = TwoImgSyncEval(self.config.DATA.IMG_SIZE)
        return {"train": transform, "validation": transform, "test": transform}

    def get_dataloader(self, mode: str) -> DataLoader:
        """Repeat-sampled, shuffled, drop-last batches for ``train``; an
        exact, unpadded pass (x repeat) at TEST_BATCH_SIZE otherwise."""
        if mode in self.data_loader_registers:
            return self.data_loader_registers[mode]
        config = self.config
        dataset, repeat = build_dataset(mode=mode, config=config,
                                        transforms=self.get_transforms())
        self.logger.info(f"successfully built {mode} dataset "
                         f"({len(dataset)} items, repeat {repeat})")
        if mode == "train":
            sampler = DistributedRepeatSampler(
                len(dataset), shuffle=True, repeat=repeat, seed=config.SEED)
            loader = DataLoader(dataset, sampler=sampler,
                                batch_size=config.DATA.BATCH_SIZE,
                                num_workers=config.DATA.NUM_WORKERS,
                                drop_last=True)
        else:
            sampler = DistributedEvalSampler(
                len(dataset), shuffle=config.TEST.SHUFFLE, repeat=repeat,
                seed=config.SEED)
            loader = DataLoader(dataset, sampler=sampler,
                                batch_size=config.DATA.TEST_BATCH_SIZE,
                                num_workers=config.DATA.NUM_WORKERS,
                                drop_last=False)
        self.data_loader_registers[mode] = loader
        return loader

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
        one prepared batch. The default is the supervised pair loss:
        ``criterion`` on the float32 logits of the stacked pairs."""
        def loss_fn(model, batch):
            return criterion(model(batch["samples"]).float(), batch["targets"])

        return loss_fn

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
        # the guard goes in first: building the loader and the optimizer and
        # the initial validate take a while, and a SIGTERM then must latch
        # the flag instead of killing the process
        self.preempted = False
        self._preempt = None
        if self.config.TRAIN.PREEMPT_SAVE:
            self._preempt = PreemptionGuard(
                check_freq=self.config.TRAIN.PREEMPT_CHECK_FREQ).install()
        try:
            return self._train_inner()
        finally:
            if self._preempt is not None:
                self._preempt.uninstall()

    def _train_inner(self):
        config = self.config
        data_loader = self.get_dataloader("train")
        accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
        self.setup_training(len(data_loader) // accum)

        self._resume_skip_opt_steps = 0
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
            if self.preempted:
                # the checkpoint is written; the grace window is for the
                # save, not for a validate
                break
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

    def _save(self, epoch: int, name: str, in_epoch_opt_steps: int = 0) -> str:
        """``in_epoch_opt_steps > 0`` marks a mid-epoch (preemption) save:
        ``epoch`` is the epoch in progress, and a resume continues it after
        that many updates instead of starting the next one."""
        state = {"model": self.model.state_dict(),
                 "optimizer": self.optimizer.state_dict(),
                 "step": self.step,
                 "in_epoch_opt_steps": int(in_epoch_opt_steps),
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
        # checkpoints written before mid-epoch saves existed lack the key
        skip = int(tree.get("in_epoch_opt_steps", 0))
        if skip > 0:
            self._resume_skip_opt_steps = skip
            self.start_epoch = epoch
            self.logger.info(f"=> loaded successfully (epoch {epoch}, "
                             f"continuing from optimizer step {skip}; "
                             f"{self.step} updates applied)")
        else:
            self.start_epoch = epoch + 1
            self.logger.info(f"=> loaded successfully (epoch {epoch}, "
                             f"{self.step} updates applied)")

    def step_model_flops(self, micro_batches: List[Dict[str, np.ndarray]]) -> int:
        """Model FLOPs (forward + backward, utils/flops.py) of one update:
        per micro-batch, its images and its live pairs (the mined-pair
        buffer's ``pair_mask``; padding rows are not counted), or one pair
        per stacked item."""
        total = 0
        for batch in micro_batches:
            n_images = int(np.shape(batch["samples"])[0])
            n_pairs = (int(np.asarray(batch["pair_mask"]).sum())
                       if "pair_mask" in batch else n_images)
            total += sum(pjs_step_flops(self.model, n_images, n_pairs))
        return total

    def _log_mfu(self, step_seconds: float, step_flops: float) -> str:
        """The epoch's model-FLOP MFU line: mean model FLOPs per update over
        the median time per update between syncs, against the card's dense
        bf16 peak (or TPU.PEAK_TFLOPS where a config sets it); no
        percentage where the peak is unknown."""
        peak, name = bf16_peak_tflops(self.device, self.model.dtype,
                                      self.config.TPU.PEAK_TFLOPS)
        tfs = step_flops / step_seconds / 1e12
        line = (f"Model FLOPs: {step_flops / 1e9:.3f} GF/update (forward + "
                f"backward, counted from the pjs geometry) / "
                f"{step_seconds * 1e3:.1f} ms per update (median between "
                f"syncs, host input included) = {tfs:.2f} TF/s; ")
        if peak is None:
            line += (f"model-FLOP MFU not computed: the {self.model.dtype} "
                     f"peak of {name} is unknown (set TPU.PEAK_TFLOPS)")
        else:
            line += (f"{100 * tfs / peak:.1f}% model-FLOP MFU of {name} "
                     f"{peak:.1f} TF/s")
        self.logger.info(line)
        return line

    def train_one_epoch(self, epoch: int, data_loader: DataLoader) -> None:
        config = self.config
        accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
        num_steps = len(data_loader)
        batch_time = AverageMeter()
        loss_meter = AverageMeter()
        norm_meter = AverageMeter()
        # the MFU's step time: updates are asynchronous and only the prints
        # sync, so one update's wall time means nothing alone; the median of
        # (time between syncs / updates between syncs) over the epoch does
        sync_rates, step_flops = [], []
        last_sync, since_sync = None, 0

        # a mid-epoch resume skips the updates already applied; their
        # batches are still drawn and prepared, so that the sampler and
        # np.random stay where an uninterrupted run has them
        skip = (self._resume_skip_opt_steps
                if epoch == self.start_epoch else 0)
        start = time.time()
        end = time.time()
        micro_acc = []
        opt_idx = 0
        for idx, (samples, targets) in enumerate(data_loader):
            micro_acc.append(self.prepare_data(samples, targets))
            if len(micro_acc) < accum:
                continue
            if opt_idx < skip:
                micro_acc = []
                opt_idx += 1
                end = time.time()
                continue
            loss, grad_norm = self.train_step(micro_acc)
            step_flops.append(self.step_model_flops(micro_acc))
            micro_acc = []
            opt_idx += 1
            since_sync += 1

            if (self._preempt is not None
                    and self._preempt.should_stop(opt_idx)):
                self._save(epoch, "checkpoint", in_epoch_opt_steps=opt_idx)
                self.preempted = True
                self.logger.info(
                    f"Preempted during epoch {epoch} after optimizer step "
                    f"{opt_idx}: checkpoint saved, exiting cleanly (a rerun "
                    f"continues this epoch from there)")
                return

            if idx % config.PRINT_FREQ < accum or idx == num_steps - 1:
                # .item() waits for the device: the only sync of the loop
                loss_meter.update(loss.item(), np.shape(targets)[0] * accum)
                norm_meter.update(grad_norm.item())
                now = time.time()
                if last_sync is not None:
                    sync_rates.append((now - last_sync) / since_sync)
                last_sync, since_sync = now, 0
                batch_time.update((now - end) / accum)
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
        if len(sync_rates) >= 3:   # one or two intervals are noise
            self._log_mfu(float(np.median(sync_rates)),
                          float(np.mean(step_flops)))

    # ------------------------------------------------------------- throughput
    def throughput_batch(self) -> np.ndarray:
        """The batch ``throughput`` times: the first validation batch."""
        images, _ = next(iter(self.get_dataloader("validation")))
        return images

    def throughput(self, warmup: int = 50, timed: int = 30) -> float:
        """``warmup`` + ``timed`` forwards of the first validation batch ->
        images (pairs) per second. On a card the timed forwards run between
        two CUDA events and end in a synchronise; with TPU.PROFILE_DIR set
        a profiler trace of the timed region is written."""
        x = self._to_device({"samples": self.throughput_batch()})["samples"]
        batch_size = x.shape[0]
        cuda = self.device.type == "cuda"
        self.model.eval()
        with torch.inference_mode():
            for _ in range(warmup):
                self.model(x)
            self.logger.info(f"throughput averaged with {timed} times")
            with maybe_trace(self.config.TPU.PROFILE_DIR, "throughput"):
                if cuda:
                    start = torch.cuda.Event(enable_timing=True)
                    stop = torch.cuda.Event(enable_timing=True)
                    start.record()
                tic = time.time()
                for _ in range(timed):
                    self.model(x)
                if cuda:
                    stop.record()
                    torch.cuda.synchronize(self.device)
                    seconds = start.elapsed_time(stop) / 1e3
                else:
                    seconds = time.time() - tic
        throughput_val = timed * batch_size / seconds
        self.logger.info(f"batch_size {batch_size} throughput {throughput_val}")
        return throughput_val
