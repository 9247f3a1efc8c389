"""Training engine, on one device per process
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

BatchNorm model types (``ss``, ``ss2``, ``ss2ce``, ``resnet``,
``mixconv``) keep their running statistics as module buffers: each
micro-batch's training forward updates them once, in the order the JAX
``make_train_step`` threads its ``batch_stats`` (micro-batch by
micro-batch, each BatchNorm in call order); ``model.state_dict()`` carries
them into every checkpoint and a resume, mid-epoch too, restores them with
the weights; ``model.eval()`` normalises with them, as the JAX
``model_variables()`` does. A model that returns a tuple (the SimSiam
types) feeds its first element to the default loss, as in the JAX step.
Torch modules take their shapes at construction, so the JAX trainer's
``_example_input`` (an init batch keyed by type: ``pjs`` and ``ss`` take
stacked pairs) has no counterpart; ``step_model_flops`` reads pairs or
images off each batch's shape.

A pjs model with expert banks (``MODEL.PJS.MOE.EXPERTS > 0``) and
``MOE.AUX_WEIGHT > 0`` adds ``AUX_WEIGHT * sum(load balance) + Z_WEIGHT *
sum(router z)`` to the default loss, as the JAX ``make_train_step`` does;
the terms are values of the forward (``ViTED.forward(..., with_aux=True)``),
and the last update's are logged on each ``Train:`` line. A custom
``make_loss_fn`` that wants them adds them itself
(``models.moe.collect_moe_aux``; hisfrag's does).

Several processes (``torchrun``, SLURM; ``parallel/mesh.py`` joins the
group) train data-parallel on the global batch, as the JAX trainer's one
program over every process's local batch does:

- each rank draws its own batches (the samplers take ``num_replicas`` =
  the process count; host seeds are ``SEED + rank``), while the model's
  initial weights and its DropPath / Dropout / MoE-jitter generator are
  seeded with ``SEED`` on every rank, and each of those modules draws the
  global batch's draws and keeps its own rows
  (``models.layers.shard_draws``);
- the LR scales by the global batch ``BATCH_SIZE x world / 256``;
- after the backward, one all-reduce SUM of the gradients (and of the
  loss) over the default group, before the clip, so that the clip reads
  the global norm and every rank applies the same update. Each rank's loss
  is scaled first so that the sum is the global loss: by ``1 / world``
  where the loss is a mean over equal local batches
  (``rank_loss_weight``); a trainer whose loss normalises otherwise says
  so (hisfrag divides its masked sum by the global live-pair count,
  ``share_batches``);
- only rank 0 logs to the console, writes ``config.json`` and the
  checkpoints, and a barrier follows each save; every rank loads on
  resume. The validation loss that picks ``best_model`` is the mean of
  the ranks', so that every rank takes the same decision;
- the preemption guard agrees across ranks (``utils/preempt.py``); the
  MFU line counts the global FLOPs over ``world`` cards.

Where a loss or a statistic couples the samples of the global batch, it is
the global batch's, as in the JAX trainer's one program over the global
mesh, through the gradient-carrying collectives of ``parallel/mesh.py``:
the BatchNorm types normalise by the global statistics (SyncBN,
``models/resnet.py``), the MoE banks' balance and z terms are means over
the global tokens (``models/moe.py``; ``add_moe_aux`` gives each rank its
share of them), and ``hisfrag_vit`` mines its triplets over the gathered
batch (``train/losses.py``). A subclass whose JAX counterpart has no
global-batch result to reproduce says why in ``ONE_PROCESS_ONLY`` and is
refused (``lr_finder``).

The process mesh (``TPU.MESH_SHAPE`` / ``MESH_AXES``; ``parallel/mesh.py``)
lays the ranks out, one per device, with the JAX trainer's axis defaults
and checks. The global batch is ``BATCH_SIZE x world`` (the JAX
``BATCH_SIZE x n_devices``) and is split over the ``data`` axis only: the
ranks of one data index (their ``model`` and ``expert`` peers) load the same
``BATCH_SIZE x world / data`` samples, with the sampler seeds, the mined
pairs and the draws of that data index, and take the host batch of their
first peer (one broadcast per micro-batch), so that every peer computes on
the same input. ``TPU.FSDP``, ``TENSOR_PARALLEL`` and ``EXPERT_PARALLEL``
compose per leaf (``parallel/compose.py``): the trainer trains a sharded
copy (``self.train_model``) of the whole model (``self.model``, which every
eval, scoring and checkpoint path reads) whose parameters, gradients and
optimizer moments are this rank's shards. The gradients of the leaves not
split over ``data`` are all-reduced over the data group (the FSDP shards
are reduce-scattered in the backward), and the clip reads the global norm.
``local_params()`` gathers the whole model (every rank calls it) before a
validate, a save and ``throughput``; while the shards train, the whole
model's parameters are meta tensors, so a rank holds no whole copy of it
(``_drop_whole``). Checkpoints keep
the whole format, written by rank 0, so that one loads under any mesh.
``TPU.SEQ_PARALLEL``, ``RING_ATTN`` and ``PIPELINE_STAGES > 1`` raise,
naming ROADMAP A12b parts 2 and 3 (``models/build.py``).
"""

from __future__ import annotations

import datetime
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

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
from vit_ed_tpu_torch.models.layers import shard_draws
from vit_ed_tpu_torch.models.moe import collect_moe_aux
from vit_ed_tpu_torch.parallel.compose import (
    composed_param_specs,
    gather_tensor,
    live_specs,
    shard_model,
    shard_tensor,
)
from vit_ed_tpu_torch.parallel.fsdp import regather_in_backward, release_units
from vit_ed_tpu_torch.parallel.mesh import (
    barrier,
    broadcast_batch,
    create_mesh,
    default_axes,
    group_world,
    host_allreduce_sum,
    maybe_init_distributed,
    process_count,
    process_index,
    set_batch_group,
)
from vit_ed_tpu_torch.train import checkpoint as ckpt
from vit_ed_tpu_torch.train.optim import (
    build_optimizer,
    build_schedule,
    clip_grad_norm,
    set_lr,
)
from vit_ed_tpu_torch.utils import AverageMeter, create_logger, set_seed
from vit_ed_tpu_torch.utils.flops import (
    bf16_peak_tflops,
    layer_step_flops,
    pjs_step_flops,
    vit_step_flops,
)
from vit_ed_tpu_torch.utils.preempt import PreemptionGuard
from vit_ed_tpu_torch.utils.profiler import maybe_trace

Batch = Dict[str, torch.Tensor]
# the model types whose FLOPs utils/flops.py counts layer by layer
LAYER_COUNTED = ("ss", "ss2", "ss2ce", "resnet", "mixconv")
LossFn = Callable[[torch.nn.Module, Batch], torch.Tensor]


def moe_aux_weights(config) -> Tuple[float, float]:
    """(AUX_WEIGHT, Z_WEIGHT) of a pjs model with expert banks, else (0, 0):
    the weights of the aux terms a training loss adds."""
    moe = config.MODEL.PJS.MOE
    if config.MODEL.TYPE == "pjs" and moe.EXPERTS > 0:
        return float(moe.AUX_WEIGHT), float(moe.Z_WEIGHT)
    return 0.0, 0.0


class Trainer:
    """Template trainer. Subclasses override ``get_criterion`` / ``validate``
    and optionally the data and loss hooks."""

    # why a subclass refuses several processes, or None
    ONE_PROCESS_ONLY: Optional[str] = None

    def __init__(self, args):
        device = getattr(args, "device", None)
        maybe_init_distributed(
            backend="gloo" if str(device or "cuda").startswith("cpu") else None)
        self.rank, self.world_size = process_index(), process_count()
        # the step all-reduces whenever a process group is up (one rank of
        # one too: its transport then runs the same code)
        self.data_parallel = torch.distributed.is_initialized()
        self.device = resolve_device(device)
        self.config = get_config(args)
        shape = list(self.config.TPU.MESH_SHAPE) or None
        self.mesh = create_mesh(shape, default_axes(shape or (), self.config.TPU.MESH_AXES))
        self._check_mesh()
        # the batch's share and its statistics follow the data axis
        self.data_index, self.data_size = self.mesh.index("data"), self.mesh.size("data")
        self.local_batch_size = (self.config.DATA.BATCH_SIZE * self.world_size
                                 // self.data_size)
        set_batch_group(self.mesh.group("data") if self.data_size < self.world_size
                        else None)
        if self.world_size > 1 and self.ONE_PROCESS_ONLY:
            raise NotImplementedError(
                f"several processes (WORLD_SIZE {self.world_size}) are refused: "
                f"{self.ONE_PROCESS_ONLY}")

        set_seed(self.config.SEED)

        # linear LR scaling by the global batch / 256 (x accumulation), as
        # the JAX trainer does
        scale = self.config.DATA.BATCH_SIZE * self.world_size / 256.0
        if self.config.TRAIN.ACCUMULATION_STEPS > 1:
            scale *= self.config.TRAIN.ACCUMULATION_STEPS
        self.config.defrost()
        self.config.TRAIN.BASE_LR = self.config.TRAIN.BASE_LR * scale
        self.config.TRAIN.WARMUP_LR = self.config.TRAIN.WARMUP_LR * scale
        self.config.TRAIN.MIN_LR = self.config.TRAIN.MIN_LR * scale
        self.config.freeze()

        os.makedirs(self.config.OUTPUT, exist_ok=True)
        self.logger = create_logger(output_dir=self.config.OUTPUT,
                                    dist_rank=self.rank,
                                    name=f"{self.config.MODEL.NAME}_torch",
                                    affix=getattr(args, "mode", ""))
        if self.rank == 0:
            path = os.path.join(self.config.OUTPUT, "config.json")
            with open(path, "w") as f:
                json.dump(self.config.to_dict(), f, indent=2, default=str)
            self.logger.info(f"Full config saved to {path}")
        if self.world_size > 1:
            self.logger.info(f"rank {self.rank} of {self.world_size} on "
                             f"{self.device}")

        self.logger.info(
            f"Creating model:{self.config.MODEL.TYPE}/{self.config.MODEL.NAME}")
        self.model = build_model(self.config, self.device)
        # one generator state on every rank; each module draws the global
        # batch's mask and keeps this rank's rows
        self.drop_path_generator = self.model.seed_drop_path(self.config.SEED)
        shard_draws(self.model, self.data_index, self.data_size)
        n_parameters = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"number of params: {n_parameters} on {self.device} "
                         f"(compute {self.model.dtype})")
        tpu = self.config.TPU
        self.specs = live_specs(composed_param_specs(
            self.model, tp=tpu.TENSOR_PARALLEL, ep=tpu.EXPERT_PARALLEL, fsdp=tpu.FSDP,
            data_axis_size=self.data_size), self.mesh)
        self.sharded = any(spec is not None for spec in self.specs.values())
        # the model the optimizer updates: ``self.model`` itself, or its
        # sharded copy (``setup_training``)
        self.train_model = self.model

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
        self._layer_flops: Dict[Tuple[int, ...], int] = {}
        # the expert banks' aux terms [n_banks, 2] of the last training
        # forward whose loss added them (None without MoE aux losses)
        self.moe_aux: Optional[torch.Tensor] = None
        if self.world_size > 1:
            # the weights above are alike on every rank; the data path's
            # draws are each data index's own
            set_seed(self.config.SEED + self.data_index)

    def _check_mesh(self) -> None:
        """The JAX trainer's checks of the switches against the mesh."""
        tpu, axes = self.config.TPU, self.mesh.axes
        if (tpu.TENSOR_PARALLEL or tpu.SEQ_PARALLEL) and "model" not in axes:
            raise ValueError("TPU.TENSOR_PARALLEL/SEQ_PARALLEL need a 'model' "
                             "mesh axis: set TPU.MESH_SHAPE [data, model] "
                             "(and TPU.MESH_AXES to rename axes)")
        if tpu.RING_ATTN and not tpu.SEQ_PARALLEL:
            raise ValueError("TPU.RING_ATTN requires TPU.SEQ_PARALLEL (the "
                             "token axis to ring over)")
        if tpu.FSDP and "data" not in axes:
            raise ValueError("TPU.FSDP shards over the 'data' mesh axis; "
                             "TPU.MESH_AXES must keep one")
        if tpu.EXPERT_PARALLEL:
            if "expert" not in axes:
                raise ValueError("TPU.EXPERT_PARALLEL needs an 'expert' mesh "
                                 "axis: set TPU.MESH_SHAPE [data, expert] and "
                                 "TPU.MESH_AXES ['data', 'expert']")
            n_exp = self.config.MODEL.PJS.MOE.EXPERTS
            if (self.config.MODEL.TYPE != "pjs" or n_exp <= 0
                    or n_exp % self.mesh.size("expert")):
                raise ValueError("TPU.EXPERT_PARALLEL needs a pjs model with "
                                 "MODEL.PJS.MOE.EXPERTS a positive multiple "
                                 "of the 'expert' axis size")

    # ------------------------------------------------------------ the mesh
    def _shard_groups(self):
        """(this rank's shards, the group that shards them) per mesh axis,
        in axis order: the clip's global norm."""
        by_axis = {}
        for name, p in self.train_model.named_parameters():
            spec = self.specs[name]
            if spec is not None:
                by_axis.setdefault(spec.axis, []).append(p)
        return [(by_axis[a], self.mesh.group(a)) for a in self.mesh.axes if a in by_axis]

    def local_params(self) -> torch.nn.Module:
        """The whole model (``self.model``) with the trained weights: every
        shard of the training model gathered, its buffers copied (every
        rank calls it; the identity without a sharded model). Every eval,
        scoring and checkpoint path reads it; the next update drops it
        again (``_drop_whole``)."""
        if self.train_model is not self.model:
            own = dict(self.train_model.named_parameters(remove_duplicate=False))
            buffers = dict(self.model.named_buffers())
            gathered = {}
            with torch.no_grad():
                for name, p in own.items():
                    if id(p) not in gathered:
                        spec = self.specs[name]
                        gathered[id(p)] = nn.Parameter(
                            p.data.clone() if spec is None
                            else gather_tensor(p.data, name, spec, self.mesh),
                            requires_grad=p.requires_grad)
                self._set_whole(lambda name, _: gathered[id(own[name])])
                for name, b in self.train_model.named_buffers():
                    buffers[name].copy_(b)
        return self.model

    def _drop_whole(self) -> None:
        """Sharded: put meta tensors in place of the whole model's
        parameters while the shards train (their shapes stay for the FLOP
        count, and a forward on them raises); a rank then holds no whole
        copy of the model."""
        if self.train_model is not self.model:
            self._set_whole(lambda _, p: p if p.is_meta else nn.Parameter(
                torch.empty_like(p, device="meta"), requires_grad=p.requires_grad))

    def _set_whole(self, make) -> None:
        """Replace each parameter ``name`` of ``self.model`` by ``make(name,
        parameter)`` (one new object per shared parameter)."""
        modules = dict(self.model.named_modules(remove_duplicate=False))
        made = {}
        for name, p in list(self.model.named_parameters(remove_duplicate=False)):
            if id(p) not in made:
                made[id(p)] = make(name, p)
            mod_name, _, leaf = name.rpartition(".")
            modules[mod_name]._parameters[leaf] = made[id(p)]

    def _load_whole_state(self, state) -> None:
        """Load a whole-model state dict into ``self.model`` or, sharded,
        this rank's shards of it into the training model."""
        if self.train_model is self.model:
            self.model.load_state_dict(state, strict=True)
            return
        keys = set(self.train_model.state_dict())
        if set(state) != keys:
            raise RuntimeError(f"the state's keys differ from the model's: "
                               f"{sorted(set(state) ^ keys)}")
        with torch.no_grad():
            for name, p in self.train_model.named_parameters():
                p.copy_(shard_tensor(state[name].to(p.device), name, self.specs[name],
                                     self.mesh))
            for name, b in self.train_model.named_buffers():
                if name in state:
                    b.copy_(state[name])

    def _optimizer_names(self) -> List[str]:
        """The parameter name of each index of the optimizer's state."""
        names = {id(p): n for n, p in self.train_model.named_parameters()}
        return [names[id(p)] for g in self.optimizer.param_groups for p in g["params"]]

    def _whole_optimizer_state(self) -> dict:
        """The optimizer's state dict in the whole model's form: every moment
        of a sharded leaf gathered (every rank calls it)."""
        state = self.optimizer.state_dict()
        if self.train_model is self.model:
            return state
        names = self._optimizer_names()
        for i, entry in state["state"].items():
            spec = self.specs[names[i]]
            state["state"][i] = {
                k: (gather_tensor(v, names[i], spec, self.mesh)
                    if torch.is_tensor(v) and v.dim() else v) for k, v in entry.items()}
        return state

    def _load_optimizer_state(self, state: dict) -> None:
        """Load a whole-form optimizer state dict (this rank's shards of it)."""
        if self.train_model is not self.model:
            names = self._optimizer_names()
            state = dict(state, state={
                i: {k: (shard_tensor(v, names[i], self.specs[names[i]], self.mesh)
                        if torch.is_tensor(v) and v.dim() else v) for k, v in entry.items()}
                for i, entry in state["state"].items()})
        self.optimizer.load_state_dict(state)

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
                len(dataset), num_replicas=self.data_size, rank=self.data_index,
                shuffle=True, repeat=repeat, seed=config.SEED)
            loader = DataLoader(dataset, sampler=sampler,
                                batch_size=self.local_batch_size,
                                num_workers=config.DATA.NUM_WORKERS,
                                drop_last=True)
        else:
            sampler = DistributedEvalSampler(
                len(dataset), num_replicas=self.world_size, rank=self.rank,
                shuffle=config.TEST.SHUFFLE, repeat=repeat, seed=config.SEED)
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

    def add_moe_aux(self, loss: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
        """``loss`` plus the weighted aux terms (``collect_moe_aux``); keeps
        them for the log line. On several processes the terms are the global
        batch's on every rank, so each rank adds the share that
        ``rank_loss_weight`` turns into ``1 / world`` of them."""
        self.moe_aux = aux.detach()
        weighted = collect_moe_aux(aux, *moe_aux_weights(self.config))
        data = group_world()        # the data axis's ranks
        if data > 1:
            weighted = weighted / (data * self.rank_loss_weight())
        return loss + weighted

    def make_loss_fn(self, criterion: Callable) -> LossFn:
        """``loss_fn(model, batch) -> scalar loss`` on the device tensors of
        one prepared batch. The default is the supervised pair loss:
        ``criterion`` on the float32 logits of the stacked pairs (on the first
        output of a model that returns a tuple), plus the expert banks'
        weighted aux terms when ``moe_aux_weights`` gives a non-zero balance
        weight."""
        with_aux = moe_aux_weights(self.config)[0] > 0

        def loss_fn(model, batch):
            if with_aux:
                out, aux = model(batch["samples"], with_aux=True)
                return self.add_moe_aux(criterion(out.float(), batch["targets"]), aux)
            out = model(batch["samples"])
            out = out[0] if isinstance(out, tuple) else out
            return criterion(out.float(), batch["targets"])

        return loss_fn

    def validate(self) -> float:
        raise NotImplementedError()

    # ------------------------------------------------------------------ train
    def _to_device(self, batch: Dict[str, np.ndarray]) -> Batch:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def rank_loss_weight(self) -> float:
        """The factor of this rank's loss that makes the sum over the data
        axis the global loss: ``1 / data`` for a mean over equal local
        batches."""
        return 1.0 / self.data_size

    def share_batches(self, micro_batches: List[Dict[str, np.ndarray]]) -> None:
        """Several processes: add to the host batches what their loss needs
        from the other ranks, before the step (every rank calls it once per
        update). Nothing by default."""

    def _allreduce_grads(self, loss_sum: torch.Tensor) -> torch.Tensor:
        """Sum the gradients and ``loss_sum`` over the data axis in one
        all-reduce of one flat float32 buffer (the FSDP shards' gradients,
        reduce-scattered in the backward, are left out); returns the summed
        loss. A group of one data index runs it too (one rank of one: its
        transport then runs the same code)."""
        params = [p for name, p in self.train_model.named_parameters()
                  if p.grad is not None and not (
                      self.specs[name] is not None and self.specs[name].axis == "data")]
        flat = torch.cat([p.grad.reshape(-1) for p in params]
                         + [loss_sum.float().reshape(1)])
        torch.distributed.all_reduce(flat, group=self.mesh.group("data"))
        offset = 0
        for p in params:
            p.grad.copy_(flat[offset:offset + p.numel()].view_as(p.grad))
            offset += p.numel()
        return flat[offset]

    def train_step(self, micro_batches: List[Dict[str, np.ndarray]]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One optimizer update from ``len(micro_batches)`` micro-batches:
        the mean of their losses and of their gradients, summed over the
        ranks, clipped. Returns (loss, pre-clip global grad norm) as device
        scalars."""
        model = self.train_model
        model.train()
        self._drop_whole()
        self.optimizer.zero_grad(set_to_none=True)
        n = len(micro_batches)
        if self.data_size < self.world_size:
            # the data index's peers compute on its first peer's batch
            micro_batches[:] = [broadcast_batch(b, self.mesh.peer_source(), self.mesh.peers)
                                for b in micro_batches]
        if self.data_parallel:
            self.share_batches(micro_batches)
        weight = self.rank_loss_weight() if self.data_parallel else 1.0
        loss_sum = None
        for batch in micro_batches:
            with regather_in_backward(model):
                loss = self.loss_fn(model, self._to_device(batch))
            if weight != 1.0:
                loss = loss * weight
            (loss / n).backward()
            release_units(model)
            loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
        if self.data_parallel:
            loss_sum = self._allreduce_grads(loss_sum)
        grad_norm = clip_grad_norm(model.parameters(), self.config.TRAIN.CLIP_GRAD,
                                   self._shard_groups())
        set_lr(self.optimizer, self.schedule(self.step))
        self.optimizer.step()
        self.step += 1
        return loss_sum / n, grad_norm

    def setup_training(self, steps_per_epoch: int) -> None:
        """Build what ``train_step`` needs: the LR schedule over
        ``steps_per_epoch`` updates per epoch, the optimizer and the loss
        function."""
        self.schedule = build_schedule(self.config, steps_per_epoch)
        if self.sharded and self.train_model is self.model:
            self.train_model = shard_model(self.model, self.mesh, self.specs)
            self.drop_path_generator = self.train_model.seed_drop_path(self.config.SEED)
            shard_draws(self.train_model, self.data_index, self.data_size)
            self._drop_whole()
            held = sum(p.numel() for p in self.train_model.parameters())
            self.logger.info(f"sharded over {self.mesh}: this rank holds {held} of "
                             f"{sum(p.numel() for p in self.model.parameters())} "
                             f"parameters")
        self.optimizer = build_optimizer(self.config, self.train_model)
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
            loss = self._agreed_validate()
            self.min_loss = min(loss, self.min_loss)
            self.logger.info(f"Loss of the network on the val set: {loss:.4f}")

        self.logger.info("Start training...")
        start_time = time.time()
        loss = self._agreed_validate()
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
            loss = self._agreed_validate()
            if loss < self.min_loss:
                self._save(epoch, "best_model")
                self.logger.info(f"Loss is reduced from {self.min_loss} to {loss}")
            self.min_loss = min(self.min_loss, loss)

        total_time = str(datetime.timedelta(seconds=int(time.time() - start_time)))
        self.logger.info(f"Training time {total_time}")
        self.local_params()
        return self

    def _agreed_validate(self) -> float:
        """``validate()``, meaned over the ranks: every rank then takes the
        same best-model decision (the ranks of a scan's validation hold the
        same value already)."""
        self.local_params()
        loss = self.validate()
        if self.world_size == 1:
            return loss
        return float(host_allreduce_sum(np.float64(loss))) / self.world_size

    def _save(self, epoch: int, name: str, in_epoch_opt_steps: int = 0) -> str:
        """``in_epoch_opt_steps > 0`` marks a mid-epoch (preemption) save:
        ``epoch`` is the epoch in progress, and a resume continues it after
        that many updates instead of starting the next one. Rank 0 writes
        (every rank holds the same state); the others wait for it."""
        path = ckpt.checkpoint_path(self.config, name)
        model = self.local_params()
        optimizer = self._whole_optimizer_state()
        if self.rank == 0:
            state = {"model": model.state_dict(),
                     "optimizer": optimizer,
                     "step": self.step,
                     "in_epoch_opt_steps": int(in_epoch_opt_steps),
                     "drop_path_generator": self.drop_path_generator.get_state()}
            ckpt.save_checkpoint(self.config, epoch, state, self.min_loss,
                                 self.logger, name)
        barrier()
        return path

    def _load_resume(self) -> None:
        path = self.config.MODEL.RESUME
        self.logger.info(f"==============> Resuming from {path}....")
        tree = ckpt.load_checkpoint(path)
        self._load_whole_state(tree["model"])
        self._load_optimizer_state(tree["optimizer"])
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

    def step_model_flops(self, micro_batches: List[Dict[str, np.ndarray]]
                         ) -> Optional[int]:
        """Model FLOPs (forward + backward, utils/flops.py) of one update,
        by MODEL.TYPE. A ViT counts every image of ``samples`` (every axis
        before [H, W, C]: a triplet item [4, 3, H, W, C] holds 12). A pjs
        model counts per micro-batch its images and its live pairs (the
        mined-pair buffer's ``pair_mask``; padding rows are not counted),
        or one pair per stacked item. The BatchNorm types count their
        convolutions and Dense layers at the batch's shape. None for a model
        that none of these counts (the MFU line then gives no percentage)."""
        total = 0
        for batch in micro_batches:
            shape = np.shape(batch["samples"])
            if self.config.MODEL.TYPE == "vit":
                total += sum(vit_step_flops(self.model, int(np.prod(shape[:-3]))))
            elif self.config.MODEL.TYPE == "pjs":
                n_pairs = (int(np.asarray(batch["pair_mask"]).sum())
                           if "pair_mask" in batch else int(shape[0]))
                total += sum(pjs_step_flops(self.model, int(shape[0]), n_pairs))
            elif self.config.MODEL.TYPE in LAYER_COUNTED:
                if shape not in self._layer_flops:
                    self._layer_flops[shape] = sum(layer_step_flops(self.model, shape))
                total += self._layer_flops[shape]
            else:
                return None
        return total

    def _moe_aux_text(self) -> str:
        """The last update's aux terms for the ``Train:`` line: the mean over
        the banks of the load balance (1.0 when balanced) and of the router
        z-loss."""
        if self.moe_aux is None:
            return ""
        lb, z = self.moe_aux.float().mean(0).tolist()
        return f"\tmoe load_balance {lb:.4f} router_z {z:.4f}"

    def _log_mfu(self, step_seconds: float, step_flops: Optional[float],
                 model_type: str, cards: int = 1) -> str:
        """The epoch's model-FLOP MFU line: mean model FLOPs per update over
        the median time per update between syncs, against the dense bf16
        peak of ``cards`` cards (or TPU.PEAK_TFLOPS each where a config sets
        it); no percentage where the peak or the model's count is
        unknown."""
        if step_flops is None:
            line = (f"Model FLOPs: not counted for MODEL.TYPE {model_type}; "
                    f"{step_seconds * 1e3:.1f} ms per update (median between "
                    f"syncs, host input included); model-FLOP MFU not computed")
            self.logger.info(line)
            return line
        peak, name = bf16_peak_tflops(self.device, self.model.dtype,
                                      self.config.TPU.PEAK_TFLOPS)
        tfs = step_flops / step_seconds / 1e12
        over = f" over {cards} cards" if cards > 1 else ""
        line = (f"Model FLOPs: {step_flops / 1e9:.3f} GF/update (forward + "
                f"backward, counted from the {model_type} geometry{over}) / "
                f"{step_seconds * 1e3:.1f} ms per update (median between "
                f"syncs, host input included) = {tfs:.2f} TF/s; ")
        if peak is None:
            line += (f"model-FLOP MFU not computed: the {self.model.dtype} "
                     f"peak of {name} is unknown (set TPU.PEAK_TFLOPS)")
        else:
            of = f"{cards} x {name}" if cards > 1 else name
            line += (f"{100 * tfs / (peak * cards):.1f}% model-FLOP MFU of {of} "
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
                    f"grad_norm {norm_meter.val:.4f} ({norm_meter.avg:.4f})"
                    + self._moe_aux_text())
            else:
                batch_time.update((time.time() - end) / accum)
            end = time.time()

        epoch_time = time.time() - start
        self.logger.info(
            f"EPOCH {epoch} training takes "
            f"{datetime.timedelta(seconds=int(epoch_time))}")
        if len(sync_rates) >= 3:   # one or two intervals are noise
            counted = None if None in step_flops else float(np.mean(step_flops))
            if counted is not None and self.world_size > 1:
                # each data index's FLOPs, counted on the whole model by
                # each of its world / data peers
                counted = float(host_allreduce_sum(np.float64(counted))) * (
                    self.data_size / self.world_size)
            self._log_mfu(float(np.median(sync_rates)), counted,
                          self.config.MODEL.TYPE, self.world_size)

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
        self.local_params()
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
