"""Several processes over ``torch.distributed`` (the port's counterpart of
``vit_ed_tpu/parallel/mesh.py``'s rendezvous and of the JAX
``multihost_utils`` host collectives).

``maybe_init_distributed`` reads the variables the JAX one reads: the
process count from ``JAX_NUM_PROCESSES``, ``WORLD_SIZE`` or
``SLURM_NTASKS``, the rank from ``RANK`` or ``SLURM_PROCID``, the address
from ``COORDINATOR_ADDRESS`` or ``MASTER_ADDR:MASTER_PORT``. One process
returns at once and touches nothing. The backend is
``"cpu:gloo,cuda:nccl"`` on the card (gradients over NCCL, host tensors
over gloo) and ``"gloo"`` on the CPU; a caller that chooses (the CPU
tests, two ranks that share one card) passes it.

The host helpers keep the JAX names and semantics, on numpy arrays and
over a gloo group of their own (every rank calls them in the same order):

- ``process_allgather(x)``: [world, *x.shape] of every rank's ``x``, the
  leading axis padded with zeros to the largest rank's;
- ``broadcast_one_to_all(x, is_source)``: the one source rank's ``x`` on
  every rank;
- ``host_allreduce_sum(x)``: the elementwise sum over ranks (a numpy
  sum with no gradient, unlike the tensor ``all_reduce_sum`` below);
- ``barrier()``.

With one process each is the identity on its input (``process_allgather``
adds the leading axis).

Two tensor collectives carry a gradient, for a loss or a statistic of the
global batch (SyncBN, the MoE aux terms, batch-hard mining); they run on
the default group, over gloo or NCCL, on CPU and CUDA tensors:

- ``all_reduce_sum(x)``: the elementwise sum over ranks; its backward is
  the all-reduce SUM of the gradient (every rank's loss reads the sum);
- ``all_gather_rows(x)``: every rank's rows concatenated in rank order
  (equal row counts); its backward all-reduces the whole gradient and
  keeps this rank's rows.

A group of one rank runs the same code; with no group they are the
identity, and ``group_world`` raises where the launcher's environment
names several processes but no group is up: a rank never stands in for the
global batch with its own.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_gather_rows", "all_reduce_sum", "barrier", "broadcast_one_to_all",
           "check_world", "env_world_size", "group_world", "host_allreduce_sum",
           "maybe_init_distributed", "process_allgather", "process_count",
           "process_index"]

_HOST_GROUP = None
CARD_BACKEND = "cpu:gloo,cuda:nccl"


def env_world_size() -> int:
    """The process count the launcher's environment gives (1 when unset)."""
    n = (os.environ.get("JAX_NUM_PROCESSES") or os.environ.get("WORLD_SIZE")
         or os.environ.get("SLURM_NTASKS"))
    return int(n) if n else 1


def maybe_init_distributed(backend: Optional[str] = None,
                           timeout: Optional[float] = None) -> None:
    """Join the process group a launcher set up (torchrun's env://, SLURM).

    One process, or a group that is already up, returns at once.
    ``backend`` defaults to ``"cpu:gloo,cuda:nccl"`` where a card is
    present and ``"gloo"`` where none is; ``timeout`` (seconds) bounds every
    collective, so that a dead peer fails the survivors instead of hanging
    them (torch's default is 30 minutes)."""
    global _HOST_GROUP
    world = env_world_size()
    if world <= 1 or dist.is_initialized():
        return
    addr = os.environ.get("COORDINATOR_ADDRESS")
    if addr is None:
        addr = (f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
                f"{os.environ.get('MASTER_PORT', '12355')}")
    rank = int(os.environ.get("RANK", os.environ.get("SLURM_PROCID", "0")))
    if backend is None:
        backend = CARD_BACKEND if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout))
    dist.init_process_group(backend=backend, init_method=f"tcp://{addr}",
                            world_size=world, rank=rank, **kwargs)
    _HOST_GROUP = None if backend == "gloo" else dist.new_group(
        backend="gloo", **kwargs)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def check_world(world_size: int) -> None:
    """Raise unless ``world_size`` processes joined the group: a caller that
    splits its work ``world_size`` ways needs every one of them for the
    merge."""
    if world_size != process_count():
        raise ValueError(
            f"world_size {world_size}, but {process_count()} process(es) joined "
            f"the process group: start the processes with torchrun or SLURM "
            f"(parallel/mesh.py maybe_init_distributed)")


def _host_group():
    """The gloo group of the host collectives (the default group when it is
    gloo itself)."""
    return _HOST_GROUP if _HOST_GROUP is not None else dist.group.WORLD


def barrier() -> None:
    if process_count() > 1:
        dist.barrier(group=_host_group())


def _bytes(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).reshape(-1).view(np.uint8))


def process_allgather(x: np.ndarray) -> np.ndarray:
    """Every rank's ``x`` stacked [world, rows, ...]: the leading axis is
    padded with zeros to the largest rank's (the other axes and the dtype
    must agree); with one process ``x[None]``."""
    x = np.asarray(x)
    world = process_count()
    if world == 1:
        return x[None]
    rows = torch.tensor([x.shape[0] if x.ndim else 1], dtype=torch.int64)
    all_rows = [torch.zeros_like(rows) for _ in range(world)]
    dist.all_gather(all_rows, rows, group=_host_group())
    max_rows = int(max(r.item() for r in all_rows))
    pad = np.zeros((max_rows,) + x.shape[1:], x.dtype)
    pad[: x.shape[0]] = x
    mine = _bytes(pad)
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine, group=_host_group())
    return np.stack([o.numpy().view(x.dtype).reshape(pad.shape) for o in out])


def broadcast_one_to_all(x: np.ndarray, is_source: bool) -> np.ndarray:
    """The source rank's ``x`` on every rank; exactly one rank passes
    ``is_source``, and every rank's ``x`` has its shape and dtype."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    src = torch.tensor([process_index() if is_source else -1], dtype=torch.int64)
    dist.all_reduce(src, op=dist.ReduceOp.MAX, group=_host_group())
    buf = _bytes(x).clone()
    dist.broadcast(buf, src=int(src.item()), group=_host_group())
    return buf.numpy().view(x.dtype).reshape(x.shape)


def host_allreduce_sum(x) -> np.ndarray:
    """The elementwise sum of ``x`` (a number or an integer / float64
    array) over the ranks, on every rank."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_host_group())
    return t.numpy()


def group_world() -> int:
    """The process count of the default group (1 without one) for a
    statistic of the global batch. Raises where the launcher's environment
    names several processes but no group is up."""
    if dist.is_initialized():
        return dist.get_world_size()
    if env_world_size() > 1:
        raise RuntimeError(
            f"WORLD_SIZE {env_world_size()} but no process group is up: a "
            f"statistic of the global batch needs the group "
            f"(parallel/mesh.py maybe_init_distributed)")
    return 1


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        return grad


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x)
        ctx.rows = (dist.get_rank() * x.shape[0], x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad)
        start, n = ctx.rows
        return grad[start:start + n]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the default group's ranks, on
    every rank; the gradient of each rank's ``x`` is the sum over ranks of
    the output's gradient. The identity without a group."""
    if not dist.is_initialized():
        group_world()          # raises under WORLD_SIZE > 1
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[world x rows, ...]: every rank's ``x`` (equal shapes) in rank
    order; the gradient of this rank's ``x`` is its rows of the sum over
    ranks of the output's gradient. The identity without a group."""
    if not dist.is_initialized():
        group_world()          # raises under WORLD_SIZE > 1
        return x
    return _AllGatherRows.apply(x)
