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
- ``allreduce_sum(x)``: the elementwise sum over ranks;
- ``barrier()``.

With one process each is the identity on its input (``process_allgather``
adds the leading axis).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["allreduce_sum", "barrier", "broadcast_one_to_all", "check_world",
           "env_world_size", "maybe_init_distributed", "process_allgather",
           "process_count", "process_index"]

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


def allreduce_sum(x) -> np.ndarray:
    """The elementwise sum of ``x`` (a number or an integer / float64
    array) over the ranks, on every rank."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_host_group())
    return t.numpy()
