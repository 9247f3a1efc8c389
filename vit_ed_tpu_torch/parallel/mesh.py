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

The process mesh (``create_mesh``, the JAX ``create_mesh`` and the engine's
axis defaults) lays the ranks out row-major over ``TPU.MESH_SHAPE`` /
``MESH_AXES``, one rank per device, with one process group per line of each
axis. Its ``data`` axis carries the batch: the ranks of one data index
(their ``model`` and ``expert`` peers) hold the same samples, and a
statistic of the global batch runs over the data axis's group
(``set_batch_group``; the default group where no mesh narrows it). The
parameter-sharding rules ride three more collectives on an axis's group:

- ``enter_group(x, group)``: identity forward, all-reduce SUM backward (the
  input of a column-parallel layer or of this rank's experts);
- ``reduce_group(x, group)``: all-reduce SUM forward, identity backward
  (the output of a row-parallel layer or of this rank's experts);
- ``all_gather_dim`` / ``reduce_scatter_flat``: a leaf's shards gathered
  along one dim, and the sum over the group of a flat buffer of which each
  rank keeps its equal part (``reduce_scatter_tensor``, which gloo takes on
  CPU and CUDA tensors as NCCL does; a backend without it raises).
"""

from __future__ import annotations

import datetime
import math
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "Spec", "all_gather_dim", "all_gather_rows", "all_reduce_sum", "barrier",
           "batch_index", "broadcast_batch", "broadcast_one_to_all", "check_world", "create_mesh",
           "default_axes", "enter_group", "env_world_size", "group_world",
           "host_allreduce_sum", "maybe_init_distributed", "process_allgather",
           "process_count", "process_index", "reduce_group", "reduce_scatter_flat",
           "set_batch_group"]

_HOST_GROUP = None
# the group of a statistic of the global batch (the mesh's data axis), or
# None for the default group: set by the trainer that builds the mesh
_BATCH_GROUP = None
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


def host_allreduce_sum(x, group=None) -> np.ndarray:
    """The elementwise sum of ``x`` (a number or an integer / float64
    array) over the ranks (of ``group``, a mesh axis's group, where given),
    on every rank."""
    x = np.asarray(x)
    if process_count() == 1:
        return x
    t = torch.from_numpy(np.array(x, copy=True))
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group or _host_group())
    return t.numpy()


def set_batch_group(group) -> None:
    """Make ``group`` (a mesh's data-axis group, None for the default
    group) the group of every statistic of the global batch: SyncBN, the
    MoE aux terms, batch-hard mining (``all_reduce_sum``,
    ``all_gather_rows``, ``group_world``, ``batch_index``)."""
    global _BATCH_GROUP
    _BATCH_GROUP = group


def batch_index() -> int:
    """This rank's index in the batch group: which share of the global
    batch it holds."""
    if not dist.is_initialized():
        return 0
    return dist.get_rank(_BATCH_GROUP) if _BATCH_GROUP is not None else dist.get_rank()


def group_world() -> int:
    """The process count of the batch group (1 without a group) for a
    statistic of the global batch. Raises where the launcher's environment
    names several processes but no group is up."""
    if dist.is_initialized():
        return dist.get_world_size(_BATCH_GROUP)
    if env_world_size() > 1:
        raise RuntimeError(
            f"WORLD_SIZE {env_world_size()} but no process group is up: a "
            f"statistic of the global batch needs the group "
            f"(parallel/mesh.py maybe_init_distributed)")
    return 1


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        ctx.group = group
        ctx.rows = (dist.get_rank(group) * x.shape[0], x.shape[0])
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, grad):
        grad = _summed(grad, ctx.group)
        start, n = ctx.rows
        return grad[start:start + n], None


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The elementwise sum of ``x`` over the batch group's ranks, on
    every rank; the gradient of each rank's ``x`` is the sum over ranks of
    the output's gradient. The identity without a group."""
    if not dist.is_initialized():
        group_world()          # raises under WORLD_SIZE > 1
        return x
    return _AllReduceSum.apply(x, _BATCH_GROUP)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """[world x rows, ...]: every batch-group rank's ``x`` (equal shapes) in
    rank order; the gradient of this rank's ``x`` is its rows of the sum
    over ranks of the output's gradient. The identity without a group."""
    if not dist.is_initialized():
        group_world()          # raises under WORLD_SIZE > 1
        return x
    return _AllGatherRows.apply(x, _BATCH_GROUP)


# ---------------------------------------------------------------------------
# The process mesh
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    """One parameter's sharding: split along torch dim ``dim`` over mesh
    axis ``axis`` (a leaf without one is replicated)."""
    axis: str
    dim: int


def default_axes(shape: Sequence[int], axes: Sequence[str]) -> Tuple[str, ...]:
    """The engine's axis names: ``TPU.MESH_AXES`` where set, else
    ``("data", "model")[:len(shape)]`` for a shape, ``("data",)`` for none."""
    axes = tuple(axes)
    if not axes:
        axes = ("data", "model")[:len(shape)] if shape else ("data",)
    return axes


class Mesh:
    """Ranks laid out row-major over ``shape`` (one rank per device), with
    one process group per line of each axis (None for an axis of one rank,
    or without a process group) and the group of this rank's peers: the
    ranks of its data index."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str], rank: int,
                 groups: Dict[str, object], peers):
        self.axes = tuple(axes)
        self.shape = dict(zip(self.axes, (int(n) for n in shape)))
        self.rank = rank
        coords = np.unravel_index(rank, tuple(self.shape.values()))
        self.coords = {a: int(i) for a, i in zip(self.axes, coords)}
        self.groups = groups
        self.peers = peers

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The group of this rank's line along ``axis`` (None without a
        process group)."""
        return self.groups.get(axis)

    def peer_source(self) -> int:
        """The global rank of this data index's first peer (every other
        axis at index 0): the one whose host batch its peers take."""
        coords = [self.coords[a] if a == "data" else 0 for a in self.axes]
        return int(np.ravel_multi_index(coords, tuple(self.shape.values())))

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords})"


def _lines(shape: Tuple[int, ...], axis: int) -> List[List[int]]:
    """The rank lists of every line along ``axis`` (rank order)."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    moved = np.moveaxis(ranks, axis, -1).reshape(-1, shape[axis])
    return [list(map(int, line)) for line in moved]


def create_mesh(shape: Optional[Sequence[int]] = None,
                axes: Sequence[str] = ("data",)) -> Mesh:
    """The mesh of ``shape`` over ``axes`` on the processes of the group;
    no shape: one ``axes[0]`` axis over every rank. Its product must be the
    process count. Every rank calls it (it creates the groups)."""
    world = process_count()
    if not shape:
        shape, axes = (world,), tuple(axes)[:1]
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"TPU.MESH_SHAPE {list(shape)} and TPU.MESH_AXES "
                         f"{list(axes)} differ in length")
    if len(set(axes)) != len(axes):
        raise ValueError(f"TPU.MESH_AXES {list(axes)} repeats an axis")
    if math.prod(shape) != world:
        raise ValueError(
            f"TPU.MESH_SHAPE {list(shape)} holds {math.prod(shape)} ranks, but "
            f"WORLD_SIZE is {world}: the mesh lays one rank per device over "
            f"every process")
    rank = process_index()
    groups: Dict[str, object] = {}
    peers = None
    if dist.is_initialized():
        # every rank creates every group, in one order; an axis of one rank
        # gets groups of one (a mesh without a data axis: one per rank), so
        # that a statistic of the batch never falls back to every rank
        lines = {axis: _lines(shape, i) for i, axis in enumerate(axes)}
        if "data" not in lines:
            lines["data"] = [[r] for r in range(world)]
        for axis, axis_lines in lines.items():
            for line in axis_lines:
                g = dist.new_group(line)
                if rank in line:
                    groups[axis] = g
        ranks = np.arange(world).reshape(shape)
        blocks = ([ranks.take(d, axis=axes.index("data")).reshape(-1)
                   for d in range(shape[axes.index("data")])]
                  if "data" in axes else [ranks.reshape(-1)])
        for block in blocks:
            g = dist.new_group(list(map(int, block)))
            if rank in block:
                peers = g
    return Mesh(shape, axes, rank, groups, peers)


def broadcast_batch(batch: Dict[str, np.ndarray], src: int, group) -> Dict[str, np.ndarray]:
    """``batch`` (host arrays of one shape and dtype on every rank of
    ``group``) as the global rank ``src`` holds it, on every rank of
    ``group``."""
    out = {}
    for key, value in batch.items():
        value = np.ascontiguousarray(value)
        buf = _bytes(value).clone()
        dist.broadcast(buf, src=src, group=group)
        out[key] = buf.numpy().view(value.dtype).reshape(value.shape)
    return out


class _EnterGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def enter_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, whose gradient is summed over ``group`` (each rank's part of
    the computation that reads ``x`` gives a part of its gradient); the
    identity for ``group`` None."""
    return x if group is None else _EnterGroup.apply(x, group)


def reduce_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, whose gradient each rank takes
    whole; the identity for ``group`` None."""
    return x if group is None else _ReduceGroup.apply(x, group)


def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) of ``group`` concatenated along
    ``dim`` in group rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim)


def reduce_scatter_flat(flat: torch.Tensor, group) -> torch.Tensor:
    """Sum the flat ``flat`` over ``group``; each rank keeps its equal part
    (group rank order)."""
    n = dist.get_world_size(group)
    if flat.numel() % n:
        raise ValueError(f"{flat.numel()} elements do not split into {n} parts")
    out = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group)
    return out
