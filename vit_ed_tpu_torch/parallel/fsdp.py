"""Fully-sharded data parallelism, ZeRO-3 (``vit_ed_tpu/parallel/fsdp.py``).

The rule is the JAX package's, decided on the FLAX leaf that a torch
parameter converts from (``models.convert.flax_leaf``): split the largest
dim divisible by the ``data`` axis's size over ``data``, ties to the
trailing dim; a leaf under ``min_size`` elements (4,096) stays replicated.
A flax kernel is [in, out] and the port's ``*.weight`` [out, in], so the
split lands on the torch dim that flax dim becomes.

XLA's SPMD partitioner gathers a sharded leaf before use and
reduce-scatters its gradient; here the sharded model does it by hand. A
sharded leaf stays in its module's parameters as this rank's shard (the
optimizer and its moments see only shards). Each unit (a block of
``blocks`` / ``cross_blocks``, or the rest of the model) gathers all its
shards in ONE all-gather at the first read of any of them in a forward; a
block's gather drops the other blocks' gathered leaves, and the model's
forward drops every unit's when it returns. Inside
``regather_in_backward`` (the trainer's training forward), autograd keeps
no gathered leaf, nor a cast or a view of one: it keeps a reference, and
the backward gathers the unit again at its first use there. The unit's
gradients are reduce-scattered in one buffer over the data group
(``mesh.reduce_scatter_flat``) when the backward reaches its gather, which
drops the second gather too. So beside its shards a rank holds the whole
leaves of the unit that runs, not those of the model.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from vit_ed_tpu_torch.models.convert import flax_leaf
from vit_ed_tpu_torch.parallel.mesh import (
    Spec,
    all_gather_dim,
    reduce_scatter_flat,
)

# below this many elements a leaf stays replicated (the JAX package's
# DEFAULT_MIN_SIZE): gathering a norm scale costs more than it saves
DEFAULT_MIN_SIZE = 4096


def fsdp_dim(shape: Sequence[int], axis_size: int,
             min_size: int = DEFAULT_MIN_SIZE) -> Optional[int]:
    """The dim the JAX rule splits on a leaf of ``shape``, or None."""
    size = 1
    for n in shape:
        size *= n
    if not shape or size < min_size:
        return None
    best = None
    for d, n in enumerate(shape):
        if n % axis_size == 0 and (best is None or n >= shape[best]):
            best = d
    return best


def fsdp_param_specs(model: nn.Module, axis_size: int, axis: str = "data",
                     min_size: int = DEFAULT_MIN_SIZE) -> Dict[str, Optional[Spec]]:
    """{parameter name: Spec or None}: each large leaf split over ``axis``."""
    specs = {}
    for name, p in model.named_parameters():
        view = flax_leaf(name, p.shape)
        d = fsdp_dim(view.shape, axis_size, min_size)
        specs[name] = None if d is None else Spec(axis, view.torch_dims[d])
    return specs


class _GatherUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, unit, *shards):
        ctx.fsdp_unit = unit
        return tuple(unit.gather(shards))

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.fsdp_unit
        shard_grads = unit.scatter(grads)
        unit.drop_regathered()
        return (None, *shard_grads)


class FsdpUnit:
    """The sharded leaves of one unit: (module, name, dim) slots over the
    data group of ``size`` ranks."""

    def __init__(self, group, size: int, siblings: Optional[list] = None):
        self.group, self.size = group, size
        # the other blocks' units (None for the rest of the model): a
        # block's gather drops theirs
        self.siblings = siblings
        self.slots: List[Tuple[nn.Module, str, int]] = []
        # the forward's gather (autograd records it) and the backward's
        # (no autograd; also its casts), keyed by (slot, dtype or None)
        self._full: Optional[Dict[Tuple[int, str], torch.Tensor]] = None
        self._again: Optional[Dict[Tuple[int, Optional[torch.dtype]], torch.Tensor]] = None

    def get(self, module: nn.Module, name: str) -> torch.Tensor:
        """The whole leaf ``name`` of ``module``, gathered with the rest of
        the unit at the first read after a release."""
        if self._full is None:
            for unit in self.siblings or ():
                if unit is not self:
                    unit.release()
            shards = [m._parameters[n] for m, n, _ in self.slots]
            fulls = _GatherUnit.apply(self, *shards)
            self._full = {(id(m), n): t for (m, n, _), t in zip(self.slots, fulls)}
        return self._full[(id(module), name)]

    def regathered(self, index: int, dtype: Optional[torch.dtype]) -> torch.Tensor:
        """Leaf ``index`` gathered again for the backward (the whole unit at
        its first call), cast to ``dtype`` unless None."""
        if self._again is None:
            with torch.no_grad():
                fulls = self.gather([m._parameters[n] for m, n, _ in self.slots])
            self._again = {(i, None): t for i, t in enumerate(fulls)}
        if (index, dtype) not in self._again:
            self._again[(index, dtype)] = self._again[(index, None)].to(dtype)
        return self._again[(index, dtype)]

    def release(self) -> None:
        self._full = None

    def drop_regathered(self) -> None:
        self._again = None

    def gather(self, shards: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len({s.dtype for s in shards}) > 1:
            raise ValueError("an FSDP unit gathers leaves of one dtype")
        flat = torch.cat([s.detach().reshape(-1) for s in shards])
        parts = all_gather_dim(flat, 0, self.group).view(self.size, -1)
        out, offset = [], 0
        for s, (_, _, dim) in zip(shards, self.slots):
            n = s.numel()
            out.append(torch.cat([parts[r, offset:offset + n].view(s.shape)
                                  for r in range(self.size)], dim))
            offset += n
        return out

    def scatter(self, grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
        shards = [m._parameters[n] for m, n, _ in self.slots]
        grads = [torch.zeros(s.shape[:d] + (s.shape[d] * self.size,) + s.shape[d + 1:],
                             dtype=s.dtype, device=s.device) if g is None else g
                 for g, s, (_, _, d) in zip(grads, shards, self.slots)]
        flat = torch.cat([g.narrow(d, r * s.shape[d], s.shape[d]).reshape(-1)
                          for r in range(self.size)
                          for g, s, (_, _, d) in zip(grads, shards, self.slots)])
        mine = reduce_scatter_flat(flat, self.group)
        out, offset = [], 0
        for s in shards:
            out.append(mine[offset:offset + s.numel()].view(s.shape))
            offset += s.numel()
        return out


class _Saved(NamedTuple):
    """What autograd keeps of a gathered leaf: its unit, its slot, the
    dtype it was cast to and the view autograd took of it."""
    unit: FsdpUnit
    index: int
    dtype: Optional[torch.dtype]
    size: torch.Size
    stride: Tuple[int, ...]
    offset: int


def _pack(t: torch.Tensor):
    base = t if t._base is None else t._base
    fn, index, dtype = base.grad_fn, base.output_nr, None
    if fn is not None and fn.name() == "ToCopyBackward0":
        (fn, index), dtype = fn.next_functions[0], base.dtype
    unit = getattr(fn, "fsdp_unit", None)
    if unit is None or base.storage_offset() or not base.is_contiguous():
        return t
    return _Saved(unit, index, dtype, t.size(), t.stride(), t.storage_offset())


def _unpack(saved):
    if not isinstance(saved, _Saved):
        return saved
    return saved.unit.regathered(saved.index, saved.dtype).as_strided(
        saved.size, saved.stride, saved.offset)


def regather_in_backward(model: nn.Module):
    """A context for a training forward of ``model``: what autograd saves of
    a unit's gathered leaves (the leaf, a cast of it, a view of either) is
    kept as a reference, and the backward gathers the unit again. A no-op
    for a model without units."""
    if not getattr(model, "_fsdp_units", None):
        return contextlib.nullcontext()
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)


_SHARDED_CLASSES: Dict[type, type] = {}


def _sharded_class(cls: type) -> type:
    """``cls`` whose sharded leaves read as the unit's gathered tensors."""
    if cls not in _SHARDED_CLASSES:
        def __getattr__(self, name):
            unit = self.__dict__.get("_fsdp_unit")
            if unit is not None and name in self.__dict__["_fsdp_names"]:
                return unit.get(self, name)
            return cls.__getattr__(self, name)

        _SHARDED_CLASSES[cls] = type(f"Fsdp{cls.__name__}", (cls,),
                                     {"__getattr__": __getattr__})
    return _SHARDED_CLASSES[cls]


def _units(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    """(prefix, module) of each unit's root: every element of a top-level
    ModuleList (the blocks), then the model for the rest."""
    out = []
    for name, child in model.named_children():
        if isinstance(child, nn.ModuleList):
            out += [(f"{name}.{i}.", m) for i, m in enumerate(child)]
    return out


def install_units(model: nn.Module, specs: Dict[str, Optional[Spec]], group,
                  size: int) -> List[FsdpUnit]:
    """Make the modules of ``model`` whose leaves ``specs`` shards over
    ``data`` (already sliced to this rank's shards) read them through their
    unit's gather. Returns the units (``release_units`` clears them)."""
    owner: Dict[str, FsdpUnit] = {}
    blocks: List[FsdpUnit] = []
    units = [FsdpUnit(group, size, blocks) for _ in _units(model)] + [FsdpUnit(group, size)]
    blocks += units[:-1]
    for (prefix, _), unit in zip(_units(model) + [("", model)], units):
        for name, spec in specs.items():
            if spec is not None and spec.axis == "data" and name.startswith(prefix) \
                    and name not in owner:
                owner[name] = unit
    modules = dict(model.named_modules())
    for name, unit in owner.items():
        mod_name, _, leaf = name.rpartition(".")
        m = modules[mod_name]
        unit.slots.append((m, leaf, specs[name].dim))
        if "_fsdp_unit" not in m.__dict__:
            m.__class__ = _sharded_class(type(m))
            m._fsdp_unit, m._fsdp_names = unit, set()
        if m._fsdp_unit is not unit:
            raise ValueError(f"{mod_name}'s leaves fall in two FSDP units")
        m._fsdp_names.add(leaf)
    model._fsdp_units = [u for u in units if u.slots]
    model.register_forward_hook(_release_after_forward)
    return model._fsdp_units


def _release_after_forward(model, args, output) -> None:
    for unit in model._fsdp_units:
        unit.release()


def release_units(model: nn.Module) -> None:
    """Drop every unit's gathered tensors: the next forward gathers anew."""
    for unit in getattr(model, "_fsdp_units", ()):
        unit.release()
        unit.drop_regathered()
