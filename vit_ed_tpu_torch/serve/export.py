"""Serving export of the port: versioned ``torch.export`` artifacts
(``vit_ed_tpu/serve/export.py``).

The scorer's stages are exported ONCE with ``torch.export`` into a bundle
directory; a serving host replays them with no model code (``load_scorer``
imports the ops library, whose registered attention operators the graphs
call, and nothing of ``models/``). The batch dimension stays symbolic
(``torch.export.Dim``), so one artifact serves every batch size, or the
bundle holds one concrete artifact per batch bucket.

Each stage is exported as a function of the weights, ``f(weights,
*arrays)`` with the weights a {name: tensor} dict, as the JAX stages are
``f(params, *arrays)``: the weights are stored once, in ``weights.pt``,
and no artifact carries a copy (its example inputs are dropped before it
is saved).

Attention reaches the graph as ``torch.ops.vit_ed.pair_forward`` /
``heads_forward`` (ops/attention.py): replayed on the card, each node is
the kernel launch the live forward makes, counted in ``launches``; on the
CPU it is the plain version. The JAX bundle's Pallas kernels ride along as
Mosaic custom calls in the same way.

Artifacts under ``out_dir``:

    <stage>.pt2          ``torch.export.save`` of the stage (symbolic b)
    <stage>_b<N>.pt2     bucketed concrete-batch variant (opt-in)
    weights.pt           the float32 weights (``torch.save``; loads with
                         ``weights_only=True``)
    serving_meta.json    format version, model geometry, stage table, the
                         device the stages were exported on, per-stage
                         input/output signatures (numpy dtype names)

Stages, the O(N^2) scan decomposition (models/vit_ed.py):

    pair       f(w, x [b,2,H,W,3])              -> [b, classes]
    encode     f(w, x1 [b,H,W,3])               -> feats [b,Sk,C]
    prepare    f(w, x2 [b,H,W,3])               -> tokens [b,Sq,C]
    kv         f(w, feats [b,Sk,C])             -> kv [L,b,Sk,2C]
    score_row  f(w, kv [L,1,Sk,2C], t [b,Sq,C]) -> [b, classes]
    pair_u8    f(w, x [b,2,H,W,3] uint8)        -> [b, classes]  (the
               (x/255 - 0.5)/0.5 normalise on the device)

A bundle replays on the device type it was exported on. Loaded on another
one it is moved with ``torch.export.passes.move_to_device_pass`` where the
installed torch has it, and refused otherwise. Multi-chip bundles (the JAX
``mesh=``) are not ported (ROADMAP queue A item 12b part 4).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence

import torch

from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.ops import attention as _attention  # noqa: F401  (registers torch.ops.vit_ed)
from vit_ed_tpu_torch.ops.quant import int8_gemms

FORMAT_VERSION = 1

STAGES = ("pair", "pair_u8", "encode", "prepare", "kv", "score_row")

WEIGHTS_FILE = "weights.pt"
_MULTICHIP = ("multi-chip bundles (a mesh) are not ported yet (ROADMAP queue A "
              "item 12b part 4)")


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``float32``, ``bfloat16``, ``uint8``)."""
    return str(dtype).split(".")[-1]


def _methods(model) -> Dict[str, Callable]:
    return {
        "pair": lambda x: model(x),
        "encode": lambda x: model(x, forward_first_part=True),
        "prepare": model.prepare_x2_scan,
        "kv": model.context_kv_cache,
        "score_row": model.score_tokens_row,
        "pair_u8": lambda x: model((x.float() / 255.0 - 0.5) / 0.5),
    }


class _Method(torch.nn.Module):
    """One method of the model as a module's forward (what
    ``torch.func.functional_call`` runs), with the int8 GEMMs on when
    asked: they quantize the weights the call was given."""

    def __init__(self, model, method: Callable, int8: bool):
        super().__init__()
        self.model = model
        self.method = method
        self.int8 = int8

    def forward(self, *arrays):
        with int8_gemms(self.model, self.int8):
            return self.method(*arrays)


def stage_fns(model, int8: bool = False) -> Dict[str, Callable]:
    """The six serving entry points as ``f(weights, *arrays)``: ``model``'s
    method run on ``weights`` (a {name: tensor} dict in place of its own
    parameters), with the int8 GEMMs of ``ops/quant.py`` when ``int8``."""

    def bind(method):
        holder = _Method(model, method, int8)

        def fn(weights, *arrays):
            return torch.func.functional_call(
                holder, {f"model.{k}": v for k, v in weights.items()}, arrays)
        return fn

    return {stage: bind(m) for stage, m in _methods(model).items()}


class _Stage(torch.nn.Module):
    """What ``torch.export`` traces: one stage as ``forward(weights,
    *arrays)``. The model is kept off the module tree (in a closure), so
    that its parameters are no state of the exported program."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, weights, *arrays):
        return self.fn(weights, *arrays)


def _stage_specs(model, weights, stages, device):
    """Per stage: (example inputs at batch 2, the batch axis of each input
    or None, the output's batch axis or None). The output axis is the one
    that changes between batch 1 and 2, as the JAX exporter finds it."""
    img = model.img_size
    fns = stage_fns(model)

    def inputs(b):
        x_pair = torch.zeros((b, 2, img, img, 3), device=device)
        x_one = torch.zeros((b, img, img, 3), device=device)
        feats = fns["encode"](weights, x_one)
        return {
            "pair": (x_pair,), "pair_u8": (x_pair.to(torch.uint8),),
            "encode": (x_one,), "prepare": (x_one,), "kv": (feats,),
            # kv axis 1 is the (fixed, =1) row, NOT a batch axis: the served
            # row chunk shares one x1 row like the production scan
            "score_row": (fns["kv"](weights, feats[:1]), fns["prepare"](weights, x_one)),
        }

    specs = {}
    with torch.no_grad():
        one, two = inputs(1), inputs(2)
        for stage in stages:
            shapes = [tuple(fns[stage](weights, *ins[stage]).shape) for ins in (one, two)]
            out_axis = next((i for i, (x, y) in enumerate(zip(*shapes)) if x != y), None)
            specs[stage] = (two[stage], (None, 0) if stage == "score_row" else (0,),
                            out_axis)
    return specs


def _with_batch(t: torch.Tensor, axis: Optional[int], b: int) -> torch.Tensor:
    if axis is None or t.shape[axis] == b:
        return t
    shape = list(t.shape)
    shape[axis] = b
    return torch.zeros(shape, dtype=t.dtype, device=t.device)


def export_scorer(model, state: Optional[Dict[str, torch.Tensor]], out_dir: str, *,
                  stages: Sequence[str] = STAGES,
                  batch_sizes: Optional[Sequence[int]] = None,
                  device=None, int8: bool = False, mesh=None,
                  extra_meta: Optional[dict] = None) -> dict:
    """Export the scorer stages of ``model`` with the weights ``state``
    (its own ``state_dict()`` when None) to ``out_dir``; returns the meta
    dict.

    ``batch_sizes`` None -> ONE artifact per stage with a symbolic batch
    (serves any b >= 1); otherwise one artifact per (stage, batch size)
    bucket. The stages are traced on ``device`` (the card unless
    ``cpu`` is asked for), where the model's parameters must lie. ``int8``
    exports the dynamic int8 GEMMs of ``ops/quant.py`` (``TPU.INT8_SCORE``):
    the weights are the same float32 tree, quantized inside the graph."""
    if mesh is not None:
        raise NotImplementedError(_MULTICHIP)
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, "
                         f"the export was asked for on {device}")
    unknown = set(stages) - set(STAGES)
    if unknown:
        raise ValueError(f"unknown stages {sorted(unknown)}; have {STAGES}")
    if batch_sizes is not None:
        batch_sizes = sorted(set(int(b) for b in batch_sizes))
        if not batch_sizes:
            raise ValueError("batch_sizes must be non-empty (or None "
                             "for a symbolic-batch bundle)")
    os.makedirs(out_dir, exist_ok=True)
    weights = {k: v.detach().to(device)
               for k, v in (state if state is not None else model.state_dict()).items()}
    model.eval()
    fns = stage_fns(model, int8)
    specs = _stage_specs(model, weights, stages, device)

    meta: dict = {
        "format_version": FORMAT_VERSION,
        "batch_mode": "symbolic" if batch_sizes is None else batch_sizes,
        "stages": {},
        "model": {
            "img_size": int(model.img_size),
            "patch_size": int(model.patch_size),
            "num_classes": int(model.head.weight.shape[0]),
            "embed_dim": int(model.embed_dim),
            "depth": len(model.blocks),
            "c_depth": int(model.c_depth),
            "num_heads": int(model.num_heads),
            "dtype": _dtype_name(model.dtype),
        },
    }
    if extra_meta:
        meta.update(extra_meta)

    def one(stage, b, fname):
        examples, in_axes, out_axis = specs[stage]
        examples = tuple(_with_batch(t, ax, 2 if b is None else b)
                         for t, ax in zip(examples, in_axes))
        dynamic = None
        if b is None:
            dim = torch.export.Dim("b", min=1)
            dynamic = ({k: None for k in weights},
                       tuple(None if ax is None else {ax: dim} for ax in in_axes))
        with torch.no_grad():
            ep = torch.export.export(_Stage(fns[stage]), (weights, *examples),
                                     dynamic_shapes=dynamic)
        ep.example_inputs = None      # they hold the weights
        torch.export.save(ep, os.path.join(out_dir, fname))
        out_val = next(n for n in ep.graph.nodes
                       if n.op == "output").args[0][0].meta["val"]

        def dims(shape, axis):
            return [("b" if b is None and i == axis else str(int(d)))
                    for i, d in enumerate(shape)]

        return {
            "file": fname,
            "out_batch_axis": out_axis,
            "inputs": [dims(t.shape, ax) + [_dtype_name(t.dtype)]
                       for t, ax in zip(examples, in_axes)],
            "batch_axes": list(in_axes),
            "outputs": [dims(out_val.shape, out_axis) if b is None
                        else [int(d) for d in out_val.shape]],
            "device": device.type,
            "nr_devices": 1,
        }

    for stage in stages:
        if batch_sizes is None:
            meta["stages"][stage] = [one(stage, None, f"{stage}.pt2")]
        else:
            meta["stages"][stage] = [one(stage, n, f"{stage}_b{n}.pt2")
                                     for n in batch_sizes]

    torch.save({k: v.float().cpu() for k, v in weights.items()},
               os.path.join(out_dir, WEIGHTS_FILE))
    with open(os.path.join(out_dir, "serving_meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedScorer:
    """Loaded serving bundle: ``scorer(stage, *arrays)`` replays the
    exported computation with the bundled weights, NO model code needed,
    and returns a tensor on the scorer's device.

    Symbolic-batch bundles accept any leading batch size; bucketed
    bundles dispatch to the matching batch artifact (exact match required:
    the serving tier owns padding policy, as ``parallel/pairs.py`` does with
    its fixed-shape chunks). Inputs (numpy arrays or tensors) are moved to
    the device; every call runs under ``torch.inference_mode()``, which is
    thread-local, so it holds in the server's batcher and handler threads
    alike."""

    def __init__(self, out_dir: str, device=None, mesh=None):
        with open(os.path.join(out_dir, "serving_meta.json")) as f:
            self.meta = json.load(f)
        if self.meta["format_version"] > FORMAT_VERSION:
            raise ValueError(
                f"serving bundle format {self.meta['format_version']} is "
                f"newer than this loader ({FORMAT_VERSION})")
        if mesh is not None or "mesh" in self.meta:
            raise NotImplementedError(_MULTICHIP)
        self.device = resolve_device(device)
        # the weights go to the device ONCE: left on the host, every call
        # would copy the whole set
        self.weights = torch.load(
            os.path.join(out_dir, WEIGHTS_FILE),
            map_location=self.device, weights_only=True)
        self._modules: Dict[str, list] = {}
        for stage, entries in self.meta["stages"].items():
            self._modules[stage] = [self._load(os.path.join(out_dir, e["file"]),
                                               e["device"])
                                    for e in entries]

    def _load(self, path: str, exported_on: str):
        ep = torch.export.load(path)
        if exported_on != self.device.type:
            try:
                import torch.export.passes as passes
            except ImportError:
                passes = None
            move = getattr(passes, "move_to_device_pass", None)
            if move is None:
                raise ValueError(
                    f"{os.path.basename(path)} was exported on {exported_on} "
                    f"and this torch ({torch.__version__}) cannot move it to "
                    f"{self.device}: export the bundle on {self.device.type}")
            ep = move(ep, self.device)
        return ep.module()

    def stages(self):
        return sorted(self._modules)

    def servable_batch(self, b: int) -> int:
        """Batch to actually send to the device for a ``b``-row request:
        the next power of two, or the smallest explicit bucket >= ``b``. The
        caller owns padding up and truncating back: the same fixed-shape
        policy as ``parallel/pairs.py``'s pair chunks. Power-of-two buckets
        bound the shapes a dynamic batcher sends to log2(max_batch) while
        wasting < 2x rows."""
        mode = self.meta["batch_mode"]
        if mode == "symbolic":
            p = 1
            while p < b:
                p *= 2
            return p
        for n in mode:
            if n >= b:
                return n
        raise ValueError(f"batch {b} exceeds largest bucket {mode[-1]}")

    def __call__(self, stage: str, *arrays) -> torch.Tensor:
        mods = self._modules[stage]
        with torch.inference_mode():
            arrays = tuple(torch.as_tensor(a).to(self.device) for a in arrays)
            if self.meta["batch_mode"] == "symbolic":
                return mods[0](self.weights, *arrays)
            # bucketed: dispatch on the batch axis of the last input (the
            # batched stream input for every stage)
            b = int(arrays[-1].shape[0])
            for m, n in zip(mods, self.meta["batch_mode"]):
                if n == b:
                    return m(self.weights, *arrays)
        raise ValueError(
            f"no {stage} artifact for batch {b}; buckets: "
            f"{self.meta['batch_mode']} (pad to a bucket, or export "
            f"with symbolic batch)")


def load_scorer(out_dir: str, device=None, mesh=None) -> ExportedScorer:
    return ExportedScorer(out_dir, device=device, mesh=mesh)
