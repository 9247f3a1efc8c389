"""The process mesh's training step on gloo ranks of the CPU: FSDP, tensor
parallelism, expert parallelism and their composition
(``vit_ed_tpu_torch/parallel/{mesh,fsdp,tp,ep,compose}.py`` through
``Trainer.train_step``), and the trainer's checks and state under them.

Module fixtures start the ranks of this file as workers (``python
tests/test_torch_mesh_train.py <outdir> two|eight``, with ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set): two ranks run FSDP on
``[2]``, TP on ``[1, 2]`` and EP on ``[1, 1, 2]`` in turn, then the state
cases; eight ranks run TP ∘ EP ∘ FSDP on ``(2, 2, 2)``. While they run, the
parent computes the references. Every case starts from the port's seeded
initial weights (read into the JAX package's model through the
conversion's names and transpositions), takes two updates of the DIV2K trainer's
default loss (AdamW, the bce pair loss, MoE aux terms at 0.01 / 0.001) on
one global batch of 8 stacked pairs per update, and gathers the whole
model (``local_params``). The geometries are those of
tests/test_{fsdp,compose_parallel}.py (embed 32, 2 heads of 16, 2 + 2
blocks; MoE: 2 experts on every 2nd encoder block); the TP case runs the
same model (tests/test_tp.py's 4 heads of 8 are a head_dim the port's
kernels do not take).

Held, per case:

- the ranks' gathered parameters bit-equal, and each rank's training
  parameters and AdamW moments shards of the whole leaves where the rule
  splits them;
- the update within JAX's own tolerance of the port's one-process update
  on the global batch (FSDP 2e-6, composed 3e-6; TP and EP at TP's forward
  bound, atol 2e-5 + rtol 1e-4);
- each rank's loss and pre-clip global gradient norm of every update within
  1e-6 (relative) of the port's one process, and of JAX's sharded step
  widened by the port's one-process gap to JAX: AdamW's update does not
  move when a leaf's gradient is scaled, the norm and the loss do;
- FSDP (``[2]`` and ``(2, 2, 2)``): no leaf that a unit gathered in the
  forward is alive once the loss is computed (the backward gathers the
  units again), and while the shards train the whole model's parameters
  are meta tensors; a bf16 FSDP update with the backward's gather equals,
  bit for bit, the update where autograd keeps the gathered leaves;
- the update within that tolerance, widened by the port's measured
  one-process gap to JAX, of the JAX package's sharded step (its rules on
  the conftest's 8 CPU devices, ``use_pallas=False``: the plain attention,
  as the JAX package's parallel tests run it);
- resume and ``--pretrained`` keep the shards (the restored shards are the
  checkpoint's leaves cut by the rule), and a data-parallel checkpoint
  round-trips through an FSDP run: FSDP resumes it, updates and saves; a
  data-parallel trainer loads that checkpoint strictly, and it matches a
  data-parallel run of the same update.
"""

import contextlib
import gc
import json
import os
import socket
import subprocess
import sys
import types
import weakref

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(_REPO, "configs", "puzzle", "div2k_erosion7_4bin_patch8_64.yaml")
KW = dict(img_size=32, patch_size=16, num_classes=4, embed_dim=32, depth=2, c_depth=2,
          num_heads=2)
MOE_KW = dict(moe_experts=2, moe_interval=2)
STEPS_PER_EPOCH, GLOBAL, UPDATES = 10, 8, 2
# the JAX tests' schedule: cosine from 1e-3 to 1e-5 over 100 steps after 10
# of warm-up from 1e-6, on the LR the trainer scales by the global batch / 256
COMMON = ["MODEL.PJS.EMBED_DIM", "32", "MODEL.PJS.NUM_HEADS", "2", "MODEL.PJS.DEPTH", "2",
          "MODEL.PJS.C_DEPTH", "2", "DATA.IMG_SIZE", "32", "MODEL.PJS.PATCH_SIZE", "16",
          "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.EPOCHS", "10", "TRAIN.WARMUP_EPOCHS", "1",
          "TRAIN.BASE_LR", "0.032", "TRAIN.WARMUP_LR", "3.2e-5", "TRAIN.MIN_LR", "3.2e-4",
          "TRAIN.AUTO_RESUME", "False", "DATA.NUM_WORKERS", "0"]
MOE = ["MODEL.PJS.MOE.EXPERTS", "2", "MODEL.PJS.MOE.INTERVAL", "2"]
# (case, world, model kind, mesh and switches, JAX mesh, JAX rules, tolerance)
CASES = {
    "fsdp": (2, "dense", ["TPU.MESH_SHAPE", "[2]", "TPU.FSDP", "True"],
             ((2,), ("data",)), dict(fsdp=True), 2e-6),
    "tp": (2, "dense", ["TPU.MESH_SHAPE", "[1, 2]", "TPU.TENSOR_PARALLEL", "True"],
           ((1, 2), ("data", "model")), dict(tp=True), None),
    "ep": (2, "moe", ["TPU.MESH_SHAPE", "[1, 1, 2]", "TPU.MESH_AXES", "[data, model, expert]",
                      "TPU.EXPERT_PARALLEL", "True"],
           ((1, 1, 2), ("data", "model", "expert")), dict(ep=True), None),
    "composed": (8, "moe", ["TPU.MESH_SHAPE", "[2, 2, 2]",
                            "TPU.MESH_AXES", "[data, model, expert]",
                            "TPU.TENSOR_PARALLEL", "True", "TPU.EXPERT_PARALLEL", "True",
                            "TPU.FSDP", "True"],
                 ((2, 2, 2), ("data", "model", "expert")),
                 dict(tp=True, ep=True, fsdp=True), 3e-6),
}
TP_ATOL, TP_RTOL = 2e-5, 1e-4     # tests/test_tp.py's forward bound
# loss and pre-clip norm against the port's one process: float32 sums in
# another order (measured gaps at most 1.2e-7 relative; an expert bank's
# squares left out of the norm move it by 2e-6 to 8e-6)
STEP_RTOL = 1e-6
GROUPS = {"two": ("fsdp", "tp", "ep"), "eight": ("composed",)}


def _args(opts, out, tag, batch, resume=None, pretrained=None, data=None, amp=False):
    return types.SimpleNamespace(
        cfg=CFG, device="cpu", mode="train", batch_size=batch, accumulation_steps=None,
        disable_amp=not amp, output=out, tag=tag, opts=COMMON + list(opts), data_path=data,
        pretrained=pretrained, resume=resume, use_checkpoint=False, optim=None)


def global_batch(step):
    rng = np.random.default_rng(100 + step)
    return (rng.normal(size=(GLOBAL, 2, 32, 32, 3)).astype(np.float32),
            (rng.random((GLOBAL, 4)) > 0.5).astype(np.float32))


def _trainer(opts, out, tag, batch, weights=None, **kw):
    from vit_ed_tpu_torch.main import DefaultTrainer

    trainer = DefaultTrainer(_args(opts, out, tag, batch, **kw))
    if weights is not None:
        trainer.model.load_state_dict(torch.load(weights))
    trainer.setup_training(STEPS_PER_EPOCH)
    return trainer


def _step(trainer, step):
    """One update on this data index's share of the global batch; a rank
    that is not its data index's first peer is handed a wrong batch, which
    the trainer must replace with the first peer's."""
    x, y = global_batch(step)
    n = GLOBAL // trainer.data_size
    rows = slice(trainer.data_index * n, (trainer.data_index + 1) * n)
    x, y = x[rows], y[rows]
    if trainer.mesh.peer_source() != trainer.rank:
        x, y = -x, 1.0 - y
    loss, norm = trainer.train_step([{"samples": x, "targets": y}])
    return float(loss), float(norm)


def _whole(trainer):
    return {k: v.detach().clone() for k, v in trainer.local_params().state_dict().items()}


def _traced_step(trainer, step):
    """``_step`` that also counts the leaves the FSDP units gather in the
    forward, how many of them are alive once the loss is computed, and the
    units gathered again in the backward."""
    from vit_ed_tpu_torch.parallel.fsdp import FsdpUnit

    refs, alive, again, in_forward = [], [], [0], [True]
    gather, loss_fn = FsdpUnit.gather, trainer.loss_fn

    def traced_gather(unit, shards):
        out = gather(unit, shards)
        if in_forward[0]:
            refs.extend(weakref.ref(t) for t in out)
        else:
            again[0] += 1
        return out

    def traced_loss(model, batch):
        loss = loss_fn(model, batch)
        gc.collect()
        alive.append(sum(r() is not None for r in refs))
        in_forward[0] = False
        return loss

    FsdpUnit.gather, trainer.loss_fn = traced_gather, traced_loss
    try:
        out = _step(trainer, step)
    finally:
        FsdpUnit.gather, trainer.loss_fn = gather, loss_fn
    return out, {"gathered": len(refs), "alive": alive[0], "again": again[0],
                 "units": len(trainer.train_model._fsdp_units)}


# ------------------------------------------------------------------ worker
def worker(outdir, group):
    from vit_ed_tpu_torch.parallel import mesh
    from vit_ed_tpu_torch.parallel.compose import shard_tensor

    mesh.maybe_init_distributed(backend="gloo", timeout=120)
    rank, world = mesh.process_index(), mesh.process_count()
    said = {}
    for case in GROUPS[group]:
        _, kind, opts, *_ = CASES[case]
        trainer = _trainer(opts + (MOE if kind == "moe" else []), outdir, f"{case}{rank}",
                           GLOBAL // world, os.path.join(outdir, f"{kind}.pt"),
                           data=os.path.join(outdir, "div2k"))
        sampler = trainer.get_dataloader("train").sampler
        sampler.set_epoch(0)
        held = None
        if CASES[case][4].get("fsdp"):
            first, held = _traced_step(trainer, 0)
            steps = [first] + [_step(trainer, s) for s in range(1, UPDATES)]
            held["whole_meta"] = all(p.is_meta for p in trainer.model.parameters())
        else:
            steps = [_step(trainer, s) for s in range(UPDATES)]
        whole = _whole(trainer)
        own = dict(trainer.train_model.named_parameters())
        state = trainer.optimizer.state
        split = {name: [list(p.shape), list(state[p]["exp_avg"].shape),
                        bool(torch.equal(p.detach(), shard_tensor(
                            whole[name], name, trainer.specs[name], trainer.mesh)))]
                 for name, p in own.items() if trainer.specs[name] is not None}
        torch.save(whole, os.path.join(outdir, f"{case}_rank{rank}.pt"))
        said[case] = {"steps": steps, "split": split, "held": held,
                      "specs": {n: list(s) for n, s in trainer.specs.items() if s},
                      "share": {"coords": trainer.mesh.coords, "data": trainer.data_index,
                                "local_batch": trainer.local_batch_size,
                                "indices": [int(i) for i in sampler]}}
    if group == "two":
        said["state"] = _state_cases(outdir, rank)
        said["bf16"] = _bf16_regather(outdir)
    with open(os.path.join(outdir, f"{group}_rank{rank}.json"), "w") as f:
        json.dump(said, f)
    mesh.barrier()
    return 0


def _state_cases(outdir, rank):
    """Resume and --pretrained under FSDP; a data-parallel checkpoint
    through an FSDP run and back."""
    from vit_ed_tpu_torch.parallel.compose import shard_tensor

    dp, fsdp = ["TPU.MESH_SHAPE", "[2]"], CASES["fsdp"][2]
    weights = os.path.join(outdir, "dense.pt")
    a = _trainer(dp, os.path.join(outdir, "dp_a"), "a", GLOBAL // 2, weights)
    _step(a, 0)
    ckpt_a = a._save(0, "checkpoint")
    b = _trainer(fsdp, os.path.join(outdir, "fsdp_b"), "b", GLOBAL // 2, resume=ckpt_a)
    b._load_resume()
    saved = torch.load(ckpt_a, weights_only=False)
    names = b._optimizer_names()
    out = {"resume_params": all(
        torch.equal(p.detach(), shard_tensor(saved["model"][n], n, b.specs[n], b.mesh))
        for n, p in b.train_model.named_parameters()),
        "resume_moments": all(
        torch.equal(b.optimizer.state_dict()["state"][i][k],
                    shard_tensor(v, names[i], b.specs[names[i]], b.mesh))
        for i, entry in saved["optimizer"]["state"].items()
        for k, v in entry.items() if torch.is_tensor(v) and v.dim()),
        "resume_sharded": sum(p.numel() for p in b.train_model.parameters())
        < sum(p.numel() for p in b.model.parameters())}
    _step(b, 1)
    ckpt_b = b._save(0, "checkpoint")
    c = _trainer(dp, os.path.join(outdir, "dp_c"), "c", GLOBAL // 2, resume=ckpt_a)
    c._load_resume()
    _step(c, 1)
    d = _trainer(dp, os.path.join(outdir, "dp_d"), "d", GLOBAL // 2, resume=ckpt_b)
    d._load_resume()           # strict: the FSDP run wrote the whole format
    want, got = c.model.state_dict(), d.model.state_dict()
    out["roundtrip_params"] = max(float((want[k] - got[k]).abs().max()) for k in want)
    ws, gs = c.optimizer.state_dict()["state"], d.optimizer.state_dict()["state"]
    out["roundtrip_moments"] = max(float((ws[i][k] - gs[i][k]).abs().max())
                                   for i in ws for k in ws[i] if ws[i][k].dim())
    out["roundtrip_steps"] = [c.step, d.step]
    e = _trainer(fsdp, os.path.join(outdir, "fsdp_e"), "e", GLOBAL // 2, pretrained=ckpt_b)
    out["pretrained_params"] = all(
        torch.equal(p.detach(), shard_tensor(got[n], n, e.specs[n], e.mesh))
        for n, p in e.train_model.named_parameters())
    return out


def _bf16_regather(outdir):
    """One bf16 FSDP update with the backward's gather (autograd keeps
    references to the units' leaves and their bf16 casts) against the same
    update with autograd keeping the gathered tensors: bit-equal."""
    from vit_ed_tpu_torch.parallel import fsdp
    from vit_ed_tpu_torch.train import engine

    wholes, casts = [], []
    pack, regather = fsdp._pack, engine.regather_in_backward

    def counted_pack(t):
        saved = pack(t)
        if isinstance(saved, fsdp._Saved) and saved.dtype is not None:
            casts.append(saved.dtype)
        return saved

    for keep in (False, True):
        trainer = _trainer(CASES["fsdp"][2], os.path.join(outdir, f"bf16_{keep}"), "bf16",
                           GLOBAL // 2, os.path.join(outdir, "dense.pt"), amp=True)
        fsdp._pack = counted_pack
        if keep:
            engine.regather_in_backward = lambda model: contextlib.nullcontext()
        try:
            _step(trainer, 0)
        finally:
            fsdp._pack, engine.regather_in_backward = pack, regather
        wholes.append(_whole(trainer))
    return {"equal": all(torch.equal(wholes[0][k], wholes[1][k]) for k in wholes[0]),
            "bf16_casts_kept_as_references": sum(d == torch.bfloat16 for d in casts)}


# ------------------------------------------------------------------ parent
def _write_div2k(root, n_train=6, n_valid=2):
    """A DIV2K tree of small PNGs from a seed (the train loader's sampler is
    all the workers read of it)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    for sub, n in (("DIV2K_train_HR", n_train), ("DIV2K_valid_HR", n_valid)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, size=(96, 96, 3), dtype=np.uint8)).save(
                os.path.join(root, sub, f"{i:04d}.png"))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(outdir, group, world):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({"WORLD_SIZE": str(world), "RANK": str(rank), "LOCAL_RANK": "0",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "PYTHONPATH": _REPO + os.pathsep + os.path.join(_REPO, "tests"),
                    "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), outdir, group], env=env,
            cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _finish(procs, timeout=240):
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]


def _flax_params(state):
    """A port state dict as the flax param tree it converts from (the
    conversion read backwards, ``models.convert.flax_leaf``)."""
    from vit_ed_tpu_torch.models.convert import flax_leaf

    tree = {}
    for name, t in state.items():
        parts = name.split(".")
        path = []
        for p in parts[:-1]:
            if p.isdigit():
                path[-1] = f"{path[-1]}_{p}"
            else:
                path.append(p)
        view = flax_leaf(name, t.shape)
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[view.leaf] = np.transpose(t.numpy(), view.torch_dims)
    return tree


def _models():
    """{kind: (JAX model, flax params, port state dict)}: the port's seeded
    initial weights, read into the JAX package's model."""
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict
    from vit_ed_tpu_torch.models.vit_ed import ViTED

    out = {}
    for kind, extra, seed in (("dense", {}, 0), ("moe", MOE_KW, 1)):
        torch.manual_seed(seed)
        state = ViTED(**KW, **extra).state_dict()
        params = _flax_params(state)
        back = jax_params_to_state_dict(params)
        assert back.keys() == state.keys() and all(torch.equal(back[k], state[k]) for k in state)
        out[kind] = (JaxViTED(**KW, **extra, use_pallas=False), params, state)
    return out


def _jax_step(config, model, params):
    """(optimizer, jitted step) of the JAX package on the port's (LR-scaled)
    config: one per model, so that its trace serves every placement."""
    from vit_ed_tpu.train.engine import make_train_step
    from vit_ed_tpu.train.losses import bce_with_logits
    from vit_ed_tpu.train.optim import build_optimizer, build_schedule

    tx = build_optimizer(config, build_schedule(config, STEPS_PER_EPOCH), params)
    moe = config.MODEL.PJS.MOE
    return tx, make_train_step(model, tx, bce_with_logits, 1,
                               moe_aux_weight=moe.AUX_WEIGHT if moe.EXPERTS else 0.0,
                               moe_z_weight=moe.Z_WEIGHT if moe.EXPERTS else 0.0)


def _jax_run(tx, step, params, mesh_spec=None, rules=None):
    """Two updates of the JAX step: on one device, or with ``rules`` on a
    mesh of the conftest's CPU devices, the batch split over ``data``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vit_ed_tpu.parallel.compose import shard_params_composed
    from vit_ed_tpu.parallel.mesh import create_mesh
    from vit_ed_tpu.train.engine import TrainState

    if mesh_spec is None:
        mesh = create_mesh((1,), ("data",), devices=jax.devices()[:1])
        placed = jax.tree.map(jnp.asarray, params)
    else:
        shape, axes = mesh_spec
        mesh = create_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
        placed = shard_params_composed(params, mesh, **rules)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(None, "data")))  # noqa: E731
    state = TrainState(params=placed, opt_state=tx.init(placed),
                       step=jnp.zeros((), jnp.int32))
    # commit every leaf, as the JAX trainer does: the donated step's outputs
    # are committed, and uncommitted inputs would compile it a second time
    rep = NamedSharding(mesh, P())
    state = jax.tree.map(lambda a: a if getattr(a, "committed", True)
                         else jax.device_put(a, rep), state)
    # XLA may hand a leaf back under another (equivalent or propagated)
    # sharding, which would compile the step again: put it back
    placement = jax.tree.map(lambda a: a.sharding, state)
    metrics = []
    for s in range(UPDATES):
        x, y = global_batch(s)
        state, m = step(state, {"samples": put(x[None]), "targets": put(y[None])},
                        jax.random.PRNGKey(0))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        state = jax.device_put(state, placement)
    return jax.tree.map(np.asarray, jax.device_get(state.params)), metrics


def _jax_to_torch(params):
    from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict

    return {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}


def _gap(a, b):
    return max(float(np.max(np.abs(np.asarray(a[k]) - np.asarray(b[k])))) for k in a)


def _within(got, want, tol):
    """Per leaf: |got - want| <= tol (FSDP / composed: an absolute bound, as
    the JAX tests' assert_allclose(atol=...)), else TP's atol + rtol."""
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        bound = tol if tol is not None else TP_ATOL + TP_RTOL * np.abs(w)
        assert np.all(np.abs(g - w) <= bound), (k, float(np.max(np.abs(g - w))))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results and every reference: {case: (ranks' whole
    params, worker reports, port one-process params, JAX one-process
    params, JAX sharded params, {run: [(loss, pre-clip norm) per update]}
    of the port's one process, JAX's one process and JAX's sharded step)}.
    The six JAX steps compile in threads beside the ranks and the port's
    one-process runs."""
    from concurrent.futures import ThreadPoolExecutor

    outdir = str(tmp_path_factory.mktemp("mesh_train"))
    _write_div2k(os.path.join(outdir, "div2k"))
    models = _models()
    for kind, (_, _, state) in models.items():
        torch.save(state, os.path.join(outdir, f"{kind}.pt"))
    procs = {g: _launch(outdir, g, 2 if g == "two" else 8) for g in GROUPS}
    try:
        ones = {kind: _trainer(MOE if kind == "moe" else [], os.path.join(outdir, "one"),
                               kind, GLOBAL, os.path.join(outdir, f"{kind}.pt"))
                for kind in models}
        steps = {kind: _jax_step(ones[kind].config, *models[kind][:2]) for kind in models}
        with ThreadPoolExecutor(len(models) + len(CASES)) as pool:
            jax_one = {kind: pool.submit(_jax_run, *steps[kind], models[kind][1])
                       for kind in models}
            sharded = {case: pool.submit(_jax_run, *steps[c[1]], models[c[1]][1],
                                         c[3], c[4])
                       for case, c in CASES.items()}
            port, port_steps = {}, {}
            for kind, one in ones.items():
                port_steps[kind] = []
                for s in range(UPDATES):
                    loss, norm = one.train_step(
                        [dict(zip(("samples", "targets"), global_batch(s)))])
                    port_steps[kind].append((float(loss), float(norm)))
                port[kind] = {k: v.numpy() for k, v in one.model.state_dict().items()}
            jax_one = {k: f.result() for k, f in jax_one.items()}
            sharded = {k: f.result() for k, f in sharded.items()}
    finally:
        for ps in procs.values():
            _finish(ps)
    out = {}
    for group, cases in GROUPS.items():
        world = 2 if group == "two" else 8
        reports = []
        for rank in range(world):
            with open(os.path.join(outdir, f"{group}_rank{rank}.json")) as f:
                reports.append(json.load(f))
        for case in cases:
            ranks = [torch.load(os.path.join(outdir, f"{case}_rank{r}.pt"))
                     for r in range(world)]
            kind = CASES[case][1]
            steps = {"port_one": port_steps[kind], "jax_one": jax_one[kind][1],
                     "jax_sharded": sharded[case][1]}
            out[case] = (ranks, reports, port[kind], _jax_to_torch(jax_one[kind][0]),
                         _jax_to_torch(sharded[case][0]), steps)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_shards_and_agree(runs, case):
    """The gathered parameters are bit-equal on every rank; each split leaf
    is held as a shard (params and moments) cut from the whole leaf."""
    ranks, reports, *_ = runs[case]
    for r in ranks[1:]:
        assert all(torch.equal(r[k], ranks[0][k]) for k in ranks[0])
    axis = {"fsdp": "data", "tp": "model", "ep": "expert"}.get(case)
    for report in reports:
        split = report[case]["split"]
        assert split, "no leaf is split"
        for name, (shape, moment, cut) in split.items():
            full = list(ranks[0][name].shape)
            assert cut and shape == moment and shape != full, (name, shape, full)
        if axis is not None:
            assert {s[0] for s in report[case]["specs"].values()} == {axis}
    if case == "composed":
        assert {s[0] for s in reports[0][case]["specs"].values()} == {"data", "model",
                                                                      "expert"}


@pytest.mark.parametrize("case", list(CASES))
def test_update_equals_one_process(runs, case):
    ranks, _, port_one, *_ = runs[case]
    got = {k: v.numpy() for k, v in ranks[0].items()}
    _within(got, port_one, CASES[case][5])


@pytest.mark.parametrize("case", list(CASES))
def test_update_equals_jax_sharded_step(runs, case):
    """The port's sharded update against the JAX package's sharded step on
    the same rules, within JAX's tolerance widened by the port's measured
    one-process gap to JAX's one-process step."""
    ranks, _, port_one, jax_one, jax_sharded, _ = runs[case]
    got = {k: v.numpy() for k, v in ranks[0].items()}
    gap = _gap(port_one, jax_one)
    assert gap < 1e-4, gap          # the two one-process steps agree
    tol = CASES[case][5]
    for k in jax_sharded:
        g, w = got[k], jax_sharded[k]
        bound = (tol if tol is not None else TP_ATOL + TP_RTOL * np.abs(w)) + gap
        assert np.all(np.abs(g - w) <= bound), (k, float(np.max(np.abs(g - w))), gap)


@pytest.mark.parametrize("case", list(CASES))
def test_data_share_follows_the_data_axis(runs, case):
    """Ranks lie row-major on the mesh; the ranks of one data index draw the
    same ``BATCH_SIZE x world / data`` samples and the data indices draw
    their own (the updates above also equal one process although every
    rank but a data index's first was handed a wrong batch)."""
    _, reports, *_ = runs[case]
    world, _, _, (shape, axes), *_ = CASES[case]
    shares = [r[case]["share"] for r in reports]
    size = dict(zip(axes, shape)).get("data", 1)
    for rank, share in enumerate(shares):
        coords = np.unravel_index(rank, shape)
        assert share["coords"] == {a: int(c) for a, c in zip(axes, coords)}
        assert share["data"] == share["coords"].get("data", 0)
        assert share["local_batch"] == (GLOBAL // world) * world // size
    by_index = {}
    for share in shares:
        by_index.setdefault(share["data"], []).append(share["indices"])
    assert len(by_index) == size
    for draws in by_index.values():
        assert all(d == draws[0] for d in draws)
    if size > 1:
        assert by_index[0][0] != by_index[1][0]


def _relative(a, b):
    return float(np.max(np.abs(np.subtract(a, b)) / np.abs(b)))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_norm_equal_one_process(runs, case):
    """Every rank's loss and pre-clip global gradient norm of each update
    equal the port's one process on the global batch (STEP_RTOL), and JAX's
    sharded step within that bound widened by the port's one-process gap to
    JAX's one process. A wrong 1 / data loss weight, a sharded leaf's
    squares summed over the wrong group or a replicated leaf counted twice
    moves them, although AdamW's update would not show it."""
    _, reports, _, _, _, steps = runs[case]
    one, jax_one, jax_sharded = (np.asarray(steps[k]) for k in
                                 ("port_one", "jax_one", "jax_sharded"))
    gap = _relative(one, jax_one)
    assert gap < 1e-4, (one, jax_one)
    for rank, report in enumerate(reports):
        got = np.asarray(report[case]["steps"])
        assert _relative(got, one) <= STEP_RTOL, (rank, got, one)
        assert _relative(got, jax_sharded) <= STEP_RTOL + gap, (rank, got, jax_sharded)


@pytest.mark.parametrize("case", ["fsdp", "composed"])
def test_fsdp_holds_no_whole_model(runs, case):
    """Once the loss is computed, no leaf that an FSDP unit gathered in the
    forward is alive (autograd keeps references and the backward gathers
    every unit again), and the whole model's parameters are meta tensors
    while the shards train."""
    _, reports, *_ = runs[case]
    for report in reports:
        held = report[case]["held"]
        assert held["gathered"] > 0 and held["alive"] == 0, held
        assert held["again"] >= held["units"] > 0, held
        assert held["whole_meta"], held


def test_fsdp_bf16_regather_is_exact(runs):
    """A bf16 FSDP update whose backward gathers the units again (and casts
    them again) equals, bit for bit, the update where autograd keeps the
    gathered leaves and their casts."""
    for report in runs["fsdp"][1]:
        bf16 = report["bf16"]
        assert bf16["equal"] and bf16["bf16_casts_kept_as_references"] > 0, bf16


def test_state_keeps_shards_and_round_trips(runs):
    """Resume and --pretrained restore this rank's shards of the
    checkpoint's leaves (parameters and AdamW moments); a data-parallel
    checkpoint resumed by FSDP, updated and saved loads strictly into a
    data-parallel trainer and equals a data-parallel run of that update."""
    reports = runs["fsdp"][1]
    for report in reports:
        state = report["state"]
        assert state["resume_params"] and state["resume_moments"]
        assert state["resume_sharded"] and state["pretrained_params"]
        assert state["roundtrip_steps"] == [2, 2]
        assert state["roundtrip_params"] <= CASES["fsdp"][5], state
        assert state["roundtrip_moments"] <= 1e-6, state


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1], sys.argv[2]))
