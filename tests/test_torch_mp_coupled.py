"""The port on two processes where a loss or a statistic couples the global
batch (``torch.distributed`` over gloo, on the CPU): SyncBN in the
BatchNorm types, the MoE banks' global aux terms, and ``hisfrag_vit``'s
batch-hard mining over the gathered batch.

A module fixture starts two ranks of this file as the worker
(``python tests/test_torch_mp_coupled.py <outdir>``, with ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set) once; while they run,
the parent computes the JAX references. Each rank, on weights converted
from the JAX package's models, on its own seeded batch:

- runs the two gradient-carrying collectives of ``parallel/mesh.py`` on
  rank-dependent values and cotangents;
- takes one SGD update through ``Trainer.train_step`` of each BatchNorm
  type (``resnet``, ``mixconv``, ``ss``, ``ss2``, ``ss2ce``; 64 px, float64;
  ``resnet`` and ``mixconv`` with hisfrag_vit's gathered triplet loss, the
  SimSiam types with their mean losses), of a tiny MoE pjs through the
  hisfrag trainer (top-1 and top-2, router jitter 0.1), and of a tiny
  ``hisfrag_vit`` ViT;
- builds the ``lr_finder`` trainer and one with a mesh switch (both raise).

The parent holds: the ranks' parameters and running statistics bit-equal;
each update within 1e-4 (BatchNorm, float64) or 1e-5 (MoE, hisfrag_vit,
float32) of each tensor's max of one process's update on the concatenated
batch; the BatchNorm gradients and running statistics within 1e-4 of
flax's on that batch (float64 under ``jax.enable_x64``); the MoE aux terms
of a jitter-free training forward within 1e-6 of the JAX model's on that
batch; the hisfrag_vit loss within 1e-6 of the JAX
``batch_wise_triplet_loss`` on the concatenated embeddings. Each coupled
case also shows that its data makes a rank's own computation differ from
the global one by more than the tolerance.
"""

import json
import os
import subprocess
import sys
import types

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import numpy as np
import pytest
import torch

from test_torch_multiprocess import launch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HISFRAG_CFG = os.path.join(_REPO, "configs", "hisfrag", "hisfrag20_patch16_512.yaml")
DIV2K_CFG = os.path.join(_REPO, "configs", "puzzle", "div2k_erosion7_4bin_patch8_64.yaml")
BN_B, MOE_B, VIT_B = 4, 6, 6        # images per rank and update
# the BatchNorm types at 64 px (MODEL.TYPE, opts), as tests/test_torch_resnet.py
BN_TYPES = {
    "resnet": ["MODEL.RES.ARCH", "resnet18"],
    "mixconv": ["MODEL.MIXCONV.ARCH", "resnet18", "MODEL.MIXCONV.MIX_DEPTH", "2",
                "MODEL.MIXCONV.OUT_CHANNELS", "32", "MODEL.MIXCONV.OUT_ROWS", "2"],
    "ss": ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32", "MODEL.SS.PRED_DIM", "16"],
    "ss2": ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32", "MODEL.SS.PRED_DIM", "16"],
    "ss2ce": ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32", "MODEL.SS.PRED_DIM", "16",
              "MODEL.SS.N_CLASSES", "5"],
}
MOE_KW = dict(img_size=32, patch_size=16, embed_dim=128, depth=2, c_depth=1, num_heads=2,
              num_classes=1)
MOE_KS = (1, 2)
VIT_OPTS = ["MODEL.TYPE", "vit", "MODEL.NUM_CLASSES", "16", "MODEL.VIT.EMBED_DIM", "64",
            "MODEL.VIT.NUM_HEADS", "2", "MODEL.VIT.DEPTH", "2", "MODEL.VIT.PATCH_SIZE", "16",
            "DATA.IMG_SIZE", "32"]
COMMON = ["MODEL.DROP_PATH_RATE", "0.0", "TRAIN.WARMUP_EPOCHS", "0", "TRAIN.AUTO_RESUME",
          "False", "DATA.NUM_WORKERS", "0", "TRAIN.OPTIMIZER.NAME", "sgd"]


def _bn_opts(kind):
    return ["MODEL.TYPE", kind, "DATA.IMG_SIZE", "64", *BN_TYPES[kind]] + COMMON


def _moe_opts(k):
    kw = MOE_KW
    return ["MODEL.PJS.EMBED_DIM", str(kw["embed_dim"]), "MODEL.PJS.NUM_HEADS",
            str(kw["num_heads"]), "MODEL.PJS.DEPTH", str(kw["depth"]), "MODEL.PJS.C_DEPTH",
            str(kw["c_depth"]), "DATA.IMG_SIZE", str(kw["img_size"]), "MODEL.PJS.PATCH_SIZE",
            str(kw["patch_size"]), "MODEL.NUM_CLASSES", str(kw["num_classes"]),
            "MODEL.PJS.MOE.EXPERTS", "4", "MODEL.PJS.MOE.INTERVAL", "1",
            "MODEL.PJS.MOE.ROUTE_K", str(k), "MODEL.PJS.MOE.JITTER", "0.1"] + COMMON


# ------------------------------------------------------------------ data
def _bn_batch(kind, rank):
    """Rank ``rank``'s images and labels: labels (0, 0, 1, 1) on rank 0 and
    (1, 1, 2, 2) on rank 1, so that classes cross the ranks."""
    rng = np.random.default_rng(40 + rank)
    shape = (BN_B, 2, 64, 64, 3) if kind == "ss" else (BN_B, 64, 64, 3)
    return (rng.standard_normal(shape).astype(np.float32),
            (np.repeat(np.arange(BN_B // 2), 2) + rank).astype(np.int32))


def _moe_images(rank):
    rng = np.random.default_rng(60 + rank)
    return (rng.normal(size=(MOE_B, 32, 32, 3)).astype(np.float32),
            rng.permutation(np.repeat(np.arange(3), 2)).astype(np.int32))


def _vit_batch(rank):
    """Three classes of two per rank, the last one shared with the other
    rank (2 on rank 0 and rank 1)."""
    rng = np.random.default_rng(80 + rank)
    return (rng.normal(size=(VIT_B, 32, 32, 3)).astype(np.float32),
            (np.repeat(np.arange(3), 2) + 2 * rank).astype(np.int32))


# ------------------------------------------------------------------ trainers
def _args(cfg, opts, out, tag, batch):
    return types.SimpleNamespace(
        cfg=cfg, device="cpu", mode="train", batch_size=batch, accumulation_steps=None,
        disable_amp=True, output=out, tag=tag, opts=opts, data_path=None, pretrained=None,
        resume=None, use_checkpoint=False, optim=None)


def _bn_trainer_cls():
    """hisfrag_vit's trainer with each BatchNorm type's loss: the gathered
    triplet loss of the embedding models, the SimSiam losses (means over
    the local batch) of the others."""
    from vit_ed_tpu_torch.hisfrag_vit import HisfragVitTrainer
    from vit_ed_tpu_torch.train.engine import Trainer

    class BNTrainer(HisfragVitTrainer):
        def make_loss_fn(self, criterion):
            kind = self.config.MODEL.TYPE
            if kind in ("resnet", "mixconv"):
                return super().make_loss_fn(criterion)

            def loss_fn(model, batch):
                return _simsiam_loss(kind, model(batch["samples"]), batch["targets"])

            return loss_fn

        def rank_loss_weight(self):
            if self.config.MODEL.TYPE in ("resnet", "mixconv"):
                return super().rank_loss_weight()
            return Trainer.rank_loss_weight(self)

    return BNTrainer


def _simsiam_loss(kind, out, labels):
    from vit_ed_tpu_torch.train.losses import negative_cosine_similarity as ncs

    if kind == "ss":
        p1, p2, z1, z2 = out
        return 0.5 * (ncs(p1, z2) + ncs(p2, z1))
    loss = ncs(out[0], out[1])
    if kind == "ss2ce":
        loss = loss + torch.nn.functional.cross_entropy(out[2], labels.long())
    return loss


def _to_float64(model):
    """``model`` in float64 in place: weights, buffers and compute dtype."""
    model.double()
    for mod in model.modules():
        if getattr(mod, "dtype", None) == torch.float32:
            mod.dtype = torch.float64
    return model


def _bn_trainer(kind, out, tag, batch):
    t = _bn_trainer_cls()(_args(HISFRAG_CFG, _bn_opts(kind), out, tag, batch))
    t.model.load_state_dict(torch.load(os.path.join(os.path.dirname(out), f"bn_{kind}.pth"),
                                       weights_only=True))
    _to_float64(t.model)
    t.setup_training(10)
    return t


def _moe_trainer(k, out, tag, batch):
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer

    t = HisfragTrainer(_args(HISFRAG_CFG, _moe_opts(k), out, tag, batch))
    t.model.load_state_dict(torch.load(os.path.join(os.path.dirname(out), f"moe{k}.pth"),
                                       weights_only=True))
    t.setup_training(10)
    return t


def _vit_trainer(out, tag, batch):
    from vit_ed_tpu_torch.hisfrag_vit import HisfragVitTrainer

    t = HisfragVitTrainer(_args(HISFRAG_CFG, VIT_OPTS + COMMON, out, tag, batch))
    t.model.load_state_dict(torch.load(os.path.join(os.path.dirname(out), "vit.pth"),
                                       weights_only=True))
    t.setup_training(10)
    return t


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _grads(model):
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()]).numpy()


def _stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items() if "running_" in k}


def _moe_aux_free(model, x):
    """The aux terms [banks, 2] of a training forward with the router's
    jitter off (the JAX model's deterministic terms)."""
    from vit_ed_tpu_torch.models.moe import MoeMlp

    banks = [m for m in model.modules() if isinstance(m, MoeMlp)]
    jitters = [m.jitter for m in banks]
    for m in banks:
        m.jitter = 0.0
    try:
        with torch.no_grad():
            _, aux = model.train().encode(x, with_aux=True)
    finally:
        for m, j in zip(banks, jitters):
            m.jitter = j
    return aux.numpy()


# ------------------------------------------------------------------ worker
def _worker(outdir):
    from vit_ed_tpu_torch.hisfrag_vit import HisfragVitTrainer
    from vit_ed_tpu_torch.lr_finder import LrFinderTrainer
    from vit_ed_tpu_torch.parallel import mesh

    mesh.maybe_init_distributed(backend="gloo", timeout=60)
    rank = mesh.process_index()
    assert mesh.process_count() == 2
    out = os.path.join(outdir, "o")

    def save(name, arr):
        np.save(os.path.join(outdir, f"rank{rank}_{name}.npy"), np.asarray(arr))

    # the collectives: values and cotangents that differ by rank
    x = torch.arange(6.0).reshape(3, 2).mul(rank + 1).requires_grad_()
    w = torch.arange(12.0).reshape(6, 2) + 10 * rank
    gathered = mesh.all_gather_rows(x)
    (gathered * w).sum().backward()
    save("gathered", gathered.detach())
    save("gather_grad", x.grad)
    x.grad = None
    summed = mesh.all_reduce_sum(x)
    (summed * w[:3]).sum().backward()
    save("summed", summed.detach())
    save("sum_grad", x.grad)

    for kind in BN_TYPES:
        t = _bn_trainer(kind, out, f"bn_{kind}_r", BN_B)
        images, labels = _bn_batch(kind, rank)
        loss, _ = t.train_step([t.prepare_data(images, labels)])
        save(f"bn_{kind}_params", _params(t.model))
        save(f"bn_{kind}_grads", _grads(t.model))
        torch.save(_stats(t.model), os.path.join(outdir, f"rank{rank}_bn_{kind}_stats.pt"))

    for k in MOE_KS:
        t = _moe_trainer(k, out, f"moe{k}_r", MOE_B)
        images, labels = _moe_images(rank)
        save(f"moe{k}_free_aux", _moe_aux_free(t.model, torch.from_numpy(images)))
        np.random.seed(rank)
        batch = t.prepare_data(images, labels)
        np.savez(os.path.join(outdir, f"rank{rank}_moe{k}_batch.npz"), **batch)
        loss, _ = t.train_step([batch])
        save(f"moe{k}_loss", loss.item())
        save(f"moe{k}_aux", t.moe_aux)
        save(f"moe{k}_params", _params(t.model))
        save(f"moe{k}_grads", _grads(t.model))

    t = _vit_trainer(out, "vit_r", VIT_B)
    images, labels = _vit_batch(rank)
    with torch.no_grad():
        save("vit_emb", t.model.train()(torch.from_numpy(images)).float())
    loss, _ = t.train_step([t.prepare_data(images, labels)])
    save("vit_loss", loss.item())
    save("vit_params", _params(t.model))
    save("vit_grads", _grads(t.model))
    assert isinstance(t, HisfragVitTrainer)

    said = {}
    for name, build in (
            ("lr_finder", lambda: LrFinderTrainer(_args(DIV2K_CFG, COMMON, out, "lrf", 2))),
            ("mesh", lambda: HisfragVitTrainer(_args(
                HISFRAG_CFG, VIT_OPTS + COMMON + ["TPU.MESH_SHAPE", "[1, 2]",
                                                  "TPU.SEQ_PARALLEL", "True"],
                out, "mesh", 2)))):
        try:
            build()
            said[name] = None
        except NotImplementedError as e:
            said[name] = str(e)
    with open(os.path.join(outdir, f"rank{rank}_refused.json"), "w") as f:
        json.dump(said, f)
    open(os.path.join(outdir, f"rank{rank}_ok"), "w").close()


# ------------------------------------------------------------------ parent
def _jax_weights(outdir):
    """Save the port's weights of every model, converted from the JAX
    package's; returns the flax modules and variables by name."""
    import jax
    import jax.numpy as jnp

    from test_torch_resnet import _pair
    from vit_ed_tpu.models import build_model as jax_build_model
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu_torch.config import get_config
    from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict

    refs = {}
    for kind in BN_TYPES:
        name = "resnet18" if kind == "resnet" else kind
        jm, variables, model = _pair(name, _bn_batch(kind, 0)[0], perturb_stats=False)
        torch.save(model.state_dict(), os.path.join(outdir, f"bn_{kind}.pth"))
        refs[f"bn_{kind}"] = (jm, variables)
    jm = JaxViTED(**MOE_KW, use_pallas=False, moe_experts=4, moe_interval=1, moe_jitter=0.1)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 2, 32, 32, 3)))["params"])
    for k in MOE_KS:     # top-k routing leaves the tree as it is
        torch.save(jax_params_to_state_dict(params), os.path.join(outdir, f"moe{k}.pth"))
        refs[f"moe{k}"] = (jm.clone(moe_route_k=k), params)
    cfg = get_config(types.SimpleNamespace(cfg=HISFRAG_CFG, opts=VIT_OPTS, disable_amp=True))
    jm = jax_build_model(cfg).clone(use_pallas=False)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 32, 32, 3)))["params"])
    torch.save(jax_params_to_state_dict(params), os.path.join(outdir, "vit.pth"))
    return refs


def _flax_bn_step(kind, jm, variables):
    """(gradients, new running statistics) as port state dicts, of one
    float64 flax step of ``kind``'s loss on the concatenated batch."""
    import jax
    import jax.numpy as jnp
    import optax

    from test_torch_resnet import _to_float64 as jax_f64
    from vit_ed_tpu.train.losses import batch_wise_triplet_loss, negative_cosine_similarity
    from vit_ed_tpu_torch.models.convert import flax_variables_to_state_dict

    x = np.concatenate([_bn_batch(kind, r)[0] for r in range(2)]).astype(np.float64)
    labels = jnp.asarray(np.concatenate([_bn_batch(kind, r)[1] for r in range(2)]))
    with jax.enable_x64(True):
        module = jm.clone(dtype=jnp.float64)
        v = jax_f64(variables)

        def loss_fn(params):
            out, mutated = module.apply({"params": params, "batch_stats": v["batch_stats"]},
                                        jnp.asarray(x), train=True, mutable=["batch_stats"])
            if kind in ("resnet", "mixconv"):
                loss = batch_wise_triplet_loss(out, labels, margin=0.5)
            elif kind == "ss":
                p1, p2, z1, z2 = out
                loss = 0.5 * (negative_cosine_similarity(p1, z2)
                              + negative_cosine_similarity(p2, z1))
            else:
                loss = negative_cosine_similarity(out[0], out[1])
                if kind == "ss2ce":
                    loss = loss + optax.softmax_cross_entropy_with_integer_labels(
                        out[2], labels).mean()
            return loss, mutated["batch_stats"]

        (_, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v["params"])
        grads, stats = jax.device_get(grads), jax.device_get(stats)
    to_sd = lambda tree: {k: t.double() for k, t in tree.items()}  # noqa: E731
    return (to_sd(flax_variables_to_state_dict(grads)),
            to_sd(flax_variables_to_state_dict({}, stats)))


def _jax_refs(refs):
    """The JAX references that need no rank output: the BatchNorm steps and
    the MoE aux terms on the concatenated batches."""
    import jax
    import jax.numpy as jnp

    from concurrent.futures import ThreadPoolExecutor

    # XLA compiles outside the interpreter lock: three at a time
    with ThreadPoolExecutor(3) as pool:
        steps = {kind: pool.submit(_flax_bn_step, kind, *refs[f"bn_{kind}"])
                 for kind in BN_TYPES}
        out = {f"bn_{kind}": f.result() for kind, f in steps.items()}
    for k in MOE_KS:
        jm, params = refs[f"moe{k}"]
        x = np.concatenate([_moe_images(r)[0] for r in range(2)])
        _, mutated = jax.jit(lambda p, a: jm.apply(
            {"params": p}, a, forward_first_part=True, mutable=["moe_aux"]))(
            params, jnp.asarray(x))
        aux = mutated["moe_aux"]
        banks = sorted(aux)
        out[f"moe{k}"] = np.asarray([[float(aux[b]["mlp"]["load_balance"][0]),
                                      float(aux[b]["mlp"]["router_z"][0])] for b in banks])
    return out


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("torch_mp_coupled"))
    refs = _jax_weights(outdir)
    procs = launch([os.path.abspath(__file__), outdir])
    try:
        jax_out = _jax_refs(refs)          # while the ranks run
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{text[-4000:]}"
    return outdir, jax_out


def _load(outdir, rank, name):
    return np.load(os.path.join(outdir, f"rank{rank}_{name}.npy"))


def _sizes(model):
    return [p.numel() for p in model.parameters()]


def _assert_close(got, want, sizes, tol, floor=0.0):
    """Each tensor of the flat vectors within ``tol`` of its own max (or of
    ``floor`` where that is larger)."""
    lo = 0
    for i, n in enumerate(sizes):
        g, w = got[lo:lo + n], want[lo:lo + n]
        assert np.max(np.abs(g - w)) <= tol * max(np.max(np.abs(w)), floor), (i, n)
        lo += n
    assert lo == len(want) == len(got)


def _stats_reading(got, want):
    """The largest reading of running statistics against ``want`` after one
    training forward from their init values 0 / 1: a variance against its
    max, a mean against the larger of its max and 0.01 x its batch's std
    (tests/test_torch_resnet.py::_close_stats)."""
    worst = 0.0
    for k, v in got.items():
        w = want[k].double().numpy()
        scale = np.abs(w).max()
        if k.endswith("running_mean"):
            var = (want[k.replace("mean", "var")].double().numpy() - 0.99) / 0.01
            scale = max(scale, 0.01 * np.sqrt(max(var.max(), 0.0)))
        worst = max(worst, float(np.abs(v.double().numpy() - w).max() / scale))
    return worst


def _both(outdir, name):
    """Rank 0's array, after asserting rank 1's equal bit for bit."""
    a, b = _load(outdir, 0, name), _load(outdir, 1, name)
    np.testing.assert_array_equal(a, b)
    return a


# ------------------------------------------------------------------ tests
def test_both_ranks_finish(coupled):
    outdir, _ = coupled
    for rank in range(2):
        assert os.path.exists(os.path.join(outdir, f"rank{rank}_ok"))


def test_collectives_carry_the_gradient(coupled):
    """all_gather_rows: the ranks' rows in rank order, the gradient this
    rank's rows of the summed cotangents; all_reduce_sum: the sum, the
    gradient the summed cotangent."""
    outdir, _ = coupled
    xs = [np.arange(6.0).reshape(3, 2) * (r + 1) for r in range(2)]
    ws = [np.arange(12.0).reshape(6, 2) + 10 * r for r in range(2)]
    for rank in range(2):
        np.testing.assert_array_equal(_load(outdir, rank, "gathered"), np.concatenate(xs))
        np.testing.assert_array_equal(_load(outdir, rank, "gather_grad"),
                                      (ws[0] + ws[1])[3 * rank:3 * rank + 3])
        np.testing.assert_array_equal(_load(outdir, rank, "summed"), xs[0] + xs[1])
        np.testing.assert_array_equal(_load(outdir, rank, "sum_grad"),
                                      ws[0][:3] + ws[1][:3])


@pytest.mark.parametrize("kind", list(BN_TYPES))
def test_syncbn_update_equals_one_process(coupled, kind):
    """Ranks bit-equal; the float64 gradients, parameters and running
    statistics within 1e-4 of one process's update on the concatenated
    batch, whose statistics differ from rank 0's own batch's by more."""
    outdir, _ = coupled
    params, grads = _both(outdir, f"bn_{kind}_params"), _both(outdir, f"bn_{kind}_grads")
    stats = [torch.load(os.path.join(outdir, f"rank{r}_bn_{kind}_stats.pt"), weights_only=True)
             for r in range(2)]
    assert all(torch.equal(v, stats[1][k]) for k, v in stats[0].items())

    out = os.path.join(outdir, "o")
    t = _bn_trainer(kind, out, f"bn_{kind}_one", 2 * BN_B)
    parts = [_bn_batch(kind, r) for r in range(2)]
    t.train_step([t.prepare_data(np.concatenate([p[0] for p in parts]),
                                 np.concatenate([p[1] for p in parts]))])
    sizes, want = _sizes(t.model), _grads(t.model)
    # a gradient that is zero in exact arithmetic (a bias that feeds an
    # affine-free BatchNorm) within 1e-10 of the largest
    _assert_close(grads, want, sizes, 1e-4, floor=1e-6 * np.abs(want).max())
    _assert_close(params, _params(t.model), sizes, 1e-4)
    one = _stats(t.model)
    assert _stats_reading(stats[0], one) <= 1e-4

    # rank 0's batch alone gives other statistics: per-rank ones fail here
    local = _bn_trainer(kind, out, f"bn_{kind}_local", BN_B)
    with torch.no_grad():
        local.model.train()(torch.from_numpy(parts[0][0]))
    assert _stats_reading(_stats(local.model), one) > 1e-4


@pytest.mark.parametrize("kind", list(BN_TYPES))
def test_syncbn_update_matches_flax(coupled, kind):
    """The ranks' float64 gradients, clipped as the step clips them (each
    within 1e-4 of its own max; a gradient that is zero in exact
    arithmetic, as that of a bias feeding an affine-free BatchNorm, within
    1e-10 of the largest) and running statistics (1e-4) against flax's on
    the concatenated batch."""
    from vit_ed_tpu_torch.config import get_config
    from vit_ed_tpu_torch.models.build import build_model

    outdir, jax_out = coupled
    want_grads, want_stats = jax_out[f"bn_{kind}"]
    config = get_config(_args(HISFRAG_CFG, _bn_opts(kind), "", "", BN_B))
    model = build_model(config)
    names = [n for n, _ in model.named_parameters()]
    assert set(names) == set(want_grads)
    want = np.concatenate([want_grads[n].reshape(-1).numpy() for n in names])
    want = want * min(1.0, config.TRAIN.CLIP_GRAD / (np.linalg.norm(want) + 1e-6))
    largest = float(np.abs(want).max())
    _assert_close(_load(outdir, 0, f"bn_{kind}_grads"), want, _sizes(model), 1e-4,
                  floor=1e-6 * largest)
    got = torch.load(os.path.join(outdir, f"rank0_bn_{kind}_stats.pt"), weights_only=True)
    assert set(got) == {k for k in want_stats if "running_" in k}
    assert _stats_reading(got, want_stats) <= 1e-4


def _moe_global_batch(outdir, k):
    parts = [dict(np.load(os.path.join(outdir, f"rank{r}_moe{k}_batch.npz"))) for r in range(2)]
    for key in ("gi", "gj"):
        parts[1][key] = parts[1][key] + MOE_B
    return {key: np.concatenate([p[key] for p in parts]) for key in parts[0]}


@pytest.mark.parametrize("k", MOE_KS)
def test_moe_update_equals_one_process(coupled, k):
    """Ranks bit-equal; with the router's jitter drawn for the global batch
    the loss, the aux terms (1e-6) and the gradients and parameters (1e-5 of
    each max) of one process's update on the concatenated batch."""
    outdir, _ = coupled
    params, grads = _both(outdir, f"moe{k}_params"), _both(outdir, f"moe{k}_grads")
    aux = _both(outdir, f"moe{k}_aux")
    t = _moe_trainer(k, os.path.join(outdir, "o"), f"moe{k}_one", 2 * MOE_B)
    loss, _ = t.train_step([_moe_global_batch(outdir, k)])
    assert abs(float(_load(outdir, 0, f"moe{k}_loss")) - loss.item()) <= 1e-5
    np.testing.assert_allclose(aux, t.moe_aux.numpy(), rtol=1e-6, atol=1e-6)
    sizes = _sizes(t.model)
    _assert_close(grads, _grads(t.model), sizes, 1e-5)
    _assert_close(params, _params(t.model), sizes, 1e-5)


@pytest.mark.parametrize("k", MOE_KS)
def test_moe_aux_terms_match_jax(coupled, k):
    """The jitter-free aux terms of the ranks' training forward against the
    JAX model's on the concatenated batch (1e-6), and far from rank 0's own
    batch's terms."""
    outdir, jax_out = coupled
    got = _both(outdir, f"moe{k}_free_aux")
    want = jax_out[f"moe{k}"]
    assert got.shape == want.shape == (MOE_KW["depth"], 2)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    t = _moe_trainer(k, os.path.join(outdir, "o"), f"moe{k}_local", MOE_B)
    local = _moe_aux_free(t.model, torch.from_numpy(_moe_images(0)[0]))
    assert np.abs(local[:, 0] - want[:, 0]).max() > 1e-4


def test_hisfrag_vit_update_equals_one_process(coupled):
    """Ranks bit-equal; the gathered mining's loss, gradients and
    parameters within 1e-5 of one process's on the concatenated batch, in
    which some rank-0 anchor's hardest negative lies on rank 1."""
    outdir, _ = coupled
    params, grads = _both(outdir, "vit_params"), _both(outdir, "vit_grads")
    t = _vit_trainer(os.path.join(outdir, "o"), "vit_one", 2 * VIT_B)
    parts = [_vit_batch(r) for r in range(2)]
    loss, _ = t.train_step([t.prepare_data(np.concatenate([p[0] for p in parts]),
                                           np.concatenate([p[1] for p in parts]))])
    assert abs(float(_both(outdir, "vit_loss")) - loss.item()) <= 1e-5
    sizes = _sizes(t.model)
    _assert_close(grads, _grads(t.model), sizes, 1e-5)
    _assert_close(params, _params(t.model), sizes, 1e-5)

    emb = np.concatenate([_load(outdir, r, "vit_emb") for r in range(2)])
    e = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    d = 1.0 - e @ e.T
    labels = np.concatenate([p[1] for p in parts])
    neg = labels[:, None] != labels[None, :]
    hardest = np.where(neg, d, np.inf)[:VIT_B].argmin(axis=1)
    assert (hardest >= VIT_B).any()


def test_hisfrag_vit_loss_matches_jax(coupled):
    """The two-rank loss (the sum of the ranks' shares) against the JAX
    ``batch_wise_triplet_loss`` on the concatenated embeddings (1e-6); the
    mean of the ranks' own losses is another number."""
    import jax.numpy as jnp

    from vit_ed_tpu.train.losses import batch_wise_triplet_loss

    outdir, _ = coupled
    embs = [_load(outdir, r, "vit_emb") for r in range(2)]
    labels = [_vit_batch(r)[1] for r in range(2)]
    want = float(batch_wise_triplet_loss(jnp.asarray(np.concatenate(embs)),
                                         jnp.asarray(np.concatenate(labels)), margin=0.5))
    assert abs(float(_both(outdir, "vit_loss")) - want) <= 1e-6
    own = np.mean([float(batch_wise_triplet_loss(jnp.asarray(e), jnp.asarray(lab), margin=0.5))
                   for e, lab in zip(embs, labels)])
    assert abs(own - want) > 1e-4


def test_refusals_under_two_ranks(coupled):
    """lr_finder and a switch the port does not run yet (SEQ_PARALLEL on a
    [1, 2] mesh: ROADMAP item 12b part 2) still raise on two ranks."""
    outdir, _ = coupled
    for rank in range(2):
        with open(os.path.join(outdir, f"rank{rank}_refused.json")) as f:
            said = json.load(f)
        assert "no collective" in said["lr_finder"], said
        assert "item 12b" in said["mesh"], said


def test_no_group_under_world_size_raises(monkeypatch):
    """A launcher's WORLD_SIZE 2 without a group: the collectives, a
    training BatchNorm and an MoE bank raise instead of computing the local
    batch's statistics; without WORLD_SIZE the collectives are the
    identity."""
    from vit_ed_tpu_torch.models.moe import MoeMlp
    from vit_ed_tpu_torch.models.resnet import BatchNorm
    from vit_ed_tpu_torch.parallel import mesh

    x = torch.randn(4, 3)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("SLURM_NTASKS", raising=False)
    assert mesh.all_reduce_sum(x) is x and mesh.all_gather_rows(x) is x
    monkeypatch.setenv("WORLD_SIZE", "2")
    for call in (lambda: mesh.all_reduce_sum(x), lambda: mesh.all_gather_rows(x),
                 lambda: BatchNorm(3).train()(x),
                 lambda: MoeMlp(3, 4, 2).train()(x[None])):
        with pytest.raises(RuntimeError, match="no process group is up"):
            call()
    # eval mode reads no statistic of the batch
    assert BatchNorm(3).eval()(x).shape == x.shape


if __name__ == "__main__":
    _worker(sys.argv[1])
