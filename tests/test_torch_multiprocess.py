"""The port on two processes (``torch.distributed`` over gloo, on the CPU):
the twin of tests/test_multiprocess.py.

A module fixture starts two ranks of this file as the worker
(``python tests/test_torch_multiprocess.py <outdir>``, with ``WORLD_SIZE``,
``RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set). Each rank:

- takes one DIV2K update (the 4-D route: 2 heads of 32) and one hisfrag
  update (the pair route: 2 heads of 64) through ``Trainer.train_step``,
  from weights converted from a JAX init, on its own batch, with DropPath
  0.1 and 0, and one update of the main_vit and the Pajigsaw trainers
  (the generic step, DropPath 0.1, weights from the seed);
- scans 10 images with the pair scorer over its row range, assembled and
  as complete rows (in memory and on disk), and merges the wi19 partials;
- runs Geshaem's standard evaluation over its share of the pairs;
- exercises the host collectives.

The parent holds: the ranks' parameters bit-equal; each update within f32
1e-5 of one process's update on the concatenated batch (the ranks' pair
indices offset by the local batch); the loss equal to the JAX step's on
that batch within 1e-5 (DropPath 0; the plain JAX model); the merged scan
within 2e-3 of the JAX one-process ``PairwiseScorer``; the complete rows
tiling the matrix exactly and their merged partials equal to
``get_metrics`` within rtol 1e-12; Geshaem's gather equal to one process's;
and ``balanced_row_ranges`` equal to the JAX one.
"""

import os
import socket
import subprocess
import sys
import types

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 6          # images per rank and update
N_SCAN = 10
# the pair route (head_dim 64) and the 4-D route (head_dim 32)
PAIR = dict(embed_dim=128, num_heads=2, depth=1, c_depth=1, img_size=32,
            patch_size=16, num_classes=1)
QUAD = dict(embed_dim=64, num_heads=2, depth=1, c_depth=1, img_size=32,
            patch_size=8, num_classes=4)
DROP_RATES = ("0.0", "0.1")
# (entry, DropPath) of every update the ranks take
STEPS = [(e, d) for e in ("div2k", "hisfrag") for d in DROP_RATES] + [
    ("main_vit", "0.1"), ("pajigsaw", "0.1")]
VIT_OPTS = ["MODEL.VIT.EMBED_DIM", "64", "MODEL.VIT.NUM_HEADS", "2",
            "MODEL.VIT.DEPTH", "1", "DATA.IMG_SIZE", "32"]


def _opts(kw, drop):
    if kw is None:      # the ViT
        return VIT_OPTS + _common(drop)
    return ["MODEL.PJS.EMBED_DIM", str(kw["embed_dim"]), "MODEL.PJS.NUM_HEADS",
            str(kw["num_heads"]), "MODEL.PJS.DEPTH", str(kw["depth"]),
            "MODEL.PJS.C_DEPTH", str(kw["c_depth"]), "DATA.IMG_SIZE",
            str(kw["img_size"]), "MODEL.PJS.PATCH_SIZE", str(kw["patch_size"]),
            "MODEL.NUM_CLASSES", str(kw["num_classes"])] + _common(drop)


def _common(drop):
    return ["MODEL.DROP_PATH_RATE", drop, "TRAIN.WARMUP_EPOCHS", "0",
            "TRAIN.AUTO_RESUME", "False", "DATA.NUM_WORKERS", "0",
            "DATA.TEST_BATCH_SIZE", "4", "TRAIN.OPTIMIZER.NAME", "sgd"]


def _trainer(cls, kw, drop, out, tag, batch, weights=None, cfg=None):
    """A trainer on the CPU; its weights from ``weights`` (else from the
    seed, alike in every process)."""
    args = types.SimpleNamespace(
        cfg=cfg, device="cpu", mode="train", batch_size=batch,
        accumulation_steps=None, disable_amp=True, output=out, tag=tag,
        opts=_opts(kw, drop))
    trainer = cls(args)
    if weights:
        trainer.model.load_state_dict(torch.load(weights, weights_only=True))
    trainer.setup_training(10)
    return trainer


def _step_setup(entry):
    """(trainer class, model kwargs, config file, weights file name or None)
    of an entry's update."""
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer
    from vit_ed_tpu_torch.main import DefaultTrainer
    from vit_ed_tpu_torch.main_vit import VitTripletTrainer
    from vit_ed_tpu_torch.pajigsaw import PajigsawTrainer

    return {"div2k": (DefaultTrainer, QUAD, None, "quad.pth"),
            "hisfrag": (HisfragTrainer, PAIR, None, "pair.pth"),
            "main_vit": (VitTripletTrainer, None, os.path.join(
                _REPO, "configs", "puzzle", "vit_div2k_erosion7_4bin_patch8_64.yaml"), None),
            "pajigsaw": (PajigsawTrainer, PAIR | {"num_classes": 4}, os.path.join(
                _REPO, "configs", "pajigsaw", "pajigsaw_patch16_512.yaml"), None)}[entry]


def _local_batch(entry, rank):
    """Rank ``rank``'s host batch of an entry without pair mining."""
    rng = np.random.default_rng(100 + rank)
    if entry == "main_vit":     # 2 items of 4 directions x 3 images
        return {"samples": rng.normal(size=(2, 4, 3, 32, 32, 3)).astype(np.float32)}
    return _div2k_batch(rank)


def _params(model):
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def _grads(model):
    """The gradient the last update applied (after the all-reduce)."""
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()]).numpy()


def _div2k_batch(rank):
    rng = np.random.default_rng(100 + rank)
    return {"samples": rng.normal(size=(B, 2, 32, 32, 3)).astype(np.float32),
            "targets": (rng.random((B, 4)) > 0.5).astype(np.float32)}


def _hisfrag_images(rank):
    rng = np.random.default_rng(200 + rank)
    return (rng.normal(size=(B, 32, 32, 3)).astype(np.float32),
            rng.permutation(np.repeat(np.arange(3), 2)).astype(np.int32))


def _scan_images():
    return np.random.default_rng(0).normal(size=(N_SCAN, 32, 32, 3)).astype(np.float32)


class _DS:
    def __init__(self, imgs):
        self.imgs = imgs

    def __getitem__(self, i):
        return self.imgs[i], i

    def __len__(self):
        return len(self.imgs)


# ------------------------------------------------------------------ worker
def _worker(outdir):
    from vit_ed_tpu_torch.geshame_evaluation import eval_standard
    from vit_ed_tpu_torch.metrics.wi19_sharded import merge_partials, row_partials
    from vit_ed_tpu_torch.parallel import mesh
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    mesh.maybe_init_distributed(backend="gloo", timeout=60)
    rank = mesh.process_index()
    assert mesh.process_count() == 2

    def save(name, arr):
        np.save(os.path.join(outdir, f"rank{rank}_{name}.npy"), arr)

    # host collectives: a padded gather of unequal shards, a broadcast
    g = mesh.process_allgather(np.full((rank + 1, 3), rank + 1, np.float16))
    save("allgather", g)
    save("broadcast", mesh.broadcast_one_to_all(
        np.arange(5, dtype=np.int64) * (rank + 7), is_source=rank == 1))

    for entry, drop in STEPS:
        cls, kw, cfg, weights = _step_setup(entry)
        t = _trainer(cls, kw, drop, os.path.join(outdir, "o"), f"{entry}{drop}", B,
                     weights and os.path.join(outdir, weights), cfg)
        if entry == "hisfrag":
            np.random.seed(rank)
            batch = t.prepare_data(*_hisfrag_images(rank))
            np.savez(os.path.join(outdir, f"rank{rank}_hisfrag{drop}_batch.npz"), **batch)
        else:
            batch = _local_batch(entry, rank)
        loss, _ = t.train_step([batch])
        save(f"{entry}{drop}_params", _params(t.model))
        save(f"{entry}{drop}_grads", _grads(t.model))
        save(f"{entry}{drop}_loss", np.float32(loss.item()))
        if entry == "hisfrag":
            pair_trainer = t
    t = pair_trainer

    # the scan and Geshaem score with the converted JAX weights
    t.model.load_state_dict(torch.load(os.path.join(outdir, "pair.pth"),
                                       weights_only=True))
    scorer = PairwiseScorer(t.model, num_outputs=1, pair_chunk=8)
    ds = _DS(_scan_images())
    save("sim", scorer.score_dataset(ds, batch_size=4, num_workers=0, rank=rank,
                                     world_size=2))
    rows, row_range = scorer.score_dataset(ds, batch_size=4, num_workers=0,
                                           rank=rank, world_size=2, assemble=False)
    save("rows", rows)
    save("rowrange", np.asarray([row_range.start, row_range.stop]))
    disk, _ = scorer.score_dataset(ds, batch_size=4, num_workers=0, rank=rank,
                                   world_size=2, assemble=False, slab_on_disk=True,
                                   out_dir=os.path.join(outdir, "slab"))
    save("disk_rows", np.asarray(disk))
    labels = np.arange(N_SCAN) // 3
    part = row_partials(1 - rows.astype(np.float32), labels,
                        row_labels=labels[row_range.start:row_range.stop])
    keys = sorted(part)
    gathered = mesh.process_allgather(np.asarray([part[k] for k in keys], np.float64))
    save("merged_metrics", np.asarray(
        merge_partials([dict(zip(keys, r)) for r in gathered])))

    t.config.defrost()
    t.config.DATA.DATA_PATH = os.path.join(outdir, "geshaem")
    t.config.freeze()
    dist_m, _names, frag = eval_standard(t.config, t, t.logger, 2, rank)
    save("geshaem", dist_m)
    open(os.path.join(outdir, f"rank{rank}_ok"), "w").close()


# ------------------------------------------------------------------ parent
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmd, extra_env=None):
    """Start two ranks of ``python <cmd...>`` (rank r's environment: the
    launcher's variables, then ``extra_env[r]``); returns the processes."""
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env.update({"WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": "0",
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "PYTHONPATH": _REPO + os.pathsep + os.path.join(_REPO, "tests"),
                    "OMP_NUM_THREADS": "2"})
        env.update((extra_env or [{}, {}])[rank])
        procs.append(subprocess.Popen(
            [sys.executable] + list(cmd), env=env, cwd=_REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _jax_weights():
    """(JAX params, port state dict) of the pair and the 4-D model."""
    import jax
    import jax.numpy as jnp

    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict

    out = {}
    for name, kw, seed in (("pair", PAIR, 0), ("quad", QUAD, 1)):
        params = jax.jit(JaxViTED(**kw, use_pallas=False).init)(
            jax.random.PRNGKey(seed), jnp.zeros((1, 2, 32, 32, 3)))["params"]
        params = jax.tree.map(np.asarray, params)
        out[name] = (params, jax_params_to_state_dict(params))
    return out


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


@pytest.fixture(scope="module")
def mp_outputs(tmp_path_factory, weights):
    from test_torch_michigan import write_geshaem

    outdir = str(tmp_path_factory.mktemp("torch_mp"))
    for name, (_params_j, sd) in weights.items():
        torch.save(sd, os.path.join(outdir, f"{name}.pth"))
    write_geshaem(os.path.join(outdir, "geshaem"))
    procs = launch([os.path.abspath(__file__), outdir])
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    return outdir


def _load(outdir, rank, name):
    return np.load(os.path.join(outdir, f"rank{rank}_{name}.npy"))


def _one_process(outdir, entry, drop, batch):
    """The port's update on the global batch in this process: (parameters,
    gradients, loss, each parameter's size)."""
    cls, kw, cfg, weights = _step_setup(entry)
    t = _trainer(cls, kw, drop, os.path.join(outdir, "ref"), f"ref{entry}{drop}",
                 2 * B, weights and os.path.join(outdir, weights), cfg)
    loss, _ = t.train_step([batch])
    return (_params(t.model), _grads(t.model), loss.item(),
            [p.numel() for p in t.model.parameters()])


def _global_batch(entry):
    parts = [_local_batch(entry, r) for r in range(2)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _global_hisfrag(outdir, drop):
    """The ranks' prepared batches concatenated, rank 1's pair indices
    offset by its local batch (each rank's pairs read its own images)."""
    parts = [dict(np.load(os.path.join(outdir, f"rank{r}_hisfrag{drop}_batch.npz")))
             for r in range(2)]
    for k in ("gi", "gj"):
        parts[1][k] = parts[1][k] + B
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def _assert_close(got, want, sizes, tol):
    """Each tensor of the flat vectors within ``tol`` of its own max."""
    lo = 0
    for i, n in enumerate(sizes):
        g, w = got[lo:lo + n], want[lo:lo + n]
        assert np.max(np.abs(g - w)) <= tol * np.max(np.abs(w)), (i, n)
        lo += n
    assert lo == len(want) == len(got)


def _assert_step(outdir, entry, drop, params, grads, loss, sizes):
    """Rank 0's update against one process's: the loss, the summed gradient
    and the parameters within f32 1e-5 (of each tensor's max). The steps
    take SGD: AdamW's first update, lr x g / (|g| + eps), turns the order
    of the sum on a gradient element near eps into a change of up to 0.4%
    of the learning rate, far past 1e-5 of a zero-initialised bias's max;
    the all-reduce comes before the optimizer either way."""
    assert abs(_load(outdir, 0, f"{entry}{drop}_loss") - loss) < 1e-5
    _assert_close(_load(outdir, 0, f"{entry}{drop}_grads"), grads, sizes, 1e-5)
    _assert_close(_load(outdir, 0, f"{entry}{drop}_params"), params, sizes, 1e-5)


def test_both_ranks_finish(mp_outputs):
    for rank in range(2):
        assert os.path.exists(os.path.join(mp_outputs, f"rank{rank}_ok"))


def test_host_collectives(mp_outputs):
    for rank in range(2):
        g = _load(mp_outputs, rank, "allgather")
        assert g.shape == (2, 2, 3) and g.dtype == np.float16
        np.testing.assert_array_equal(g[0], [[1] * 3, [0] * 3])
        np.testing.assert_array_equal(g[1], [[2] * 3, [2] * 3])
        np.testing.assert_array_equal(_load(mp_outputs, rank, "broadcast"),
                                      np.arange(5) * 8)


@pytest.mark.parametrize("entry,drop", STEPS)
def test_params_bit_equal_across_ranks(mp_outputs, entry, drop):
    np.testing.assert_array_equal(_load(mp_outputs, 0, f"{entry}{drop}_params"),
                                  _load(mp_outputs, 1, f"{entry}{drop}_params"))
    assert _load(mp_outputs, 0, f"{entry}{drop}_loss") == \
        _load(mp_outputs, 1, f"{entry}{drop}_loss")


@pytest.mark.parametrize("entry,drop", STEPS)
def test_step_equals_one_process(mp_outputs, entry, drop):
    """DIV2K, main_vit and Pajigsaw: the local mean over ``world``; hisfrag:
    the local masked sum over the global live pairs, its pair indices
    offset per rank."""
    batch = (_global_hisfrag(mp_outputs, drop) if entry == "hisfrag"
             else _global_batch(entry))
    _assert_step(mp_outputs, entry, drop, *_one_process(mp_outputs, entry, drop, batch))


def _jax_loss(params, kw, batch, loss_fn=None):
    """The JAX ``make_train_step`` loss of one update on ``batch``."""
    import jax
    import jax.numpy as jnp

    from vit_ed_tpu.config import default_config
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu.train.engine import TrainState, make_train_step
    from vit_ed_tpu.train.losses import bce_with_logits
    from vit_ed_tpu.train.optim import build_optimizer, cosine_schedule

    model = JaxViTED(**kw, use_pallas=False)
    params = jax.tree.map(jnp.asarray, params)
    tx = build_optimizer(default_config(), cosine_schedule(1e-3, 1e-5, 1e-6, 100, 10),
                         params)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    step = make_train_step(model, tx, None if loss_fn else bce_with_logits,
                           accum_steps=1, loss_fn=loss_fn)
    jbatch = {k: jnp.asarray(v[None]) for k, v in batch.items()}
    _state, metrics = step(state, jbatch, jax.random.PRNGKey(7))
    return float(jax.device_get(metrics["loss"]))


def test_div2k_loss_equals_jax(mp_outputs, weights):
    ref = _jax_loss(weights["quad"][0], QUAD, _global_batch("div2k"))
    assert abs(_load(mp_outputs, 0, "div2k0.0_loss") - ref) < 1e-5


def test_hisfrag_loss_equals_jax_offset_indices(mp_outputs, weights):
    from hisfrag import HisfragTrainer as JaxHisfragTrainer
    from vit_ed_tpu.config import default_config

    stub = types.SimpleNamespace(LOSS_REDUCTION="mean", config=default_config())
    loss_fn = JaxHisfragTrainer.make_loss_fn(stub, None)
    batch = _global_hisfrag(mp_outputs, "0.0")
    ref = _jax_loss(weights["pair"][0], PAIR, batch, loss_fn)
    assert abs(_load(mp_outputs, 0, "hisfrag0.0_loss") - ref) < 1e-5


def test_scan_merge_equals_jax_one_process(mp_outputs, weights):
    from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
    from vit_ed_tpu.parallel.mesh import create_mesh
    from vit_ed_tpu.parallel.pairs import PairwiseScorer as JaxScorer

    sim0, sim1 = _load(mp_outputs, 0, "sim"), _load(mp_outputs, 1, "sim")
    np.testing.assert_array_equal(sim0, sim1)
    scorer = JaxScorer(JaxViTED(**PAIR, use_pallas=False), weights["pair"][0],
                       create_mesh(), num_outputs=1, pair_chunk=8)
    ref = scorer.score_dataset(_DS(_scan_images()), batch_size=4, num_workers=0)
    assert sim0.shape == (N_SCAN, N_SCAN)
    np.testing.assert_allclose(sim0.astype(np.float32), ref.astype(np.float32),
                               atol=2e-3)


def test_sharded_rows_tile_matrix_and_metrics_merge(mp_outputs):
    from vit_ed_tpu_torch.metrics import get_metrics

    sim = _load(mp_outputs, 0, "sim")
    lo_hi = [_load(mp_outputs, r, "rowrange") for r in range(2)]
    assert lo_hi[0][0] == 0 and lo_hi[0][1] == lo_hi[1][0] and lo_hi[1][1] == N_SCAN
    for rank, (lo, hi) in enumerate(lo_hi):
        np.testing.assert_array_equal(_load(mp_outputs, rank, "rows"), sim[lo:hi])
        np.testing.assert_array_equal(_load(mp_outputs, rank, "disk_rows"), sim[lo:hi])
    labels = np.arange(N_SCAN) // 3
    ref = get_metrics(1 - sim.astype(np.float32), labels)
    for rank in range(2):
        np.testing.assert_allclose(_load(mp_outputs, rank, "merged_metrics"), ref,
                                   rtol=1e-12)


def test_geshaem_gather_equals_one_process(mp_outputs):
    from vit_ed_tpu_torch.geshame_evaluation import eval_standard
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer

    t = _trainer(HisfragTrainer, PAIR, "0.0", os.path.join(mp_outputs, "gref"), "g",
                 B, os.path.join(mp_outputs, "pair.pth"))
    t.config.defrost()
    t.config.DATA.DATA_PATH = os.path.join(mp_outputs, "geshaem")
    t.config.freeze()
    ref, _names, _frag = eval_standard(t.config, t, t.logger)
    assert ref.shape[0] > 2
    for rank in range(2):
        np.testing.assert_array_equal(_load(mp_outputs, rank, "geshaem"), ref)


@pytest.mark.parametrize("world", [1, 2, 3, 4, 7])
def test_balanced_row_ranges_equal_jax(world):
    from vit_ed_tpu.data.samplers import DistributedIndicatesSampler as JaxSampler
    from vit_ed_tpu.data.samplers import balanced_row_ranges as jax_ranges
    from vit_ed_tpu_torch.data.samplers import (
        DistributedIndicatesSampler,
        balanced_row_ranges,
    )

    for n in range(1, 70):
        rows = np.triu_indices(n)[0]
        assert balanced_row_ranges(rows, world) == jax_ranges(rows, world)
        for rank in range(world):
            assert list(DistributedIndicatesSampler(rows, world, rank)) == \
                list(JaxSampler(rows, world, rank))


if __name__ == "__main__":
    _worker(sys.argv[1])
