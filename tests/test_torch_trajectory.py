"""K optimizer steps of the hisfrag mined-pair loss: the JAX package's jitted
train step (``vit_ed_tpu.train.engine.make_train_step`` with the root
``hisfrag.py`` loss, Pallas kernels in interpret mode) against the port's
``Trainer.train_step``, from identical converted weights and identical
prepared batches, drop_path 0.

Bounds are those of tests/test_trajectory_parity.py (:348, :458): losses
rtol 2e-3 / atol 2e-4 over the trajectory, the first two pre-clip gradient
norms rtol 1e-5; step-0 gradients per parameter within 1e-4 of each
gradient's max; one bf16 step's loss within 5e-2.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_ed_tpu.ops.attention as jattn
from hisfrag import HisfragTrainer as JaxHisfragTrainer
from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.train.engine import TrainState, make_train_step
from vit_ed_tpu.train.optim import build_optimizer as jax_build_optimizer
from vit_ed_tpu.train.optim import build_schedule as jax_build_schedule
from vit_ed_tpu_torch.hisfrag import HisfragTrainer
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params

K, STEPS_PER_EPOCH, BATCH = 5, 5, 6
KW = dict(embed_dim=128, num_heads=2, depth=1, c_depth=2, img_size=64,
          patch_size=16, num_classes=1)
OPTS = ["MODEL.PJS.EMBED_DIM", "128", "MODEL.PJS.NUM_HEADS", "2",
        "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "2", "DATA.IMG_SIZE", "64",
        "MODEL.PJS.PATCH_SIZE", "16", "MODEL.DROP_PATH_RATE", "0.0",
        "TRAIN.EPOCHS", "2", "TRAIN.WARMUP_EPOCHS", "0.4",
        "TRAIN.BASE_LR", "2e-2", "TRAIN.WARMUP_LR", "1e-3", "TRAIN.MIN_LR", "1e-4",
        "TRAIN.AUTO_RESUME", "False"]


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    monkeypatch.setattr(jattn, "_INTERPRET", True)


@pytest.fixture(scope="module")
def jax_params():
    params = jax.jit(JaxViTED(**KW, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def _port_trainer(tmp_path, jax_params, accum=1, clip=None, amp=False):
    args = types.SimpleNamespace(
        cfg=None, device="cpu", mode="train", batch_size=BATCH,
        accumulation_steps=accum, disable_amp=not amp, output=str(tmp_path),
        tag=f"a{accum}c{clip}amp{amp}",
        opts=OPTS + (["TRAIN.CLIP_GRAD", str(clip)] if clip is not None else []))
    trainer = HisfragTrainer(args)
    load_jax_params(trainer.model, jax_params)
    trainer.setup_training(STEPS_PER_EPOCH)
    return trainer


def _batches(trainer, n, seed):
    """n prepared micro-batches (numpy dicts): noise images of three
    writers, pairs mined by the port's ``prepare_data``."""
    rng = np.random.default_rng(seed)
    np.random.seed(seed)
    out = []
    for _ in range(n):
        samples = rng.normal(size=(BATCH, 64, 64, 3)).astype(np.float32)
        targets = rng.permutation(np.repeat(np.arange(3), 2)).astype(np.int32)
        out.append(trainer.prepare_data(samples, targets))
    return out


def _jax_loss_fn(config):
    stub = types.SimpleNamespace(LOSS_REDUCTION="mean", config=config)
    return JaxHisfragTrainer.make_loss_fn(stub, None)


def _jax_run(config, jax_params, batches, accum, dtype=jnp.float32, kw=None,
             criterion=None, model=None, loss_fn=None):
    """The JAX trajectory on the port's (already LR-scaled) config, for
    ``model`` (default: a ViT-ED built from ``kw``, default this file's).
    ``loss_fn`` (``make_train_step``'s) wins; else ``criterion`` None runs
    the hisfrag mined-pair loss, and a criterion runs ``make_train_step``'s
    default supervised pair loss with it."""
    if model is None:
        model = JaxViTED(**(kw or KW), use_pallas=True, dtype=dtype)
    schedule = jax_build_schedule(config, STEPS_PER_EPOCH)
    params = jax.tree.map(jnp.asarray, jax_params)
    tx = jax_build_optimizer(config, schedule, params)
    if loss_fn is None and criterion is None:
        loss_fn = _jax_loss_fn(config)
    step = make_train_step(model, tx, criterion, accum, loss_fn)
    state = TrainState(params=params, opt_state=tx.init(params),
                       step=jnp.zeros((), jnp.int32))
    losses, norms = [], []
    for i in range(0, len(batches), accum):
        micro = batches[i:i + accum]
        batch = {k: jnp.asarray(np.stack([b[k] for b in micro])) for k in micro[0]}
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, state


def _port_run(trainer, batches, accum):
    losses, norms = [], []
    for i in range(0, len(batches), accum):
        loss, norm = trainer.train_step(batches[i:i + accum])
        losses.append(loss.item())
        norms.append(norm.item())
    return losses, norms


@pytest.mark.parametrize("accum,clip", [(1, None), (2, None), (1, 0.05)])
def test_loss_trajectory_tracks_jax(tmp_path, jax_params, accum, clip):
    trainer = _port_trainer(tmp_path, jax_params, accum=accum, clip=clip)
    batches = _batches(trainer, K * accum, seed=accum)
    ref_losses, ref_norms, state = _jax_run(trainer.config, jax_params, batches, accum)
    losses, norms = _port_run(trainer, batches, accum)

    assert len(losses) == len(ref_losses) == K and trainer.step == K
    # step 0 is forward and backward parity alone
    assert abs(losses[0] - ref_losses[0]) < 1e-5
    np.testing.assert_allclose(losses, ref_losses, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(norms[:2], ref_norms[:2], rtol=1e-5)
    np.testing.assert_allclose(norms, ref_norms, rtol=2e-2)
    assert abs(ref_losses[-1] - ref_losses[0]) > 1e-5      # the loss moved
    if clip:
        assert max(ref_norms) > clip                        # and the clip bound
    # the parameters after K updates
    want = jax_params_to_state_dict(jax.tree.map(np.asarray, state.params))
    got = trainer.model.state_dict()
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=0, atol=2e-3, err_msg=name)


def test_step0_gradients_match_jax_grad(tmp_path, jax_params):
    trainer = _port_trainer(tmp_path, jax_params)
    (batch,) = _batches(trainer, 1, seed=9)
    model = JaxViTED(**KW, use_pallas=True)
    loss_fn = _jax_loss_fn(trainer.config)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p, b: loss_fn(model, p, b, jax.random.PRNGKey(0))))(
        jax.tree.map(jnp.asarray, jax_params),
        {k: jnp.asarray(v) for k, v in batch.items()})
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, ref))

    trainer.model.train()
    loss = trainer.loss_fn(trainer.model, trainer._to_device(batch))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) < 1e-5
    for name, p in trainer.model.named_parameters():
        assert p.grad is not None, name
        g, r = p.grad.numpy(), ref[name].numpy()
        assert np.abs(g - r).max() <= 1e-4 * max(np.abs(r).max(), 1e-12), name


def test_one_bf16_step_tracks_jax(tmp_path, jax_params):
    trainer = _port_trainer(tmp_path, jax_params, amp=True)
    assert trainer.model.dtype == torch.bfloat16
    batches = _batches(trainer, 1, seed=4)
    ref_losses, ref_norms, _ = _jax_run(trainer.config, jax_params, batches, 1,
                                        dtype=jnp.bfloat16)
    losses, norms = _port_run(trainer, batches, 1)
    assert abs(losses[0] - ref_losses[0]) <= 5e-2
    # gradients flow in bf16 on both sides; the norm is a loose sanity bound
    np.testing.assert_allclose(norms[0], ref_norms[0], rtol=0.2)
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in trainer.model.parameters())
