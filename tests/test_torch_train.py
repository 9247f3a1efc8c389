"""The pieces of the port's training slice against the JAX package's, on the
CPU: losses, LR schedules, weight-decay groups, gradient clipping, DropPath,
the M-per-class sampler, in-batch pair mining and the train transforms.
Inputs come from numpy seeds and go to both frameworks."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.train import losses as jlosses
from vit_ed_tpu.train import optim as joptim
from vit_ed_tpu_torch.config import default_config
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.layers import DropPath
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.train import losses, optim

KW = dict(embed_dim=128, num_heads=2, depth=1, c_depth=2, img_size=64,
          patch_size=16, num_classes=1)


# ------------------------------------------------------------------- losses
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_bce_with_logits_matches_jax(reduction):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(7, 1)).astype(np.float32) * 4
    y = rng.integers(0, 2, size=(7, 1)).astype(np.float32)
    ref = jlosses.bce_with_logits(jnp.asarray(x), jnp.asarray(y), reduction)
    out = losses.bce_with_logits(torch.from_numpy(x), torch.from_numpy(y), reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
@pytest.mark.parametrize("live", [0, 3, 7])
def test_masked_bce_matches_jax(reduction, live):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(7, 1)).astype(np.float32) * 4
    y = rng.integers(0, 2, size=(7, 1)).astype(np.float32)
    mask = (np.arange(7) < live).astype(np.float32)
    ref = jlosses.masked_bce_with_logits(jnp.asarray(x), jnp.asarray(y),
                                         jnp.asarray(mask), reduction)
    out = losses.masked_bce_with_logits(torch.from_numpy(x), torch.from_numpy(y),
                                        torch.from_numpy(mask), reduction)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------- schedules
SCHEDULES = {
    "cosine": ("cosine_schedule", (3e-4, 2e-6, 1e-7, 20, 4, True)),
    "cosine_no_prefix": ("cosine_schedule", (3e-4, 2e-6, 1e-7, 20, 4, False)),
    "linear": ("linear_schedule", (3e-4, 1e-7, 20, 4)),
    "step": ("step_schedule", (3e-4, 1e-7, 4, 6, 0.1)),
    "multistep": ("multistep_schedule", (3e-4, 1e-7, 4, [7, 13], 0.1)),
    "no_warmup": ("cosine_schedule", (3e-4, 2e-6, 1e-7, 20, 0, True)),
}


def _same_lr(ours, ref, t, base_lr=3e-4):
    # the JAX schedule evaluates in float32: exact up to f32 resolution (the
    # 1e-6 relative bound of tests/test_trajectory_parity.py:370), plus the
    # f32 cancellation of 1 + cos(.) near the end of the cosine phase, an
    # absolute ~6e-8 of base_lr / 2
    assert abs(ours - ref) <= 1e-6 * abs(ref) + 1e-7 * base_lr, (t, ours, ref)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_matches_jax_at_every_step(name):
    fn, args = SCHEDULES[name]
    ref, ours = getattr(joptim, fn)(*args), getattr(optim, fn)(*args)
    for t in range(0, 24):   # warm-up boundary, decay phase, past the end
        _same_lr(ours(t), float(ref(t)), t)


@pytest.mark.parametrize("name", ["cosine", "linear", "step", "multistep"])
def test_build_schedule_matches_jax(name):
    cfg = default_config()
    cfg.TRAIN.EPOCHS, cfg.TRAIN.WARMUP_EPOCHS = 4, 1
    cfg.TRAIN.LR_SCHEDULER.NAME = name
    cfg.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 2
    cfg.TRAIN.LR_SCHEDULER.MULTISTEPS = [2, 3]
    ref, ours = joptim.build_schedule(cfg, 5), optim.build_schedule(cfg, 5)
    for t in range(0, 23):
        _same_lr(ours(t), float(ref(t)), t, cfg.TRAIN.BASE_LR)


# ---------------------------------------------------------------- optimizer
@pytest.fixture(scope="module")
def jax_params():
    params = jax.jit(JaxViTED(**KW, use_pallas=False).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 2, 64, 64, 3)))["params"]
    return jax.tree.map(np.asarray, params)


def test_weight_decay_groups_are_the_jax_mask(jax_params):
    mask = joptim.weight_decay_mask(jax_params)
    # the mask in the port's key layout: a tensor of ones where decayed
    as_sd = jax_params_to_state_dict(jax.tree.map(
        lambda p, m: np.full(p.shape, float(m), np.float32), jax_params, mask))
    model = load_jax_params(ViTED(**KW), jax_params)
    decay, no_decay = optim.weight_decay_groups(model, 0.05)
    assert decay["weight_decay"] == 0.05 and no_decay["weight_decay"] == 0.0
    names = {id(p): n for n, p in model.named_parameters()}
    got = {names[id(p)]: True for p in decay["params"]}
    got.update({names[id(p)]: False for p in no_decay["params"]})
    assert got == {n: bool(v.all()) for n, v in as_sd.items()}
    assert got["cls_token"] and got["pos_embed"] and got["head.weight"]
    assert not got["blocks.0.norm1.weight"] and not got["head.bias"]


@pytest.mark.parametrize("max_norm", [0.05, 1e3])
def test_clip_matches_jax_clip(max_norm):
    rng = np.random.default_rng(2)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((4, 3), (5,), (2, 2, 2))]
    ref, _ = joptim.clip_by_global_norm_torch(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    for p, g in zip(params, grads):
        p.grad = torch.from_numpy(g.copy())
    norm = optim.clip_grad_norm(params, max_norm)
    np.testing.assert_allclose(norm.item(), np.sqrt(sum((g ** 2).sum() for g in grads)),
                               rtol=1e-6)
    for p, r in zip(params, ref):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(r), rtol=1e-6)
    # the coefficient itself: min(1, max_norm / (norm + 1e-6))
    coef = min(1.0, max_norm / (norm.item() + 1e-6))
    np.testing.assert_allclose(params[0].grad.numpy(), grads[0] * coef, rtol=1e-6)
    # no clipping asked for: the norm only
    assert optim.clip_grad_norm(params, 0.0).item() == pytest.approx(
        norm.item() * coef, rel=1e-5)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_update_matches_optax(name):
    """Three updates of a two-parameter model (one decayed weight, one
    bias) with clipping, a per-step lr and weight decay."""
    cfg = default_config()
    cfg.TRAIN.OPTIMIZER.NAME, cfg.TRAIN.CLIP_GRAD = name, 0.5
    rng = np.random.default_rng(3)
    w0, b0 = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(4,)).astype(np.float32)
    gs = [(rng.normal(size=(3, 4)).astype(np.float32),
           rng.normal(size=(4,)).astype(np.float32)) for _ in range(3)]
    sched = optim.cosine_schedule(1e-2, 1e-4, 1e-3, 10, 2)

    params = {"fc": {"kernel": jnp.asarray(w0), "bias": jnp.asarray(b0)}}
    tx = joptim.build_optimizer(cfg, joptim.cosine_schedule(1e-2, 1e-4, 1e-3, 10, 2),
                                params)
    state = tx.init(params)
    for gw, gb in gs:
        upd, state = tx.update({"fc": {"kernel": jnp.asarray(gw),
                                       "bias": jnp.asarray(gb)}}, state, params)
        params = optax.apply_updates(params, upd)

    model = torch.nn.Linear(3, 4)
    with torch.no_grad():
        model.weight.copy_(torch.from_numpy(w0.T))
        model.bias.copy_(torch.from_numpy(b0))
    opt = optim.build_optimizer(cfg, model)
    for step, (gw, gb) in enumerate(gs):
        model.weight.grad = torch.from_numpy(gw.T.copy())
        model.bias.grad = torch.from_numpy(gb.copy())
        optim.clip_grad_norm(model.parameters(), cfg.TRAIN.CLIP_GRAD)
        optim.set_lr(opt, sched(step))
        opt.step()
    np.testing.assert_allclose(model.weight.detach().numpy().T,
                               np.asarray(params["fc"]["kernel"]), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(model.bias.detach().numpy(),
                               np.asarray(params["fc"]["bias"]), rtol=1e-5, atol=1e-7)


# ----------------------------------------------------------------- DropPath
def _drop_path(rate, seed):
    dp = DropPath(rate)
    dp.generator = torch.Generator().manual_seed(seed)
    return dp


def test_drop_path_semantics():
    x = torch.randn(64, 5, 8)
    dp = _drop_path(0.25, 0)
    assert dp.eval()(x) is x                      # eval: the identity
    assert DropPath(0.0).train()(x) is x          # rate 0: the identity
    y = dp.train()(x)
    kept = (y != 0).flatten(1).any(1)
    # one draw per sample: a sample is dropped whole or scaled whole
    for i in range(64):
        if kept[i]:
            np.testing.assert_allclose(y[i].numpy(), (x[i] / 0.75).numpy(), rtol=1e-6)
        else:
            assert torch.count_nonzero(y[i]) == 0
    assert 0 < int(kept.sum()) < 64
    # same generator seed -> same mask; the global RNG is not consumed
    state = torch.get_rng_state()
    assert torch.equal(_drop_path(0.25, 0).train()(x), y)
    assert not torch.equal(_drop_path(0.25, 1).train()(x), y)
    assert torch.equal(torch.get_rng_state(), state)
    with pytest.raises(RuntimeError, match="seed_drop_path"):
        DropPath(0.5).train()(x)


def _grads_with_drop_path(use_checkpoint, x):
    torch.manual_seed(0)
    model = ViTED(**KW, drop_path_rate=0.5, use_checkpoint=use_checkpoint).train()
    model.seed_drop_path(7)
    model(x).sum().backward()
    return {n: p.grad for n, p in model.named_parameters()}, model


def test_checkpointed_blocks_recompute_the_same_drop_path_mask():
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 2, 64, 64, 3)).astype(np.float32))
    plain, m0 = _grads_with_drop_path(False, x)
    ckpt, m1 = _grads_with_drop_path(True, x)
    # a recomputation that drew fresh masks would give other gradients
    for n in plain:
        assert plain[n] is not None, n
        np.testing.assert_allclose(ckpt[n].numpy(), plain[n].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=n)
    # and the generator ends where the plain run left it
    assert torch.equal(m0.drop_path_generator.get_state(),
                       m1.drop_path_generator.get_state())


def test_training_with_a_non_zero_dropout_raises():
    model = ViTED(**KW, proj_drop_rate=0.1)
    x = torch.zeros(1, 2, 64, 64, 3)
    with pytest.raises(NotImplementedError, match="proj_drop_rate"):
        model.train()(x)
    with torch.no_grad():
        assert model.eval()(x).shape == (1, 1)


# ------------------------------------------------------------- data pieces
def test_m_per_class_sampler_matches_jax():
    from vit_ed_tpu.data.samplers import MPerClassSampler as JaxSampler
    from vit_ed_tpu_torch.data.samplers import MPerClassSampler

    labels = np.repeat(np.arange(7), [4, 3, 5, 2, 6, 3, 4])
    for kw in (dict(m=3, length_before_new_iter=81, seed=5),
               dict(m=3, batch_size=6, length_before_new_iter=50, seed=1)):
        ref, ours = JaxSampler(labels, **kw), MPerClassSampler(labels, **kw)
        assert len(ref) == len(ours)
        for _epoch in range(2):
            assert list(ours) == list(ref)
    with pytest.raises(ValueError, match="divide batch_size"):
        MPerClassSampler(labels, m=3, batch_size=7, length_before_new_iter=50)


@pytest.mark.parametrize("max_pairs", [19, 5])
def test_prepare_data_matches_jax(max_pairs):
    """Same seed -> the same mined pairs, in the same order (max_pairs 5
    walks the subsampling branch)."""
    from hisfrag import HisfragTrainer as JaxTrainer
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer

    stub = types.SimpleNamespace(NEG_PAIR_RATIO=2.0, NEG_FULL_ROW=False,
                                 max_pairs=max_pairs)
    rng = np.random.default_rng(0)
    samples = rng.normal(size=(6, 8, 8, 3)).astype(np.float32)
    targets = np.asarray([2, 2, 2, 0, 0, 1], np.int32)
    np.random.seed(11)
    ref = JaxTrainer.prepare_data(stub, samples, targets)
    np.random.seed(11)
    ours = HisfragTrainer.prepare_data(stub, samples, targets)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert ours["pair_mask"].sum() == min(max_pairs, 4 + 8)


def test_train_transform_chain_matches_jax():
    """The hisfrag train augmentations, same ``random`` seed: equal arrays
    (the JAX package runs its native warp and jitter where built, which it
    documents as bit-exact with the numpy mirror the port copies)."""
    from vit_ed_tpu.data import transforms as JT
    from vit_ed_tpu_torch.data import transforms as TT

    def chain(T, img):
        img = T.random_affine(img, degrees=5, translate=(0.1, 0.1), fill=0)
        img = T.shift_scale_rotate(img, shift_limit=0.05, scale_limit=0.1,
                                   rotate_limit=10, p=0.5, border_value=(0, 0, 0))
        img = T.random_crop(img, 64, pad_if_needed=True)
        img = T.color_jitter(img, 0.3, 0.3, 0.3, 0.3, p=0.5)
        img = T.GaussianBlur(p=0.5, radius_min=1.0, radius_max=2.0)(img)
        return T.normalize_image(img)

    img = Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (90, 110, 3), dtype=np.uint8))
    for seed in range(6):
        random.seed(seed)
        ref = chain(JT, img)
        random.seed(seed)
        np.testing.assert_array_equal(chain(TT, img), ref)


# ------------------------------------------------------------ pair gather
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_rows_is_index_select_with_a_fixed_order_backward(dtype):
    """``gather_rows`` gathers what ``index_select`` gathers, and its
    one-hot backward gives ``index_select``'s gradient (integer cotangents:
    every partial sum is exact in both types, so the summation order cannot
    show); rows never gathered get zeros."""
    from vit_ed_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(16, 5, 8)).astype(np.float32)).to(dtype)
    index = torch.from_numpy(rng.integers(0, 14, 49))
    g = torch.from_numpy(rng.integers(-8, 8, (49, 5, 8)).astype(np.float32)).to(dtype)
    ours, ref = x.clone().requires_grad_(), x.clone().requires_grad_()
    out = gather_rows(ours, index)
    want = ref.index_select(0, index)
    assert torch.equal(out, want)
    out.backward(g)
    want.backward(g)
    assert ours.grad.dtype == dtype
    assert torch.equal(ours.grad, ref.grad)
    assert not ours.grad[14:].any()


def test_gather_rows_backward_sums_in_float32():
    """Real-valued cotangents: the one-hot product against index_add's
    running sum, both in float32, within a few ulps of the sum."""
    from vit_ed_tpu_torch.ops.gather import gather_rows

    rng = np.random.default_rng(1)
    x = torch.zeros(16, 33, requires_grad=True)
    index = torch.from_numpy(rng.integers(0, 16, 49))
    g = torch.from_numpy(rng.normal(size=(49, 33)).astype(np.float32))
    gather_rows(x, index).backward(g)
    want = torch.zeros(16, 33).index_add_(0, index, g)
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
