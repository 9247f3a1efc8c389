"""The BatchNorm baselines of the port (vit_ed_tpu_torch/models/resnet.py,
models/simsiam.py) against the JAX package's flax modules, on the CPU, on
the same weights (flax ``params`` + ``batch_stats`` converted with
``models/convert.py::flax_variables_to_state_dict``, loaded strict):

- every model type (``resnet`` with a BasicBlock and a Bottleneck arch,
  ``mixconv``, ``ss``, ``ss2``, ``ss2ce``) at 64 px, batch 8: in eval mode
  (running statistics moved off their init values), float32, every output
  within 1e-4 of its max; in train mode (batch statistics) in float64 on
  both sides (the flax module cloned with ``dtype=float64`` under
  ``jax.enable_x64``, the port's model and its buffers in float64), every
  output and every updated running mean and (biased) variance within 1e-4
  (a running mean against the larger of its max and 0.01 x the batch's
  standard deviation: the momentum's share of a batch mean that is zero up
  to rounding, as after a bias-free Dense fed by an affine-free BatchNorm,
  has no scale of its own). Train mode is held in float64 because in
  float32 the JAX package's own output lies farther than 1e-4 from the
  float64 one where many layers renormalise by statistics of few values
  (resnet50 at this size: 53 layers, 32 values per channel in the last
  stage); float32 train mode is held by the step below;
- one ``ss2`` train step of the negative-cosine loss: in float32 the loss
  (against the largest |cosine| of its rows: the mean cancels to -0.014
  here) and the new running statistics within 1e-4; the gradients in float64,
  each within 1e-4 of its own max (in float32, at random init, single
  gradients move by far more than 1e-4 of their max between two
  evaluations, the port's float32 against its own float64 as much as
  JAX's: many are small differences of large terms through the
  BatchNorms); the gradient
  of ``projector.fc3.bias``, which feeds an affine-free BatchNorm and is
  zero in exact arithmetic, within 1e-10 of the largest gradient instead;
- the JAX ``test_ss_entry`` through the port's trainer: the statistics
  move through ``Trainer.train()``, the checkpoint carries them and a
  resume restores them;
- the layer-by-layer FLOP count of utils/flops.py against torch's own
  counter, forward and backward (mixconv forward only: torch's counter
  counts a grouped convolution's backward as if it were dense).
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import copy
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

from vit_ed_tpu.models import build_model as jax_build_model
from vit_ed_tpu.train.losses import negative_cosine_similarity as jax_ncs
from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.hisfrag_vit import HisfragVitTrainer
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.models.convert import flax_variables_to_state_dict
from vit_ed_tpu_torch.models.resnet import BatchNorm, backbone_size
from vit_ed_tpu_torch.train.losses import loss_combination, negative_cosine_similarity
from vit_ed_tpu_torch.utils.flops import layer_step_flops

ROOT = Path(__file__).resolve().parent.parent

# (MODEL.TYPE, opts): small widths at 64 px
TYPES = {
    "resnet18": ("resnet", ["MODEL.RES.ARCH", "resnet18"]),
    "resnet50": ("resnet", ["MODEL.RES.ARCH", "resnet50"]),
    "mixconv": ("mixconv", ["MODEL.MIXCONV.ARCH", "resnet18", "MODEL.MIXCONV.MIX_DEPTH", "2",
                            "MODEL.MIXCONV.OUT_CHANNELS", "32", "MODEL.MIXCONV.OUT_ROWS", "2"]),
    "ss": ("ss", ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32",
                  "MODEL.SS.PRED_DIM", "16"]),
    "ss2": ("ss2", ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32",
                    "MODEL.SS.PRED_DIM", "16"]),
    "ss2ce": ("ss2ce", ["MODEL.SS.ARCH", "resnet18", "MODEL.SS.EMBED_DIM", "32",
                        "MODEL.SS.PRED_DIM", "16", "MODEL.SS.N_CLASSES", "5"]),
}


def _config(name, amp=False):
    model_type, opts = TYPES[name]
    args = types.SimpleNamespace(
        cfg=str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml"),
        opts=["MODEL.TYPE", model_type, "DATA.IMG_SIZE", "64", *opts],
        disable_amp=not amp)
    return get_config(args)


def _leaf(rng, path, shape):
    """A seeded value for one flax leaf: kernels at the lecun-normal scale,
    norm scales near 1, biases near 0, running statistics at their init
    (0 / 1) unless ``moved``."""
    name = path[-1].key
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, 1.0 / np.sqrt(fan_in), shape)
    if name == "scale":
        return rng.normal(1.0, 0.1, shape)
    if name in ("bias", "mean"):
        return rng.normal(0.0, 0.1, shape)
    if name == "var":
        return np.abs(rng.normal(1.0, 0.3, shape))
    return rng.normal(1e-5, 1e-6, shape) if name.startswith("layer_scale") else \
        rng.normal(1.0, 0.1, shape)


def _pair(name, x, perturb_stats):
    """(flax module, seeded variables of its tree, the port's model with
    them loaded). The tree comes from ``jax.eval_shape`` of the flax init
    (traced, not compiled); running statistics stay at their init values
    (0 / 1) unless ``perturb_stats``."""
    config = _config(name)
    jm = jax_build_model(config)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    rng = np.random.default_rng(1)
    variables = {
        "params": jax.tree_util.tree_map_with_path(
            lambda p, a: _leaf(rng, p, a.shape).astype(np.float32), shapes["params"]),
        "batch_stats": jax.tree_util.tree_map_with_path(
            lambda p, a: (_leaf(rng, p, a.shape) if perturb_stats else
                          np.full(a.shape, float(p[-1].key == "var"))).astype(np.float32),
            shapes["batch_stats"])}
    model = build_model(config)
    model.load_state_dict(flax_variables_to_state_dict(
        variables["params"], variables["batch_stats"]), strict=True)
    return jm, variables, model


def _inputs(name, b=8):
    rng = np.random.default_rng(0)
    shape = (b, 2, 64, 64, 3) if name == "ss" else (b, 64, 64, 3)
    return rng.standard_normal(shape).astype(np.float32)


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _close(got, want, tol=1e-4):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() / scale <= tol, np.abs(got - want).max() / scale


def _float64(model):
    """A float64 copy of ``model``: weights, buffers and compute dtype."""
    m64 = copy.deepcopy(model).double()
    for mod in m64.modules():
        if getattr(mod, "dtype", None) == torch.float32:
            mod.dtype = torch.float64
    return m64


def _stats(model):
    return {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}


def _close_stats(got, want):
    """Running statistics within 1e-4: a variance against its max, a mean
    against the larger of its max and 0.01 x its batch's std."""
    assert got
    for k, v in got.items():
        w = want[k].double().numpy()
        scale = np.abs(w).max()
        if k.endswith("running_mean"):
            var = (want[k.replace("mean", "var")].double().numpy() - 0.99) / 0.01
            scale = max(scale, 0.01 * np.sqrt(max(var.max(), 0.0)))
        assert np.abs(v.double().numpy() - w).max() <= 1e-4 * scale, k


def _flax_train(jm, variables, x):
    out, mutated = jax.jit(lambda v, a: jm.apply(v, a, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    return _as_tuple(out), flax_variables_to_state_dict(
        {}, jax.device_get(mutated["batch_stats"]))


def _to_float64(variables):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


@pytest.mark.parametrize("name", list(TYPES))
def test_eval_forward_matches_flax(name):
    x = _inputs(name)
    jm, variables, model = _pair(name, x, perturb_stats=True)
    outs = _as_tuple(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model.eval()
    before = _stats(model)
    gots = _as_tuple(model(torch.from_numpy(x)))
    assert len(outs) == len(gots)
    for o, g in zip(outs, gots):
        _close(g.detach().numpy(), o)
    assert all(torch.equal(v, before[k]) for k, v in _stats(model).items())


@pytest.mark.parametrize("name", list(TYPES))
def test_train_forward_matches_flax_in_float64(name):
    x = _inputs(name).astype(np.float64)
    jm, variables, model = _pair(name, x.astype(np.float32), perturb_stats=False)
    model = _float64(model).train()
    before = _stats(model)
    with jax.enable_x64(True):
        outs, want = _flax_train(jm.clone(dtype=jnp.float64), _to_float64(variables), x)
    gots = _as_tuple(model(torch.from_numpy(x)))
    assert len(outs) == len(gots)
    for o, g in zip(outs, gots):
        _close(g.detach().numpy(), o)
    after = _stats(model)
    assert set(after) == {k for k in want if "running_" in k}
    assert all(not torch.equal(v, before[k]) for k, v in after.items())
    _close_stats(after, want)


def _flax_step(module, variables, x):
    """(loss, new running statistics, gradients) of one flax SimSiam-v2
    step, the last two as port state dicts."""
    def loss_fn(params):
        (p1, z1), mutated = module.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        return jax_ncs(p1, z1), mutated["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return (float(loss), flax_variables_to_state_dict({}, jax.device_get(stats)),
            flax_variables_to_state_dict(jax.device_get(grads)))


def _port_step(model, x):
    """(loss, the largest |cosine| of its rows, the named parameters with
    their gradients)."""
    model.train()
    p1, z1 = model(torch.from_numpy(x))
    loss = negative_cosine_similarity(p1, z1)
    loss.backward()
    cos = torch.nn.functional.cosine_similarity(p1.detach(), z1, dim=1)
    return loss.item(), float(cos.abs().max()), dict(model.named_parameters())


def test_ss2_train_step_matches_flax():
    """Loss and new running statistics of one SimSiam-v2 step in float32,
    its gradients in float64."""
    x = _inputs("ss2")
    jm, variables, model = _pair("ss2", x, perturb_stats=False)
    m64 = _float64(model)
    ref_loss, ref_stats, _ = _flax_step(jm, variables, x)
    # the loss is a mean of cosines that cancel (-0.014 here, rows up to
    # 0.3): held against its largest term
    loss, largest_term, _ = _port_step(model, x)
    assert abs(loss - ref_loss) <= 1e-4 * largest_term
    _close_stats(_stats(model), ref_stats)

    with jax.enable_x64(True):
        _, _, want = _flax_step(jm.clone(dtype=jnp.float64), _to_float64(variables),
                                x.astype(np.float64))
    _, _, named = _port_step(m64, x.astype(np.float64))
    assert set(named) == set(want)
    largest = max(float(g.abs().max()) for g in want.values())
    for k, p in named.items():
        if k == "projector.fc3.bias":    # zero in exact arithmetic
            assert max(float(p.grad.abs().max()), float(want[k].abs().max())) <= 1e-10 * largest
        else:
            _close(p.grad.numpy(), want[k].numpy())
    # the loss combination sums its criterions
    p1, z1 = model(torch.from_numpy(x))
    both = loss_combination([negative_cosine_similarity, negative_cosine_similarity])
    assert torch.allclose(both(p1, z1), 2 * negative_cosine_similarity(p1, z1))


def test_batchnorm_keeps_the_biased_variance_and_f32_statistics():
    """flax's statistics: the biased variance, in float32 from bf16 input,
    momentum 0.99 on the old value; the output in the input's dtype."""
    bn = BatchNorm(3).train()
    x = torch.randn(4, 3, 5, 5).to(torch.bfloat16)
    y = bn(x)
    xf = x.float()
    mean = xf.mean((0, 2, 3))
    var = xf.var((0, 2, 3), unbiased=False)
    assert y.dtype == torch.bfloat16
    torch.testing.assert_close(bn.running_mean, 0.01 * mean, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var, rtol=1e-5, atol=1e-6)


class Args(types.SimpleNamespace):
    pass


def _write_hisfrag(root, n_writers=6, frags=3, size=70):
    rng = np.random.default_rng(0)
    d = os.path.join(root, "train")
    os.makedirs(d, exist_ok=True)
    for w in range(n_writers):
        for f in range(frags):
            arr = rng.integers(0, 255, (size, size, 3), np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"w{w:03d}_0_{f}.jpg"))


SS_CFG = """
MODEL:
  TYPE: ss2
  NAME: tiny_ss2
  NUM_CLASSES: 0
  SS:
    ARCH: resnet18
    EMBED_DIM: 32
    PRED_DIM: 16
DATA:
  DATASET: hisfrag20
  IMG_SIZE: 64
  BATCH_SIZE: 1
  TEST_BATCH_SIZE: 8
  NUM_WORKERS: 0
TRAIN:
  EPOCHS: 1
  WARMUP_EPOCHS: 0
SAVE_FREQ: 1
PRINT_FREQ: 10
"""


class SS2Trainer(HisfragVitTrainer):
    """Single-view SimSiam on fragment crops (the trainer of the JAX
    package's tests/test_ss_entry.py)."""

    def make_loss_fn(self, criterion):
        def loss_fn(model, batch):
            p1, z1 = model(batch["samples"])
            return negative_cosine_similarity(p1.float(), z1.float())

        return loss_fn

    def validate(self):
        self.model.eval()
        with torch.inference_mode():
            for images, _ in self.get_dataloader("val"):
                p1, z1 = self.model(self._to_device({"x": images})["x"])
                return float(negative_cosine_similarity(p1.float(), z1.float()))
        return 0.0


def _ss_trainer(tmp_path):
    data = tmp_path / "hf"
    if not data.exists():
        _write_hisfrag(str(data))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(SS_CFG)
    return SS2Trainer(Args(cfg=str(cfg), opts=None, data_path=str(data),
                           output=str(tmp_path / "out"), tag="test", mode="train",
                           device="cpu", disable_amp=True, batch_size=None,
                           pretrained=None, resume=None, accumulation_steps=None,
                           use_checkpoint=False, optim=None))


def test_ss2_trainer_threads_batch_stats(tmp_path):
    trainer = _ss_trainer(tmp_path)
    init = _stats(trainer.model)
    assert init
    trainer.train()
    assert trainer.step > 0
    moved = _stats(trainer.model)
    assert not torch.allclose(init["encoder.bn1.running_mean"],
                              moved["encoder.bn1.running_mean"])
    ckpt_path = os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt")
    saved = torch.load(ckpt_path, map_location="cpu", weights_only=True)["model"]
    assert all(torch.equal(saved[k], v) for k, v in moved.items())

    resumed = _ss_trainer(tmp_path)
    resumed.config.defrost()
    resumed.config.MODEL.RESUME = ckpt_path
    resumed.config.freeze()
    assert torch.equal(_stats(resumed.model)["encoder.bn1.running_mean"],
                       init["encoder.bn1.running_mean"])
    resumed.setup_training(10)
    resumed._load_resume()
    restored = _stats(resumed.model)
    assert all(torch.equal(restored[k], v) for k, v in moved.items())
    assert resumed.step == trainer.step


@pytest.mark.parametrize("name", ["resnet50", "mixconv", "ss", "ss2ce"])
def test_layer_flops_match_torch_counter(name):
    """The forward against ``FlopCounterMode``; the backward too, except
    mixconv's (torch's counter ignores the groups of its depthwise
    convolution's backward and counts it as a dense one)."""
    model = build_model(_config(name))
    x = torch.from_numpy(_inputs(name, b=2))
    forward, backward = layer_step_flops(model, x.shape)
    model.train()
    with FlopCounterMode(display=False) as fwd:
        out = _as_tuple(model(x))
    with FlopCounterMode(display=False) as bwd:
        sum(o.float().square().sum() for o in out if o.requires_grad).backward()
    assert fwd.get_total_flops() == forward
    if name != "mixconv":
        assert bwd.get_total_flops() == backward
    assert backward < 2 * forward


def test_build_model_builds_every_type():
    for name in TYPES:
        config = _config(name, amp=True)
        model = build_model(config)
        assert model.dtype == torch.bfloat16
        assert model.seed_drop_path(3).initial_seed() == 3
    assert backbone_size(512, "resnet34") == 16 and backbone_size(64, "resnet18") == 2


def _bf16_reading(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", ["ss2", "resnet18"])
def test_bf16_train_forward_against_flax_bf16(name):
    """The BatchNorm types in bf16 in train mode against flax's bf16 on the
    same variables (64 px, batch 16): whether a bf16-against-f32 reading of
    0.24-0.51 (the card's SimSiam heads at 512 px, PERF.md PR 10) is the
    reference's own or a rounding point the port places elsewhere.

    - layer by layer, each layer type given ONE bf16 input (a Conv2d, a
      train-mode BatchNorm, a Dense, as the models build them) equals flax's
      bf16 output within one bf16 ulp of its max (2^-8): the rounding
      points are flax's;
    - the whole forward in bf16 lies within 3x as far from flax's bf16 as
      flax's own bf16 lies from flax's f32, and both are far (> 1e-2),
      while the port's f32 is within 1e-4 of flax's f32: the gap is bf16
      rounding carried through many renormalising layers, in both packages.
    """
    from flax import linen as fnn

    from vit_ed_tpu_torch.models.resnet import Conv2d, Dense

    rng = np.random.default_rng(2)
    ulp = 2.0 ** -8
    x = rng.normal(size=(16, 8, 8, 32)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    # a train-mode BatchNorm (flax's, momentum 0.99 as the blocks build it)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, dtype=jnp.bfloat16)
    bv = bn.init(jax.random.PRNGKey(0), xb)
    bv = {"params": {"scale": rng.normal(1.0, 0.1, 32).astype(np.float32),
                     "bias": rng.normal(0.0, 0.1, 32).astype(np.float32)},
          "batch_stats": bv["batch_stats"]}
    want, _ = bn.apply(bv, xb, mutable=["batch_stats"])
    port_bn = BatchNorm(32).train()
    port_bn.weight.data = torch.from_numpy(bv["params"]["scale"])
    port_bn.bias.data = torch.from_numpy(bv["params"]["bias"])
    got = port_bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _bf16_reading(got.float().detach(), want.astype(jnp.float32)) <= ulp
    # a 3 x 3 convolution and a Dense, each in bf16
    conv = fnn.Conv(16, (3, 3), padding=1, use_bias=False, dtype=jnp.bfloat16)
    cv = conv.init(jax.random.PRNGKey(1), xb)
    port_conv = Conv2d(32, 16, 3, padding=1, dtype=torch.bfloat16)
    port_conv.weight.data = torch.from_numpy(
        np.transpose(np.asarray(cv["params"]["kernel"]), (3, 2, 0, 1)).copy())
    got = port_conv(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _bf16_reading(got.float().detach(), conv.apply(cv, xb).astype(jnp.float32)) <= ulp
    dense = fnn.Dense(24, dtype=jnp.bfloat16)
    dv = dense.init(jax.random.PRNGKey(2), xb[:, 0, 0])
    port_dense = Dense(32, 24, dtype=torch.bfloat16)
    port_dense.weight.data = torch.from_numpy(np.asarray(dv["params"]["kernel"]).T.copy())
    port_dense.bias.data = torch.from_numpy(np.array(dv["params"]["bias"]))
    got = port_dense(xt[:, 0, 0])
    assert _bf16_reading(got.float().detach(),
                         dense.apply(dv, xb[:, 0, 0]).astype(jnp.float32)) <= ulp

    # the whole train-mode forward
    x = _inputs(name, b=16)
    jm, variables, model = _pair(name, x, perturb_stats=False)
    jm16 = jax_build_model(_config(name, amp=True))
    m16 = build_model(_config(name, amp=True))
    m16.load_state_dict(model.state_dict())
    f32, _ = _flax_train(jm, variables, x)
    f16, _ = _flax_train(jm16, variables, x)
    with torch.no_grad():
        p32 = _as_tuple(model.train()(torch.from_numpy(x)))
        p16 = _as_tuple(m16.train()(torch.from_numpy(x)))
    for a32, a16, b32, b16 in zip(f32, f16, p32, p16):
        assert b16.dtype == torch.bfloat16 and a16.dtype == jnp.bfloat16
        flax_own = _bf16_reading(a16.astype(jnp.float32), a32)
        port_vs_flax = _bf16_reading(b16.float(), a16.astype(jnp.float32))
        assert _bf16_reading(b32, a32) <= 1e-4
        assert flax_own > 1e-2 and port_vs_flax <= 3 * flax_own, (flax_own, port_vs_flax)
