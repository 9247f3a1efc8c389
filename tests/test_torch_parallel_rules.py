"""The parameter-sharding rules of the port (``vit_ed_tpu_torch/parallel/
{tp,fsdp,ep,compose}.py``) against the JAX package's
(``vit_ed_tpu/parallel/{tp,fsdp,ep,compose}.py``), leaf by leaf, through the
conversion's names and transpositions; the tensor-parallel head-aligned
split and the attention route it keeps; the trainer's mesh checks against
the JAX trainer's messages.

The JAX leaves come from ``jax.eval_shape`` of the model's init and the
port's from a model built on the meta device: no weights are made, so the
full-width pjs-S (patch16_512), pjs-L and pjs-L MoE configurations are held
as well as a tiny MoE pjs.
"""

import types
from pathlib import Path

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._device import _device_constructors

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.parallel import compose as jax_compose
from vit_ed_tpu.parallel.compose import composed_param_specs as jax_composed
from vit_ed_tpu.parallel.ep import ep_param_specs as jax_ep
from vit_ed_tpu.parallel.fsdp import fsdp_param_specs as jax_fsdp
from vit_ed_tpu.parallel.tp import tp_param_specs as jax_tp
from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.ops import attention as A
from vit_ed_tpu_torch.parallel import compose, ep, fsdp, tp
from vit_ed_tpu_torch.parallel.mesh import Spec, create_mesh, default_axes

ROOT = Path(__file__).resolve().parent.parent
HISFRAG = ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml"
NO_MESH = ["TPU.MESH_SHAPE", "[]", "TPU.MESH_AXES", "[]", "TPU.TENSOR_PARALLEL", "False",
           "TPU.SEQ_PARALLEL", "False", "TPU.EXPERT_PARALLEL", "False", "TPU.FSDP", "False"]
# (name, config, opts): the tiny MoE pjs of tests/test_compose_parallel.py and
# the full-width configurations of configs/
MODELS = {
    "tiny_moe": (HISFRAG, ["MODEL.PJS.EMBED_DIM", "32", "MODEL.PJS.NUM_HEADS", "2",
                           "MODEL.PJS.DEPTH", "2", "MODEL.PJS.C_DEPTH", "2",
                           "DATA.IMG_SIZE", "32", "MODEL.PJS.PATCH_SIZE", "16",
                           "MODEL.NUM_CLASSES", "4", "MODEL.PJS.MOE.EXPERTS", "2",
                           "MODEL.PJS.MOE.INTERVAL", "2"]),
    "pjsS": (HISFRAG, []),
    "pjsL": (ROOT / "configs" / "scale" / "hisfrag20_pjsL_tp_sp.yaml", NO_MESH),
    "pjsL_moe": (ROOT / "configs" / "scale" / "hisfrag20_pjsL_moe_hybrid.yaml", NO_MESH),
}
# (rules, data axis size) held on every model
RULES = [("tp", 2), ("fsdp", 2), ("fsdp", 8), ("ep", 2), ("tp+ep+fsdp", 2),
         ("tp+fsdp", 4)]


def _config(name):
    cfg, opts = MODELS[name]
    return get_config(types.SimpleNamespace(cfg=str(cfg), opts=list(opts)))


def _shapes(name):
    """(JAX leaves {path: shape}, port model on the meta device)."""
    config = _config(name)
    pjs = config.MODEL.PJS
    jm = JaxViTED(img_size=config.DATA.IMG_SIZE, patch_size=pjs.PATCH_SIZE,
                  num_classes=config.MODEL.NUM_CLASSES, embed_dim=pjs.EMBED_DIM,
                  depth=pjs.DEPTH, c_depth=pjs.C_DEPTH, num_heads=pjs.NUM_HEADS,
                  mlp_ratio=pjs.MLP_RATIO, qkv_bias=pjs.QKV_BIAS,
                  moe_experts=pjs.MOE.EXPERTS, moe_interval=pjs.MOE.INTERVAL,
                  use_pallas=False)
    s = config.DATA.IMG_SIZE
    tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                          jnp.zeros((1, 2, s, s, 3))))["params"]
    with _MetaParams():
        model = build_model(config)
    return tree, model


class _MetaParams(torch.overrides.TorchFunctionMode):
    """Tensors made without a device go to the meta device (no memory),
    except the drop-path schedule the model reads back as numbers."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in _device_constructors() and kwargs.get("device") is None:
            kwargs["device"] = "cpu" if func is torch.linspace else "meta"
        return func(*args, **kwargs)


@pytest.fixture(scope="module")
def shapes():
    return {name: _shapes(name) for name in MODELS}


def _torch_name(path):
    """The conversion's name of a flax leaf (models/convert.py): ``blocks_3``
    -> ``blocks.3``, ``kernel`` / ``scale`` -> ``weight``."""
    parts = []
    for key in path:
        stem, _, idx = key.rpartition("_")
        parts += [stem, idx] if stem in ("blocks", "cross_blocks") and idx.isdigit() else [key]
    if parts[-1] in ("kernel", "scale"):
        parts[-1] = "weight"
    return ".".join(parts)


def _flax_to_torch_dim(shape, leaf, dim):
    """The torch dim a flax dim becomes under the conversion: a Dense kernel
    is transposed, a conv kernel [kh, kw, C, D] becomes [D, C, kh, kw]."""
    if leaf == "kernel" and len(shape) == 2:
        return 1 - dim
    if leaf == "kernel" and len(shape) == 4:
        return (3, 2, 0, 1).index(dim)
    return dim


def _jax_specs(tree, rules, data):
    on = set(rules.split("+"))
    if len(on) == 1:
        fn = {"tp": lambda t: jax_tp(t), "ep": lambda t: jax_ep(t),
              "fsdp": lambda t: jax_fsdp(t, data)}[rules]
        return fn(tree)
    return jax_composed(tree, tp="tp" in on, ep="ep" in on, fsdp="fsdp" in on,
                        data_axis_size=data)


def _port_specs(model, rules, data):
    on = set(rules.split("+"))
    if len(on) == 1:
        return {"tp": lambda: tp.tp_param_specs(model), "ep": lambda: ep.ep_param_specs(model),
                "fsdp": lambda: fsdp.fsdp_param_specs(model, data)}[rules]()
    return compose.composed_param_specs(model, tp="tp" in on, ep="ep" in on,
                                        fsdp="fsdp" in on, data_axis_size=data)


@pytest.mark.parametrize("rules,data", RULES)
@pytest.mark.parametrize("name", list(MODELS))
def test_specs_equal_jax_rules_leaf_by_leaf(shapes, name, rules, data):
    tree, model = shapes[name]
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(
        _jax_specs(tree, rules, data), is_leaf=lambda x: isinstance(x, P))[0]
    leaves = dict((tuple(k.key for k in path), leaf) for path, leaf in
                  jax.tree_util.tree_flatten_with_path(tree)[0])
    for path, spec in flat:
        keys = tuple(k.key for k in path)
        shape = leaves[keys].shape
        split = [(d, a) for d, a in enumerate(spec) if a is not None]
        assert len(split) <= 1, (keys, spec)
        want[_torch_name(keys)] = (Spec(split[0][1], _flax_to_torch_dim(
            shape, keys[-1], split[0][0])) if split else None)
    got = _port_specs(model, rules, data)
    assert got.keys() == want.keys()
    assert got == want
    # a dense model has no bank for EP to split
    assert any(s is not None for s in got.values()) == (rules != "ep" or "moe" in name)
    # every torch leaf has the flax leaf's shape through the conversion
    params = dict(model.named_parameters())
    for path, leaf in leaves.items():
        shape = params[_torch_name(path)].shape
        assert sorted(shape) == sorted(leaf.shape), (path, shape, leaf.shape)


def test_conflicting_shardings_raise_as_in_jax(shapes, monkeypatch):
    """A leaf claimed by two rules raises the JAX package's error in both."""
    tree, model = shapes["tiny_moe"]
    monkeypatch.setattr(jax_compose, "ep_param_specs", lambda p: jax_tp(p))
    with pytest.raises(ValueError, match="conflicting shardings"):
        jax_composed(tree, tp=True, ep=True)
    monkeypatch.setattr(compose, "ep_param_specs", lambda m: tp.tp_param_specs(m))
    with pytest.raises(ValueError, match="conflicting shardings"):
        compose.composed_param_specs(model, tp=True, ep=True)


@pytest.mark.parametrize("c,heads", [(256, 4), (128, 8)])
def test_head_aligned_qkv_shards_attend_to_their_heads(c, heads):
    """Rank m of t = 2 holds its H/t heads of q, k and v (``tp.shard_index``);
    the shards gathered in the index order give the whole tensor, and each
    rank's attention on its share equals the unsharded call's output on
    those heads bit for bit: the pair route at head_dim 64 (C % 128 == 0
    per rank, the route picked from the unsharded width) and the 4-D route
    at head_dim 16."""
    t = 2
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 17, 3 * c)).astype(np.float32))
    whole = A.fused_attention_packed_qkv(qkv, heads)
    spec = Spec("model", 0)
    idx = [tp.shard_index("blocks.0.attn.qkv.weight", spec, 3 * c, t, m) for m in range(t)]
    assert torch.equal(torch.sort(torch.cat(idx))[0], torch.arange(3 * c))
    for m in range(t):
        share = A.fused_attention_packed_qkv(qkv[..., idx[m]], heads // t, width=c)
        cols = slice(m * c // t, (m + 1) * c // t)
        assert torch.equal(share, whole[..., cols])


def test_pair_route_share_outside_the_kernel_contract_raises():
    """A share that would leave the pair kernel's C % 128 == 0 (pjs-S's 6
    heads over 2 ranks: C = 192) raises instead of switching route."""
    qkv = torch.zeros(1, 5, 3 * 192)
    with pytest.raises(NotImplementedError, match="C % 128 == 0"):
        A.fused_attention_packed_qkv(qkv, 3, width=384)


def test_heads_must_split_over_the_model_axis():
    config = _config("tiny_moe")
    config.defrost()
    config.MODEL.PJS.NUM_HEADS = 1
    config.MODEL.PJS.EMBED_DIM = 16
    model = build_model(config)
    with pytest.raises(ValueError, match="heads do not split over 2 'model' ranks"):
        tp.apply_tp(model, tp.tp_param_specs(model), None, 2)


def test_mesh_defaults_and_world():
    """The engine's axis defaults; one process lays a mesh of one rank, and
    a mesh of more ranks than the world raises."""
    assert default_axes([], []) == ("data",)
    assert default_axes([2, 4], []) == ("data", "model")
    assert default_axes([8], []) == ("data",)
    assert default_axes([2, 2, 2], ["data", "model", "expert"]) == ("data", "model",
                                                                     "expert")
    mesh = create_mesh([1, 1], ("data", "model"))
    assert mesh.shape == {"data": 1, "model": 1} and mesh.index("expert") == 0
    assert create_mesh(None, ("data",)).shape == {"data": 1}
    with pytest.raises(ValueError, match="WORLD_SIZE is 1"):
        create_mesh([2], ("data",))


# (port opts, JAX opts): each check of vit_ed_tpu/train/engine.py
CHECKS = {
    "tp_without_model": (["TPU.MESH_SHAPE", "[1]", "TPU.TENSOR_PARALLEL", "True"],
                         ["TPU.MESH_SHAPE", "[8]", "TPU.TENSOR_PARALLEL", "True"]),
    "ring_without_sp": (["TPU.MESH_SHAPE", "[1, 1]", "TPU.RING_ATTN", "True"],
                        ["TPU.MESH_SHAPE", "[4, 2]", "TPU.RING_ATTN", "True"]),
    "fsdp_without_data": (["TPU.MESH_SHAPE", "[1]", "TPU.MESH_AXES", "[model]",
                           "TPU.FSDP", "True"],
                          ["TPU.MESH_SHAPE", "[8]", "TPU.MESH_AXES", "[model]",
                           "TPU.FSDP", "True"]),
    "ep_without_expert": (["TPU.MESH_SHAPE", "[1]", "TPU.EXPERT_PARALLEL", "True"],
                          ["TPU.MESH_SHAPE", "[8]", "TPU.EXPERT_PARALLEL", "True"]),
    "ep_experts_not_a_multiple": (
        ["TPU.MESH_SHAPE", "[1, 1]", "TPU.MESH_AXES", "[data, expert]",
         "TPU.EXPERT_PARALLEL", "True"],
        ["TPU.MESH_SHAPE", "[4, 2]", "TPU.MESH_AXES", "[data, expert]",
         "TPU.EXPERT_PARALLEL", "True", "MODEL.PJS.MOE.EXPERTS", "3"]),
}


@pytest.mark.parametrize("check", list(CHECKS))
def test_trainer_checks_say_what_the_jax_trainer_says(tmp_path, check):
    from vit_ed_tpu.train.engine import Trainer as JaxTrainer
    from vit_ed_tpu_torch.train.engine import Trainer

    port_opts, jax_opts = CHECKS[check]
    base = ["MODEL.PJS.EMBED_DIM", "64", "MODEL.PJS.NUM_HEADS", "1", "MODEL.PJS.DEPTH", "1",
            "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32"]

    def args(opts, out):
        return types.SimpleNamespace(cfg=str(HISFRAG), device="cpu", opts=base + opts,
                                     output=str(tmp_path / out), mode="train")

    with pytest.raises(ValueError) as jax_err:
        JaxTrainer(args(jax_opts, "jax"))
    with pytest.raises(ValueError) as port_err:
        Trainer(args(port_opts, "port"))
    assert str(port_err.value) == str(jax_err.value)
