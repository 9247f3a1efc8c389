"""Two model options the port now trains with, against the JAX package on
the CPU:

- ``TPU.FAST_GELU``: the tanh GELU in every MLP; the pjs ViT-ED's pair
  logits on the JAX model's converted weights within 1e-4 (f32), and in
  bf16 within 5e-2 (the bound of tests/test_torch_model.py);
- ``MODEL.DROP_RATE``: the head dropout of the pjs ViT-ED on the CLS row,
  as in the JAX model (the plain ViT builds none, in both packages): the
  mask is drawn from the model's own generator (the DropPath one), kept
  elements are scaled by 1 / (1 - p), eval mode is untouched, and one
  generator seed gives the same training forward twice.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.models.convert import load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.ops.gelu import gelu_exact, gelu_tanh

ROOT = Path(__file__).resolve().parent.parent
KW = dict(embed_dim=64, num_heads=2, depth=1, c_depth=2, img_size=32, patch_size=8,
          num_classes=4)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 5e-2)])
def test_fast_gelu_logits_match_jax(dtype, tol):
    x = np.random.default_rng(0).normal(size=(3, 2, 32, 32, 3)).astype(np.float32)
    jm = JaxViTED(**KW, use_pallas=False, fast_gelu=True, dtype=getattr(jnp, dtype))
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0),
                                                       jnp.asarray(x[:1]))["params"])
    ref = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)), np.float32)
    model = load_jax_params(ViTED(**KW, fast_gelu=True, dtype=getattr(torch, dtype)),
                            params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).float().numpy()
        exact = load_jax_params(ViTED(**KW, dtype=getattr(torch, dtype)), params).eval()(
            torch.from_numpy(x)).float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol * scale
    assert np.abs(exact - ref).max() > 0             # the option changes the model


def test_build_model_reads_fast_gelu_and_drop_rate():
    args = types.SimpleNamespace(
        cfg=str(ROOT / "configs" / "puzzle" / "div2k_erosion7_4bin_patch8_64.yaml"),
        opts=["MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1", "TPU.FAST_GELU", "True",
              "MODEL.DROP_RATE", "0.25"])
    model = build_model(get_config(args))
    acts = {m.mlp.act for m in list(model.blocks) + list(model.cross_blocks)}
    assert acts == {gelu_tanh} and model.head_drop.rate == 0.25
    args.opts = args.opts[:4]
    model = build_model(get_config(args))
    assert model.blocks[0].mlp.act is gelu_exact and model.head_drop.rate == 0.0


def test_head_dropout_draws_from_the_model_generator():
    torch.manual_seed(0)
    p = 0.5
    model = ViTED(**KW, drop_rate=p)
    x = torch.randn(6, 2, 32, 32, 3)
    head = model.head
    seen = []
    hook = head.register_forward_pre_hook(lambda m, a: seen.append(a[0].clone()))
    model.train().seed_drop_path(11)
    out = model(x)
    model.seed_drop_path(11)
    again = model(x)
    with torch.no_grad():
        ref = model.eval()(x)
    hook.remove()
    assert torch.equal(out, again)                   # one seed, the same masks
    assert not torch.allclose(out, ref)
    # the head's input: the CLS row, each element kept and scaled by
    # 1 / (1 - p) or zeroed, as the generator's Bernoulli draw says
    cls = model.cross_part_cls(model.encode(x[:, 0]), model.prepare_x2(x[:, 1]))
    gen = torch.Generator().manual_seed(11)
    mask = torch.bernoulli(torch.full(seen[0].shape, 1 - p), generator=gen).bool()
    assert 0 < int(mask.sum()) < mask.numel()
    torch.testing.assert_close(seen[0], torch.where(mask, cls[:, 0] / (1 - p),
                                                    torch.zeros_like(cls[:, 0])))
    torch.testing.assert_close(seen[2], cls[:, 0])   # eval: no dropout
    # the dropout is in the graph: dropped elements get no gradient
    model.train().seed_drop_path(11)
    model.zero_grad()
    model(x).sum().backward()
    assert model.head.weight.grad is not None
    assert torch.all(model.head.weight.grad[:, ~mask.any(0)] == 0)


# the switches the port still refuses: each raises naming its part of
# ROADMAP item 12b (part 2: the token axis on 'model', part 3: the pipeline;
# part 1, FSDP / TP / EP, is ported: tests/test_torch_mesh_train.py)
UNPORTED_SWITCHES = [
    ("TPU.SEQ_PARALLEL", "True", 2), ("TPU.RING_ATTN", "True", 2),
    ("TPU.PIPELINE_STAGES", "2", 3),
]


def _hisfrag_config(*opts):
    return get_config(types.SimpleNamespace(
        cfg=str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml"),
        opts=["MODEL.PJS.EMBED_DIM", "64", "MODEL.PJS.NUM_HEADS", "2", "MODEL.PJS.DEPTH", "2",
              "MODEL.PJS.C_DEPTH", "1", "DATA.IMG_SIZE", "32", *opts]))


@pytest.mark.parametrize("key,value,part", UNPORTED_SWITCHES)
def test_unported_switches_raise_with_their_roadmap_item(key, value, part):
    with pytest.raises(NotImplementedError, match=rf"{key}.*item 12b part {part}"):
        build_model(_hisfrag_config(key, value))


@pytest.mark.parametrize("key,value,part", UNPORTED_SWITCHES)
def test_trainer_on_a_mesh_refuses_the_unported_switches(tmp_path, key, value, part):
    """Through the trainer (its mesh and checks first): SEQ_PARALLEL and
    RING_ATTN on a ``model`` axis, and PIPELINE_STAGES, still raise naming
    A12b part 2 or 3."""
    from vit_ed_tpu_torch.train.engine import Trainer

    # RING_ATTN needs SEQ_PARALLEL (the JAX check), which raises first
    ring = ["TPU.SEQ_PARALLEL", "True"] if key == "TPU.RING_ATTN" else []
    opts = ["TPU.MESH_SHAPE", "[1, 1]", *ring, key, value]
    args = types.SimpleNamespace(device="cpu", cfg=str(ROOT / "configs" / "hisfrag" /
                                                       "hisfrag20_patch16_512.yaml"),
                                 output=str(tmp_path),
                                 opts=["MODEL.PJS.EMBED_DIM", "64", "MODEL.PJS.NUM_HEADS",
                                       "1", "MODEL.PJS.DEPTH", "1", "MODEL.PJS.C_DEPTH", "1",
                                       "DATA.IMG_SIZE", "32", *opts])
    want = "TPU.SEQ_PARALLEL" if ring else key
    with pytest.raises(NotImplementedError, match=rf"{want}.*item 12b part {part}"):
        Trainer(args)


def test_meshes_and_multichip_bundles_raise_with_their_roadmap_item(tmp_path):
    """A mesh with the token axis on 'model' (the trainer; part 2), a
    multi-chip bundle (export, load, the host's --mesh-data, the export
    entry's --mesh-data; part 4) raise naming item 12b."""
    from vit_ed_tpu_torch import export_serving
    from vit_ed_tpu_torch.serve import export_scorer, load_scorer
    from vit_ed_tpu_torch.serve.server import main as serve_main
    from vit_ed_tpu_torch.train.engine import Trainer

    args = types.SimpleNamespace(
        device="cpu", cfg=str(ROOT / "configs" / "hisfrag" / "hisfrag20_patch16_512.yaml"),
        output=str(tmp_path / "out"),
        opts=["TPU.MESH_SHAPE", "[1, 1]", "TPU.SEQ_PARALLEL", "True"])
    with pytest.raises(NotImplementedError, match="item 12b"):
        Trainer(args)
    model = build_model(_hisfrag_config()).eval()
    with pytest.raises(NotImplementedError, match="item 12b"):
        export_scorer(model, None, str(tmp_path), mesh=object(), device="cpu")
    export_scorer(model, None, str(tmp_path), stages=("pair",), device="cpu")
    with pytest.raises(NotImplementedError, match="item 12b"):
        load_scorer(str(tmp_path), device="cpu", mesh=object())
    with pytest.raises(NotImplementedError, match="item 12b"):
        serve_main(["--bundle", str(tmp_path), "--device", "cpu", "--mesh-data", "2"])
    with pytest.raises(NotImplementedError, match="item 12b"):
        export_serving.main(["--cfg", args.cfg, "--output", str(tmp_path / "b"),
                             "--device", "cpu", "--mesh-data", "2"])


def test_moe_experts_builds_encoder_banks():
    """MODEL.PJS.MOE.EXPERTS > 0 no longer raises: every INTERVAL-th encoder
    block gets a bank with the config's knobs, the decoder stays dense."""
    from vit_ed_tpu_torch.models.moe import MoeMlp

    model = build_model(_hisfrag_config(
        "MODEL.PJS.MOE.EXPERTS", "4", "MODEL.PJS.MOE.ROUTE_K", "2",
        "MODEL.PJS.MOE.CAPACITY", "2.0", "MODEL.PJS.MOE.JITTER", "0.1"))
    banks = [isinstance(b.mlp, MoeMlp) for b in model.blocks]
    assert banks == [False, True]
    bank = model.blocks[1].mlp
    assert (bank.num_experts, bank.route_k, bank.capacity_factor, bank.jitter) == (4, 2, 2.0, 0.1)
    assert not any(isinstance(m, MoeMlp) for m in model.cross_blocks.modules())
    x = torch.zeros(2, 2, 32, 32, 3)
    with torch.no_grad():
        out, aux = model.eval()(x, with_aux=True)
    assert out.shape == (2, 1) and aux.shape == (1, 2)
