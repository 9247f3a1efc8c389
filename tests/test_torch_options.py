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
