"""The port's int8 scoring (``vit_ed_tpu_torch/ops/quant.py``) against the
JAX package's ``vit_ed_tpu/ops/quant.py``: the dynamic int8 GEMM equals
``jax.jit(int8_matmul)`` bit for bit, a checkpoint loads ``strict=True``
with the route on or off, and the int8 scan's scores and mAP hold to the
JAX int8 scan on the weights that tests/test_quant.py trains (the gate of
``TPU.INT8_SCORE``)."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.ops.quant import int8_matmul as jax_int8_matmul
from vit_ed_tpu.parallel.mesh import create_mesh
from vit_ed_tpu.parallel.pairs import PairwiseScorer as JaxPairwiseScorer
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.models.convert import load_jax_params
from vit_ed_tpu_torch.models.layers import Linear
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.ops import quant
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

_JIT = jax.jit(jax_int8_matmul, static_argnames=("out_dtype",))
DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(1, 32, 8), (5, 16, 24), (12, 384, 384),
                                   (2, 33, 384, 1152), (64, 1536, 384),
                                   (1025, 384, 768), (300, 384, 1536)])
def test_int8_matmul_equals_the_jitted_jax_function(shape, dtype):
    """0 mismatches: the reciprocal scale and the once-rounded epilogue of
    XLA's compilation (M <= 16 included; a 3-D input quantizes per token)."""
    tdt, jdt = DTYPES[dtype]
    *lead, k, n = shape
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=(*lead, k)).astype(np.float32) * 3).to(tdt)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    ref = _JIT(jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(w),
               jnp.asarray(b), out_dtype=jdt)
    got = quant.int8_matmul(x, torch.from_numpy(w.T.copy()), torch.from_numpy(b))
    assert got.dtype == tdt and tuple(got.shape) == (*lead, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref.astype(jnp.float32)))
    # without a bias, and the plain int32 product equals the library one
    ref = _JIT(jnp.asarray(x.float().numpy()).astype(jdt), jnp.asarray(w), out_dtype=jdt)
    got = quant.int8_matmul(x, torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    xq, _ = quant.quantize_rows(x.reshape(-1, k))
    wq, _ = quant.quantize_rows(torch.from_numpy(w.T.copy()), dim=1)
    assert torch.equal(quant.int8_mm(xq, wq), quant.int8_mm_plain(xq, wq))


def test_weights_quantize_from_their_float32_parameter():
    lin = Linear(48, 40)
    x = torch.randn(7, 48, generator=torch.Generator().manual_seed(1)).bfloat16()
    with quant.int8_gemms(torch.nn.ModuleDict({"blocks": torch.nn.ModuleList([lin])})):
        wq, sw, _amax = lin.int8_weight
        got = lin(x)
    ref_q, ref_s = quant.quantize_rows(lin.weight, dim=1)
    assert torch.equal(wq, ref_q) and torch.equal(sw, ref_s)
    assert not torch.equal(sw, quant.quantize_rows(lin.weight.bfloat16(), dim=1)[1])
    assert torch.equal(got, quant.int8_matmul(x, lin.weight, lin.bias))
    assert lin.int8_weight is None and not torch.equal(lin(x), got)


KW = dict(img_size=32, patch_size=16, num_classes=1, embed_dim=32,
          depth=1, c_depth=2, num_heads=2)


@pytest.fixture(scope="module")
def trained():
    """tests/test_quant.py's fixture: writer-correlated images and a
    ViT-ED trained on them in JAX, so that its scores carry signal."""
    from test_quant import _DS, _train_tiny, _writer_dataset

    jm = JaxViTED(**KW, use_pallas=False)
    imgs, labels = _writer_dataset()
    variables = jax.jit(jm.init)(jax.random.PRNGKey(1), jnp.zeros((1, 2, 32, 32, 3)))
    params, _ = _train_tiny(jm, variables["params"], imgs, labels)
    params = jax.tree.map(np.asarray, params)
    return jm, params, imgs, labels, _DS


def test_int8_switch_keeps_the_parameters_and_loads_strict(trained):
    jm, params, _imgs, _labels, _ds = trained
    model = load_jax_params(ViTED(**KW), params)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    with quant.int8_gemms(model):
        assert list(model.state_dict()) == list(sd)
        model.load_state_dict(sd, strict=True)
        on = [m for m in model.modules() if isinstance(m, Linear) and m.int8_weight]
    # qkv, proj, fc1, fc2 of the encoder block; qkv, proj, q, kv, proj,
    # fc1, fc2 of each decoder block; not the head
    assert len(on) == 4 + 2 * 7 and model.head.int8_weight is None
    assert all(m.int8_weight is None for m in model.modules() if isinstance(m, Linear))
    PairwiseScorer(model, int8=True).score_dense(
        np.zeros((3, 32, 32, 3), np.float32))
    assert all(m.int8_weight is None for m in model.modules() if isinstance(m, Linear))
    assert all(torch.equal(v, sd[k]) for k, v in model.state_dict().items())


def test_int8_scan_matches_the_jax_int8_scan(trained):
    jm, params, imgs, labels, DS = trained
    mesh = create_mesh()
    ref = {name: JaxPairwiseScorer(jm, params, mesh, num_outputs=1, pair_chunk=16,
                                   int8=int8).score_dataset(DS(imgs), batch_size=4,
                                                            num_workers=0)
           for name, int8 in (("f32", False), ("int8", True))}
    model = load_jax_params(ViTED(**KW), params)
    ours = {}
    for name, kw in (("f32", {}), ("int8", {"int8": True}),
                     ("int8_mixed", {"int8": True, "row_shared": False}),
                     ("int8_kv", {"int8": True, "use_kv_cache": True})):
        ours[name] = PairwiseScorer(model, num_outputs=1, pair_chunk=16,
                                    **kw).score_dataset(DS(imgs), batch_size=4,
                                                        num_workers=0)
    # the tolerance of tests/test_torch_pairs.py: f32 logits a few ulps
    # apart, then one float16 rounding
    for name in ours:
        np.testing.assert_allclose(ours[name].astype(np.float32),
                                   ref[name[:4]].astype(np.float32), atol=1e-3, rtol=0)
    m = {name: get_metrics(1 - s.astype(np.float32), labels)[0] for name, s in ours.items()}
    m_ref = get_metrics(1 - ref["int8"].astype(np.float32), labels)[0]
    assert m["f32"] > 0.5 and abs(m["int8"] - m_ref) < 1e-3
    assert abs(m["f32"] - m["int8"]) < 1e-3
    d = ours["f32"].astype(np.float32) - ours["int8"].astype(np.float32)
    assert 0 < np.max(np.abs(d)) < 0.25
    # score_dense (puzzle evaluation) takes the route too
    dense_ref = JaxPairwiseScorer(jm, params, mesh, num_outputs=1, pair_chunk=16,
                                  int8=True).score_dense(imgs[:6])
    dense = PairwiseScorer(model, num_outputs=1, pair_chunk=16,
                           int8=True).score_dense(imgs[:6])
    np.testing.assert_allclose(dense, dense_ref, atol=1e-4, rtol=0)
