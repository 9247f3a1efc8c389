"""The ViT embedding baselines' building blocks in the port against the JAX
package, on the CPU: the plain ViT (``models/vit.py``) on params converted
by ``jax_params_to_state_dict`` (``strict=True``) at head_dim 32, 64 on the
4-D route and 64 on the pair route, float32 at 1e-5, uint8 input, bf16 at
the model tests' 5e-2 (tests/test_torch_model.py: the rounding points of
models/layers.py); the step-0 gradients of the main_vit triplet loss
against ``jax.grad`` (relative 1e-5); the three triplet losses and their
gradients (1e-6) with anchors that lack a positive or a negative and with
exact ties; ``Div2kPatchTriplet`` and ``PiecesDatasetTriplet`` items bit for
bit and the ``div2k_triplet`` factory; the loader on items of several
images; ``vit_step_flops`` against ``FlopCounterMode``; the model factory;
and the kernels' grid guard. The JAX model is the one its factory builds
(``use_pallas=None``: at these lengths its reference attention, as on a
TPU below 256 keys).
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import random
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils.flop_counter import FlopCounterMode

from vit_ed_tpu.data import transforms as jtransforms
from vit_ed_tpu.data.build import build_dataset as jax_build_dataset
from vit_ed_tpu.data.div2k import Div2kPatchTriplet as JaxDiv2kPatchTriplet
from vit_ed_tpu.data.div2k import Split as JaxSplit
from vit_ed_tpu.data.pieces import PiecesDatasetTriplet as JaxPiecesDatasetTriplet
from vit_ed_tpu.models.vit import ViT as JaxViT
from vit_ed_tpu.solver.importer import Puzzle as JaxPuzzle
from vit_ed_tpu.train import losses as jlosses
from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data import transforms
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.div2k import Div2kPatchTriplet, Split
from vit_ed_tpu_torch.data.loader import DataLoader, pools_batches
from vit_ed_tpu_torch.data.pieces import PiecesDatasetTriplet
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.models.convert import jax_params_to_state_dict, load_jax_params
from vit_ed_tpu_torch.models.vit import ViT
from vit_ed_tpu_torch.ops import attention as A
from vit_ed_tpu_torch.solver.importer import Puzzle
from vit_ed_tpu_torch.train import losses
from vit_ed_tpu_torch.utils.flops import vit_step_flops

ROOT = Path(__file__).resolve().parent.parent
VIT_CFG = str(ROOT / "configs" / "puzzle" / "vit_div2k_erosion7_4bin_patch8_64.yaml")
BF16_TOL = 5e-2
# (embed, heads): head_dim 32 and 64 on the 4-D route, 64 on the pair route
GEOMETRIES = [(64, 2), (64, 1), (128, 2)]


def _kw(embed, heads):
    return dict(img_size=32, patch_size=8, num_classes=24, embed_dim=embed,
                depth=2, num_heads=heads)


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: f"C{g[0]}H{g[1]}")
def vit(request):
    kw = _kw(*request.param)
    params = jax.jit(JaxViT(**kw).init)(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    return kw, params, load_jax_params(ViT(**kw), params).eval()


def _jax_embed(kw, params, x, dtype=jnp.float32):
    model = JaxViT(**kw, dtype=dtype)
    return np.asarray(jax.jit(lambda p, a: model.apply({"params": p}, a))(
        params, jnp.asarray(x)).astype(jnp.float32))


def test_vit_forward_matches_jax(vit):
    kw, params, model = vit
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 32, 32, 3)).astype(np.float32)
    x_u8 = rng.integers(0, 256, size=(5, 32, 32, 3), dtype=np.uint8)
    assert set(model.state_dict()) == set(jax_params_to_state_dict(params))
    with torch.no_grad():
        for inp in (x, x_u8):
            ref = _jax_embed(kw, params, inp)
            out = model(torch.from_numpy(inp)).numpy()
            assert out.shape == ref.shape == (5, 24)
            np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)
        ref16 = _jax_embed(kw, params, x, jnp.bfloat16)
        model.dtype = torch.bfloat16
        try:
            out16 = model(torch.from_numpy(x))
        finally:
            model.dtype = torch.float32
    assert out16.dtype == torch.bfloat16
    assert np.abs(out16.float().numpy() - ref16).max() <= BF16_TOL


def test_triplet_step0_gradients_match_jax_grad(vit):
    """main_vit's loss (one forward of B x 4 x 3 images, f32 embeddings,
    margin 0.2) through the ViT: the loss and every parameter's gradient
    against ``jax.grad`` of the JAX entry's loss."""
    from main_vit import VitTripletTrainer as JaxVitTripletTrainer

    from vit_ed_tpu_torch.main_vit import triplet_loss

    kw, params, model = vit
    x = np.random.default_rng(1).normal(size=(2, 4, 3, 32, 32, 3)).astype(np.float32)
    jax_loss = JaxVitTripletTrainer.make_loss_fn(None, None)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p, s: jax_loss(JaxViT(**kw), p, {"samples": s}, jax.random.PRNGKey(0))))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ref = jax_params_to_state_dict(jax.tree.map(np.asarray, ref))
    model.train()
    model.zero_grad(set_to_none=True)
    try:
        loss = triplet_loss(model, torch.from_numpy(x))
        loss.backward()
    finally:
        model.eval()
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 and loss.item() > 0
    for name, p in model.named_parameters():
        g, r = p.grad.numpy(), ref[name].numpy()
        assert np.abs(g - r).max() <= 1e-5 * max(np.abs(r).max(), 1e-12), name


def _loss_cases():
    """Seeded embeddings with exact ties: rows 6 and 7 are equal (a tied
    hardest positive for anchor 5), rows 0 and 1 are equal (a tied hardest
    negative for the anchors of label 3), label 2 has no positive; a
    second batch whose labels are all equal has no negative."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(8, 16)).astype(np.float32)
    emb[7] = emb[6]
    emb[1] = emb[0]
    emb[5] = emb[6] + 0.05 * rng.normal(size=16).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 2, 3, 3, 3], np.int32)
    return [(emb, labels), (emb[:4], np.zeros(4, np.int32))]


@pytest.mark.parametrize("case", [0, 1], ids=["mixed", "no_negative"])
@pytest.mark.parametrize("margin", [0.2, 0.5])
def test_batch_wise_triplet_loss_matches_jax(case, margin):
    emb, labels = _loss_cases()[case]
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda e, y: jlosses.batch_wise_triplet_loss(e, y, margin)))(
        jnp.asarray(emb), jnp.asarray(labels))
    e = torch.from_numpy(emb).requires_grad_()
    loss = losses.batch_wise_triplet_loss(e, torch.from_numpy(labels), margin)
    loss.backward()
    assert abs(loss.item() - float(ref)) <= 1e-6
    assert torch.isfinite(e.grad).all()
    np.testing.assert_allclose(e.grad.numpy(), np.asarray(ref_g), atol=1e-6, rtol=0)
    if case == 1:
        assert loss.item() == 0.0 and not e.grad.any()


def test_triplet_cosine_loss_and_distance_match_jax():
    """Random triplets, and triplets whose positive equals the negative at
    margin 0 (the hinge exactly at 0: JAX and the port split its gradient
    in halves), loss and gradients of all three inputs; the distance alone,
    broadcast."""
    rng = np.random.default_rng(4)
    a, p, n = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(3))
    for margin, neg in ((0.2, n), (0.0, p.copy())):
        ref, ref_g = jax.jit(jax.value_and_grad(
            lambda *t: jlosses.triplet_cosine_loss(*t, margin=margin),
            argnums=(0, 1, 2)))(jnp.asarray(a), jnp.asarray(p), jnp.asarray(neg))
        ts = [torch.from_numpy(t).requires_grad_() for t in (a, p, neg)]
        loss = losses.triplet_cosine_loss(*ts, margin=margin)
        loss.backward()
        assert abs(loss.item() - float(ref)) <= 1e-6
        for t, r in zip(ts, ref_g):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-6, rtol=0)
    d = losses.cosine_distance(torch.from_numpy(a)[:, None], torch.from_numpy(p)[None])
    ref_d = jlosses.cosine_distance(jnp.asarray(a)[:, None], jnp.asarray(p)[None])
    assert tuple(d.shape) == (6, 6)
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory):
    """Seeded PNGs, one smaller than the 128 x 192 crop region."""
    root = tmp_path_factory.mktemp("div2k_triplet")
    rng = np.random.default_rng(0)
    for sub, n in (("DIV2K_train_HR", 3), ("DIV2K_valid_HR", 2)):
        (root / sub).mkdir()
        for i in range(n):
            h, w = (120, 150) if i == 1 else (200 + 8 * i, 230)
            img = rng.integers(0, 256, size=(h // 4, w // 4, 3), dtype=np.uint8)
            Image.fromarray(img).resize((w, h), Image.BICUBIC).save(
                root / sub / f"{i:04d}.png")
    return str(root)


@pytest.mark.parametrize("mode", ["train", "validation"])
def test_div2k_triplet_items_equal_the_jax_package(div2k_root, mode):
    """Same ``random`` seed, same item, bit for bit, the same number of
    draws; over seeds that reach the flips, the warp and the RGB shift."""
    kw = dict(image_size=64, erosion_ratio=0.07, with_negative=True)
    ref_ds = JaxDiv2kPatchTriplet(div2k_root, JaxSplit.from_string(mode),
                                  transform=jtransforms.TwoImgSyncEval(64), **kw)
    ds = Div2kPatchTriplet(div2k_root, Split.from_string(mode),
                           transform=transforms.TwoImgSyncEval(64), **kw)
    assert ds.dataset == ref_ds.dataset and len(ds) == (3 if mode == "train" else 2)
    for seed in range(6):
        index = seed % len(ds)
        random.seed(seed)
        ref, ref_idx = ref_ds[index]
        state = random.getstate()
        random.seed(seed)
        item, idx = ds[index]
        assert random.getstate() == state
        assert item.shape == (4, 3, 64, 64, 3) and item.dtype == np.float32
        np.testing.assert_array_equal(item, ref)
        assert idx.dtype == ref_idx.dtype == np.int32 and int(idx) == index


def _puzzle(tmp_path, ext="png"):
    path = str(tmp_path / f"p.{ext}")
    small = np.random.default_rng(7).integers(0, 256, (5, 5, 3), dtype=np.uint8)
    img = Image.fromarray(small).resize((96, 98), Image.BICUBIC)
    img.save(path, **({"quality": 92} if ext == "jpg" else {}))
    return path


@pytest.mark.parametrize("ext", ["png", "jpg"])
def test_pieces_dataset_triplet_items_equal_the_jax_package(tmp_path, ext):
    path = _puzzle(tmp_path, ext)
    ref_pieces = JaxPuzzle(0, path, 32, starting_piece_id=0, erosion=0.07).pieces
    pieces = Puzzle(0, path, 32, starting_piece_id=0, erosion=0.07).pieces
    order = np.random.default_rng(0).permutation(len(pieces))
    ref_ds = JaxPiecesDatasetTriplet([ref_pieces[k] for k in order],
                                     transform=jtransforms.TwoImgSyncEval(32))
    ds = PiecesDatasetTriplet([pieces[k] for k in order],
                              transform=transforms.TwoImgSyncEval(32))
    assert ds.entries == ref_ds.entries and len(ds) == 72
    for index in range(0, len(ds), 5):
        ref, ref_idx = ref_ds[index]
        item, idx = ds[index]
        assert item.shape == (8, 32, 32, 3) and item.dtype == np.float32
        np.testing.assert_array_equal(item, ref)
        assert int(idx) == int(ref_idx) == index


def test_build_dataset_div2k_triplet(div2k_root):
    config = get_config(types.SimpleNamespace(cfg=VIT_CFG, opts=None, data_path=div2k_root))
    assert config.DATA.DATASET == "div2k_triplet" and config.MODEL.TYPE == "vit"
    tf = {"train": None, "validation": None}
    for mode, repeat, n in (("train", 5, 3), ("validation", 10, 2)):
        dataset, got = build_dataset(mode, config, tf)
        ref_dataset, ref = jax_build_dataset(mode, config, tf)
        assert got == ref == repeat and len(dataset) == len(ref_dataset) == n
        assert isinstance(dataset, Div2kPatchTriplet) and dataset.with_negative
        assert dataset.image_size == 64 and dataset.erosion_ratio == 0.07


def test_loader_batches_items_of_several_images(div2k_root, tmp_path):
    """Triplet items [4, 3, H, W, C] and pairing items [8, H, W, C] go the
    per-item path (the whole-batch pool refuses them) and stack to
    [B, ...] in sampler order, a short last batch included."""
    ds = Div2kPatchTriplet(div2k_root, Split.VAL, transform=transforms.TwoImgSyncEval(32),
                           image_size=32)
    pieces = Puzzle(0, _puzzle(tmp_path), 32, starting_piece_id=0, erosion=0.07).pieces
    pds = PiecesDatasetTriplet(pieces[:3], transform=transforms.TwoImgSyncEval(32))
    for dataset, shape in ((ds, (4, 3, 32, 32, 3)), (pds, (8, 32, 32, 3))):
        assert not pools_batches(dataset)
        for workers in (0, 2):
            batches = list(DataLoader(dataset, batch_size=4, num_workers=workers))
            images = np.concatenate([b[0] for b in batches])
            idx = np.concatenate([b[1] for b in batches])
            assert batches[0][0].shape == (min(4, len(dataset)),) + shape
            assert images.shape == (len(dataset),) + shape
            np.testing.assert_array_equal(idx, np.arange(len(dataset)))
            np.testing.assert_array_equal(images, np.stack([dataset[i][0] for i in idx]))


def test_vit_step_flops_equal_the_flop_counter():
    """The analytic count against ``FlopCounterMode`` on the plain CPU
    forward (equal), and on the backward once the product the plain
    attention backward recomputes (Q K^T, one per block) is added."""
    torch.manual_seed(0)
    depth, s, c, b = 3, 17, 64, 5
    model = ViT(**{**_kw(c, 2), "depth": depth}).train()
    x = torch.randn(b, 32, 32, 3)
    with FlopCounterMode(display=False) as fwd:
        emb = model(x)
    with FlopCounterMode(display=False) as bwd:
        emb.square().sum().backward()
    forward, backward = vit_step_flops(model, b)
    assert fwd.get_total_flops() == forward
    assert bwd.get_total_flops() == backward + b * depth * 2 * s * s * c
    assert all(p.grad is not None for p in model.parameters())


def test_build_model_types_and_unported_options():
    args = types.SimpleNamespace(cfg=VIT_CFG, opts=["MODEL.VIT.DEPTH", "1"])
    config = get_config(args)
    model = build_model(config)
    assert isinstance(model, ViT) and model.embed_dim == 384 and model.num_heads == 12
    assert model.patch_size == 8 and model.num_patches == 64
    assert model.head.weight.shape == (384, 384) and model.dtype == torch.bfloat16
    config.defrost()
    config.MODEL.TYPE = "unknown"
    with pytest.raises(NotImplementedError, match="Unknown model"):
        build_model(config)
    config.MODEL.TYPE = "vit"
    # int8 scoring is a switch of the scorer: the model is the same
    config.TPU.INT8_SCORE = True
    assert isinstance(build_model(config), ViT)
    config.TPU.INT8_SCORE = False
    config.MODEL.PJS.MOE.EXPERTS = 4
    with pytest.raises(NotImplementedError, match="MODEL.PJS.MOE.EXPERTS"):
        build_model(config)
    config.MODEL.PJS.MOE.EXPERTS = 0
    config.TPU.FAST_GELU = True
    assert build_model(config).blocks[0].mlp.act.__name__ == "gelu_tanh"
    config.TPU.FAST_GELU = False
    # MODEL.DROP_RATE feeds no layer of the ViT, as in the JAX ViT: training
    # with it is training without it
    config.MODEL.DROP_RATE = 0.1
    model = build_model(config)
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        assert model.eval()(x).shape == (1, 384)
        assert torch.equal(model.train()(x), model.eval()(x))
    # the dropouts no config key reaches still raise in training
    with pytest.raises(NotImplementedError, match="proj_drop_rate"):
        ViT(**_kw(64, 2), proj_drop_rate=0.1).train()(torch.zeros(1, 32, 32, 3))


def test_vit_training_forward_draws_drop_path_from_its_generator():
    """Stochastic depth from the model-owned generator: two runs from one
    seed agree, and differ from the eval embeddings; recomputation under
    ``use_checkpoint`` rewinds the generator (equal gradients)."""
    torch.manual_seed(0)
    x = torch.randn(6, 32, 32, 3)
    model = ViT(**{**_kw(64, 2), "depth": 3}, drop_path_rate=0.5)
    grads = []
    for ckpt in (False, True):
        model.use_checkpoint = ckpt
        model.train().seed_drop_path(5)
        model.zero_grad(set_to_none=True)
        out = model(x)
        out.square().sum().backward()
        grads.append([p.grad.clone() for p in model.parameters()])
        with torch.no_grad():
            model.seed_drop_path(5)
            again = model(x)
            ref = model.eval()(x)
        assert torch.equal(out, again) and not torch.allclose(out, ref, atol=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_grid_guard_raises_for_a_batch_over_the_limit():
    """CUDA's gridDim.z is 65,535: the wrappers refuse a larger batch before
    any launch (the batch is the 4-D kernels' and the pair kernel's z)."""
    q = torch.zeros(1, 1, 65, 32).expand(A._MAX_GRID + 1, -1, -1, -1)
    with pytest.raises(ValueError, match="65535"):
        A._check_heads_operands(q, (), 65)
    A._check_heads_operands(q[:A._MAX_GRID], (), 65)
    qkv = torch.zeros(1, 65, 3 * 64).expand(A._MAX_GRID + 1, -1, -1)
    with pytest.raises(ValueError, match="65535"):
        A._launch("qkv", qkv, qkv, qkv, (0, 64, 128), 64, 1, 65, 0.125)
