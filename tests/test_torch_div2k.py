"""The port's DIV2K data path (dataset, samplers, pair transform, dataset
factory) against the JAX package's on the same seeds, and the port's numpy
classification metrics against ``sklearn.metrics``, which the JAX entry
imports. Everything here is host-side numpy / PIL: equality is exact.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import random
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from vit_ed_tpu.data import samplers as jsamplers
from vit_ed_tpu.data import transforms as jtransforms
from vit_ed_tpu.data.build import build_dataset as jax_build_dataset
from vit_ed_tpu.data.div2k import DIV2KPatch as JaxDIV2KPatch
from vit_ed_tpu.data.div2k import Split as JaxSplit
from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data import samplers, transforms
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.div2k import DIV2KPatch, Split
from vit_ed_tpu_torch.metrics import classification as M

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory):
    """Seeded PNGs, some smaller than the 128 x 192 crop region."""
    root = tmp_path_factory.mktemp("div2k")
    rng = np.random.default_rng(0)
    for sub, n in (("DIV2K_train_HR", 4), ("DIV2K_valid_HR", 3)):
        (root / sub).mkdir()
        for i in range(n):
            h, w = (120, 150) if i == 1 else (200 + 8 * i, 230)
            # smooth-ish content so that the warps interpolate real gradients
            img = rng.integers(0, 256, size=(h // 4, w // 4, 3), dtype=np.uint8)
            Image.fromarray(img).resize((w, h), Image.BICUBIC).save(
                root / sub / f"{i:04d}.png")
    return str(root)


@pytest.mark.parametrize("mode", ["train", "validation"])
def test_div2k_items_equal_the_jax_package(div2k_root, mode):
    """Same ``random`` seed, same item: the stacked pair and the 4-bin label,
    over enough seeds to reach the flips, the warp, the RGB shift, the
    negatives and the label swaps."""
    kw = dict(image_size=64, erosion_ratio=0.07, with_negative=True)
    ref_ds = JaxDIV2KPatch(div2k_root, JaxSplit.from_string(mode),
                           transform=jtransforms.TwoImgSyncEval(64), **kw)
    ds = DIV2KPatch(div2k_root, Split.from_string(mode),
                    transform=transforms.TwoImgSyncEval(64), **kw)
    assert len(ds) == len(ref_ds) == (4 if mode == "train" else 3)
    assert ds.dataset == ref_ds.dataset
    labels = set()
    for seed in range(12):
        index = seed % len(ds)
        random.seed(seed)
        ref_pair, ref_label = ref_ds[index]
        state = random.getstate()
        random.seed(seed)
        pair, label = ds[index]
        assert random.getstate() == state          # the same number of draws
        assert pair.shape == (2, 64, 64, 3) and pair.dtype == np.float32
        np.testing.assert_array_equal(pair, ref_pair)
        np.testing.assert_array_equal(label, ref_label)
        labels.add(tuple(label))
    assert len(labels) >= 4                        # several bins and a negative


@pytest.mark.parametrize("name,kw", [
    ("DistributedRepeatSampler", dict(dataset_len=11, shuffle=True, seed=3, repeat=5)),
    ("DistributedRepeatSampler", dict(dataset_len=11, num_replicas=4, rank=1,
                                      shuffle=True, seed=1, repeat=2)),
    ("DistributedRepeatSampler", dict(dataset_len=11, num_replicas=4, rank=3,
                                      shuffle=False, drop_last=True, repeat=1)),
    ("DistributedRepeatSampler", dict(dataset_len=2, num_replicas=8, rank=5,
                                      shuffle=True, repeat=1)),
    ("DistributedEvalSampler", dict(dataset_len=7, repeat=10)),
    ("DistributedEvalSampler", dict(dataset_len=7, num_replicas=3, rank=2,
                                    shuffle=True, seed=5, repeat=2)),
])
def test_sampler_orders_equal_the_jax_package(name, kw):
    ref, got = getattr(jsamplers, name)(**kw), getattr(samplers, name)(**kw)
    assert len(got) == len(ref)
    for epoch in (0, 1):
        ref.set_epoch(epoch)
        got.set_epoch(epoch)
        order = list(got)
        assert order == list(ref) and len(order) == len(got)


def test_two_img_sync_eval_equals_the_jax_package():
    rng = np.random.default_rng(2)
    first = Image.fromarray(rng.integers(0, 256, (60, 60, 3), dtype=np.uint8))
    second = Image.fromarray(rng.integers(0, 256, (57, 90, 3), dtype=np.uint8))
    ref = jtransforms.TwoImgSyncEval(64)(first, second)
    got = transforms.TwoImgSyncEval(64)(first, second)
    for g, r, shape in zip(got, ref, ((64, 64, 3), (64, 101, 3))):
        assert g.shape == shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, r)
    # already at size: no resize, only the normalisation
    same = Image.fromarray(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    np.testing.assert_array_equal(
        transforms.TwoImgSyncEval(64)(same, same)[0],
        (np.asarray(same, np.float32) / 255.0 - 0.5) / 0.5)


def test_build_dataset_repeat_factors(div2k_root):
    args = types.SimpleNamespace(
        cfg=str(ROOT / "configs" / "puzzle" / "div2k_erosion7_4bin_patch8_64.yaml"), opts=None,
        data_path=div2k_root)
    config = get_config(args)
    assert config.DATA.DATASET == "div2k" and config.DATA.IMG_SIZE == 64
    tf = {"train": None, "validation": None}
    for mode, repeat, n in (("train", 5, 4), ("validation", 10, 3)):
        dataset, got = build_dataset(mode, config, tf)
        ref_dataset, ref = jax_build_dataset(mode, config, tf)
        assert got == ref == repeat and len(dataset) == len(ref_dataset) == n
        assert isinstance(dataset, DIV2KPatch) and dataset.with_negative
        assert dataset.image_size == 64 and dataset.erosion_ratio == 0.07
    config.defrost()
    config.DATA.DATASET = "pajigsaw"
    with pytest.raises(NotImplementedError, match="not ported yet"):
        build_dataset("train", config, tf)


def test_classification_metrics_equal_sklearn():
    sk = pytest.importorskip("sklearn.metrics")
    rng = np.random.default_rng(0)
    gt = (rng.random((40, 4)) < 0.3).astype(np.float32)
    pred = (rng.random((40, 4)) < 0.4).astype(np.float32)
    gt[:, 2] = 0.0                     # a bin with no positive in the batch
    pred[:, 3] = 0.0                   # a bin that is never predicted
    gt[:, 1] = pred[:, 1] = 0.0        # one class only, all correct
    for c in range(4):
        y, p = gt[:, c], pred[:, c]
        assert M.accuracy_score(y, p) == pytest.approx(sk.accuracy_score(y, p), abs=1e-12)
        assert M.f1_score(y, p) == pytest.approx(
            sk.f1_score(y, p, average="macro", zero_division=0), abs=1e-12)
        assert M.precision_score(y, p) == pytest.approx(
            sk.precision_score(y, p, average="macro", zero_division=0), abs=1e-12)
        assert M.recall_score(y, p) == pytest.approx(
            sk.recall_score(y, p, average="macro", zero_division=0), abs=1e-12)


def test_classification_metrics_by_hand():
    y = np.asarray([1, 1, 0, 0, 0], np.float32)
    p = np.asarray([1, 0, 0, 0, 1], np.float32)
    # class 0: tp 2, predicted 3, true 3; class 1: tp 1, predicted 2, true 2
    assert M.accuracy_score(y, p) == pytest.approx(0.6)
    assert M.precision_score(y, p) == pytest.approx((2 / 3 + 1 / 2) / 2)
    assert M.recall_score(y, p) == pytest.approx((2 / 3 + 1 / 2) / 2)
    assert M.f1_score(y, p) == pytest.approx((4 / 6 + 2 / 4) / 2)
    zeros = np.zeros(4, np.float32)
    assert M.f1_score(zeros, zeros) == 1.0                 # one class, all right
    ones = np.ones(4, np.float32)
    assert M.precision_score(zeros, ones) == 0.0           # nothing right
    assert M.recall_score(zeros, ones) == 0.0
