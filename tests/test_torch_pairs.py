"""The port's single-process O(N^2) scan (vit_ed_tpu_torch/parallel/pairs.py)
against the JAX PairwiseScorer on the same weights, plus the schedule
contracts of tests/test_pairs.py: token cache == streaming, and a resumed
scan equals a fresh one and skips the blocks it finished."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_ed_tpu.models.vit_ed import ViTED as JaxViTED
from vit_ed_tpu.parallel.mesh import create_mesh
from vit_ed_tpu.parallel.pairs import PairwiseScorer as JaxPairwiseScorer
from vit_ed_tpu_torch.models.convert import load_jax_params
from vit_ed_tpu_torch.models.vit_ed import ViTED
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

KW = dict(img_size=32, patch_size=16, num_classes=1, embed_dim=128,
          depth=1, c_depth=2, num_heads=2)
N = 10


class ArrayDataset:
    def __init__(self, imgs):
        self.imgs = imgs
        self.loads = 0

    def __getitem__(self, i):
        self.loads += 1
        return self.imgs[i], i

    def __len__(self):
        return len(self.imgs)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    imgs = rng.normal(size=(N, 32, 32, 3)).astype(np.float32)
    jm = JaxViTED(**KW, use_pallas=False)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0),
                              jnp.zeros((1, 2, 32, 32, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = load_jax_params(ViTED(**KW), params)
    return jm, params, model, imgs


def test_scan_matches_jax_scorer(setup, tmp_path):
    jm, params, model, imgs = setup
    ref = JaxPairwiseScorer(jm, params, create_mesh(), num_outputs=1,
                            pair_chunk=16).score_dataset(
        ArrayDataset(imgs), batch_size=4, num_workers=0)
    scorer = PairwiseScorer(model, num_outputs=1, pair_chunk=16)
    sim = scorer.score_dataset(ArrayDataset(imgs), batch_size=4, num_workers=0)
    assert sim.shape == (N, N) and sim.dtype == np.float16
    np.testing.assert_array_equal(sim, sim.T)
    assert scorer.pairs_done == N * (N + 1) // 2
    # f32 logits agree to ~1e-6; the float16 matrix can still round one
    # ulp (2^-11 at |x| < 1) apart
    np.testing.assert_allclose(sim.astype(np.float32), ref.astype(np.float32),
                               atol=1e-3, rtol=0)


def test_token_cache_matches_streaming(setup):
    _jm, _params, model, imgs = setup
    scorer = PairwiseScorer(model, num_outputs=1, pair_chunk=16)
    ds = ArrayDataset(imgs)
    stream = scorer.score_dataset(ds, batch_size=4, num_workers=0,
                                  token_cache=False)
    cache = scorer.score_dataset(ds, batch_size=4, num_workers=2,
                                 token_cache=True)
    np.testing.assert_array_equal(stream, cache)
    # auto mode takes the cache at this size
    np.testing.assert_array_equal(
        scorer.score_dataset(ds, batch_size=4, num_workers=0), stream)


def test_resume_skips_finished_blocks(setup, tmp_path):
    _jm, _params, model, imgs = setup
    scorer = PairwiseScorer(model, num_outputs=1, pair_chunk=16)
    fresh = scorer.score_dataset(ArrayDataset(imgs), batch_size=4,
                                 out_dir=str(tmp_path), tag="t", num_workers=0)
    blocks = sorted(glob.glob(os.path.join(str(tmp_path), "t_rank0_rows*.npz")))
    assert len(blocks) == 3

    # every block finished: nothing is loaded, built or scored
    ds = ArrayDataset(imgs)
    again = scorer.score_dataset(ds, batch_size=4, out_dir=str(tmp_path),
                                 tag="t", num_workers=0)
    np.testing.assert_array_equal(again, fresh)
    assert scorer.pairs_done == 0 and ds.loads == 0

    # one block lost: only its rows are scored again
    os.unlink(os.path.join(str(tmp_path), "t_rank0_rows4.npz"))
    partial = scorer.score_dataset(ArrayDataset(imgs), batch_size=4,
                                   out_dir=str(tmp_path), tag="t",
                                   num_workers=0)
    np.testing.assert_array_equal(partial, fresh)
    assert scorer.pairs_done == sum(N - i for i in range(4, 8))

    # a stale block (other dataset size) is rescored, not trusted
    np.savez_compressed(os.path.join(str(tmp_path), "t_rank0_rows0.npz"),
                        scores=np.zeros((4, N + 1, 1), np.float16))
    stale = scorer.score_dataset(ArrayDataset(imgs), batch_size=4,
                                 out_dir=str(tmp_path), tag="t", num_workers=0)
    np.testing.assert_array_equal(stale, fresh)


@pytest.mark.parametrize("kwargs", [{"world_size": 2},
                                    {"world_size": 2, "slab_on_disk": True,
                                     "assemble": False, "out_dir": "unused"},
                                    {"world_size": 2, "assemble": False}])
def test_unported_options_raise(setup, kwargs):
    """``world_size`` 2 needs two processes in a group (they score their row
    ranges and merge, tests/test_torch_multiprocess.py): called from one
    process it raises before it scores anything, with or without the
    sharded test path's options and int8 scoring."""
    _jm, _params, model, imgs = setup
    scorer = PairwiseScorer(model, int8=True)
    with pytest.raises(ValueError, match="process group"):
        scorer.score_dataset(ArrayDataset(imgs), batch_size=4, **kwargs)
