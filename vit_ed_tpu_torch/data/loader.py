"""Lightweight prefetching data loader (the port's copy of
``vit_ed_tpu/data/loader.py``).

A thread pool maps ``dataset[i]`` over the sampler's indices with a bounded
prefetch window, and batches are collated into stacked numpy arrays.
Threads suit this workload: PIL, numpy and the native pipeline release the
GIL in the heavy operations.

Whole-batch preparation: when the dataset exposes ``raw_image(i)`` (the
decoded u8 HWC image) and ``item_meta(i)`` (the item's other fields), and
its transform exposes ``pool_crop`` (the deterministic crop -> resize ->
normalize tail of an eval transform that emits normalized float32), the
threads only decode, and one ``PipelinePool.prep_batch`` call
(``native/pipeline.cc``) prepares the whole batch off the Python thread,
bit-exact against the per-item path. A batch the pool cannot express (an
image that needs padding, or ragged output sizes) goes through the
transform image by image, on the images already decoded.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.data.transforms import as_sample_array

PREFETCH_BATCHES = 2   # batches in flight ahead of the consumer


def default_collate(items):
    """Stack tuples of numpy-able leaves."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(default_collate([it[i] for it in items])
                     for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate([it[k] for it in items]) for k in first}
    return np.stack([np.asarray(it) for it in items])


def pools_batches(dataset) -> bool:
    """Whether ``dataset``'s items can be prepared by ``pool_batch``: the
    dataset serves ``raw_image`` / ``item_meta`` and its transform has a
    pooled form (``pool_crop``) and emits float32 (not ``emit_u8``)."""
    transform = getattr(dataset, "transform", None)
    return (hasattr(dataset, "raw_image") and hasattr(dataset, "item_meta")
            and hasattr(transform, "pool_crop")
            and not getattr(transform, "emit_u8", False))


def pool_batch(pool, transform, raws: Sequence[np.ndarray], map_fn=map) -> np.ndarray:
    """``transform`` of each decoded image in ``raws`` as one [n, h, w, c]
    float32 batch: from ``pool`` (a ``PipelinePool``) in one call, or,
    where the pool cannot express the batch (an image ``transform.pool_crop``
    rejects, or output sizes that differ), through ``transform`` image by
    image on ``raws`` (mapped with ``map_fn``, e.g. a thread pool's map), so
    that no image is decoded twice. ``transform.pool_post_crop``, where
    present, is a center crop after the pooled resize; it commutes with the
    pointwise normalize, so it is a slice of the pooled batch."""
    crops, size = [], None
    for a in raws:
        pc = transform.pool_crop(a.shape[:2])
        if pc is None or (size is not None and pc[1] != size):
            return np.stack(list(map_fn(
                lambda a: as_sample_array(transform(Image.fromarray(a))), raws)))
        crops.append(pc[0])
        size = pc[1]
    images = pool.prep_batch(raws, size, crops)
    post_crop = getattr(transform, "pool_post_crop", None)
    if post_crop is not None:
        y0, x0, hh, ww = post_crop(size)
        images = np.ascontiguousarray(images[:, y0:y0 + hh, x0:x0 + ww])
    return images


class DataLoader:
    def __init__(self, dataset, sampler: Optional[Iterable[int]] = None,
                 batch_size: int = 1, num_workers: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(int(num_workers), 0)
        self.drop_last = drop_last
        self._pool = None     # the PipelinePool, kept across epochs
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _indices(self) -> Iterator[int]:
        if self.sampler is not None:
            return iter(self.sampler)
        return iter(range(len(self.dataset)))

    def __len__(self) -> int:
        n = len(self.sampler) if self.sampler is not None else len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _batched_indices(self):
        it = self._indices()
        while True:
            batch = list(itertools.islice(it, self.batch_size))
            if not batch:
                return
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield batch

    def _native_pool(self):
        """The loader's PipelinePool where batches are prepared whole, else
        None."""
        if self.num_workers == 0 or not pools_batches(self.dataset):
            return None
        if self._pool is None:
            from vit_ed_tpu_torch.native.pipeline import PipelinePool

            self._pool = PipelinePool(self.num_workers)
        return self._pool

    def __iter__(self):
        if self.num_workers == 0:
            for batch_idx in self._batched_indices():
                yield default_collate([self.dataset[i] for i in batch_idx])
            return
        ds = self.dataset
        native = self._native_pool()
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def submit(batch_idx):
                # the threads decode (raw_image) or make whole items
                fetch = ds.raw_image if native is not None else ds.__getitem__
                return [pool.submit(fetch, i) for i in batch_idx]

            def finish(batch_idx, futures):
                if native is None:
                    return default_collate([f.result() for f in futures])
                # one pool call for the whole batch, on the consumer's turn
                # (the pool is never entered from two threads)
                images = pool_batch(native, ds.transform,
                                    [f.result() for f in futures], pool.map)
                metas = [ds.item_meta(i) for i in batch_idx]
                return (images,) + tuple(default_collate(metas))

            batches = self._batched_indices()
            window = [(b, submit(b)) for b in itertools.islice(batches, PREFETCH_BATCHES)]
            while window:
                batch_idx, futures = window.pop(0)
                nxt = next(batches, None)
                if nxt is not None:
                    window.append((nxt, submit(nxt)))
                yield finish(batch_idx, futures)
