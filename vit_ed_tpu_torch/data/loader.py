"""Lightweight prefetching data loader (the port's copy of
``vit_ed_tpu/data/loader.py`` without its native whole-batch branch).

A thread pool maps ``dataset[i]`` over the sampler's indices with a bounded
prefetch window, and batches are collated into stacked numpy arrays.
Threads suit this workload: PIL and numpy release the GIL in the heavy
operations.
"""

from __future__ import annotations

import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, Iterator, Optional

import numpy as np


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


class DataLoader:
    def __init__(self, dataset, sampler: Optional[Iterable[int]] = None,
                 batch_size: int = 1, num_workers: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.num_workers = max(int(num_workers), 0)
        self.drop_last = drop_last
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

    def __iter__(self):
        if self.num_workers == 0:
            for batch_idx in self._batched_indices():
                yield default_collate([self.dataset[i] for i in batch_idx])
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            batches = self._batched_indices()
            window = []

            def submit(batch_idx):
                return [pool.submit(self.dataset.__getitem__, i)
                        for i in batch_idx]

            for batch_idx in itertools.islice(batches, PREFETCH_BATCHES):
                window.append(submit(batch_idx))
            while window:
                futures = window.pop(0)
                nxt = next(batches, None)
                if nxt is not None:
                    window.append(submit(nxt))
                yield default_collate([f.result() for f in futures])
