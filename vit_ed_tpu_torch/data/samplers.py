"""Samplers of the training slice: the port's copy of ``MPerClassSampler``
(``vit_ed_tpu/data/samplers.py:140-191``; numpy only, so one seed yields
the same index stream in both packages)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class MPerClassSampler:
    """m samples per class per pass (pytorch_metric_learning semantics,
    reference data/samplers.py:260-308 / hisfrag.py:109)."""

    def __init__(self, labels: Sequence[int], m: int, batch_size: Optional[int] = None,
                 length_before_new_iter: int = 100000, seed: int = 0):
        labels = np.asarray(labels)
        self.m_per_class = int(m)
        self.batch_size = int(batch_size) if batch_size is not None else None
        self.labels_to_indices: Dict[int, np.ndarray] = {
            int(l): np.flatnonzero(labels == l) for l in np.unique(labels)
        }
        self.labels = list(self.labels_to_indices.keys())
        self.length_of_single_pass = self.m_per_class * len(self.labels)
        self.list_size = length_before_new_iter
        self.rng = np.random.default_rng(seed)
        if self.batch_size is None:
            if self.length_of_single_pass < self.list_size:
                self.list_size -= self.list_size % self.length_of_single_pass
        else:
            if self.list_size < self.batch_size:
                raise ValueError("length_before_new_iter must be >= batch_size")
            if self.length_of_single_pass < self.batch_size:
                raise ValueError(
                    "m * (number of unique labels) must be >= batch_size")
            if self.batch_size % self.m_per_class:
                raise ValueError(
                    "m_per_class must divide batch_size without any remainder")
            self.list_size -= self.list_size % self.batch_size

    def set_epoch(self, epoch: int):
        pass

    def __len__(self):
        return self.list_size

    def __iter__(self):
        idx_list = []
        total = 0
        while total < self.list_size:
            self.rng.shuffle(self.labels)
            if self.batch_size is None:
                curr = self.labels
            else:
                curr = self.labels[: self.batch_size // self.m_per_class]
            for label in curr:
                t = self.labels_to_indices[label]
                remaining = self.list_size - total
                if remaining == 0:
                    break
                size = min(self.m_per_class, len(t), remaining)
                items = self.rng.choice(t, size, replace=False)
                idx_list.append(items)
                total += size
        return iter(np.concatenate(idx_list).tolist())
