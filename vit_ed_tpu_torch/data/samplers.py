"""Index samplers: the port's copies of ``DistributedRepeatSampler``,
``DistributedEvalSampler``, ``balanced_row_ranges``,
``DistributedIndicatesSampler`` and ``MPerClassSampler``
(``vit_ed_tpu/data/samplers.py``; numpy only, so one seed yields the same
index stream in both packages). The trainers give the distributed samplers
``num_replicas`` = the process count and ``rank`` = this process's."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np


class _EpochSampler:
    """``repeat`` passes over the dataset's indices per epoch, each pass
    shuffled by ``seed + epoch`` (so every pass of one epoch has the same
    order, as in the JAX package) and cut to this replica's share."""

    def __init__(self, dataset_len: int, num_replicas: int, rank: int,
                 shuffle: bool, seed: int, repeat: int):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.repeat = repeat
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _share(self, indices: List[int]) -> List[int]:
        raise NotImplementedError()

    def __iter__(self):
        all_indices: List[int] = []
        for _ in range(self.repeat):
            if self.shuffle:
                g = np.random.default_rng(self.seed + self.epoch)
                indices = g.permutation(self.dataset_len).tolist()
            else:
                indices = list(range(self.dataset_len))
            all_indices += self._share(indices)
        return iter(all_indices)

    def __len__(self):
        return self.num_samples * self.repeat


class DistributedRepeatSampler(_EpochSampler):
    """Shuffled, padded (or, with ``drop_last``, cut) strided shard."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0, drop_last: bool = False,
                 repeat: int = 1):
        super().__init__(dataset_len, num_replicas, rank, shuffle, seed, repeat)
        self.drop_last = drop_last
        if drop_last and dataset_len % num_replicas != 0:
            self.num_samples = math.ceil((dataset_len - num_replicas) / num_replicas)
        else:
            self.num_samples = math.ceil(dataset_len / num_replicas)
        self.total_size = self.num_samples * num_replicas

    def _share(self, indices):
        if not self.drop_last:
            padding = self.total_size - len(indices)
            if padding <= len(indices):
                indices += indices[:padding]
            else:
                indices += (indices * math.ceil(padding / len(indices)))[:padding]
        else:
            indices = indices[:self.total_size]
        return indices[self.rank:self.total_size:self.num_replicas]


class DistributedEvalSampler(_EpochSampler):
    """Exact strided shard, NO padding."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = False, seed: int = 0, repeat: int = 1):
        super().__init__(dataset_len, num_replicas, rank, shuffle, seed, repeat)
        self.num_samples = len(range(rank, dataset_len, num_replicas))

    def _share(self, indices):
        return indices[self.rank:self.dataset_len:self.num_replicas]


def balanced_row_ranges(row_of_pair: np.ndarray, num_replicas: int
                        ) -> List[range]:
    """Contiguous x1-row ranges of a triangular pair list, one per replica,
    with near-equal pair counts: the sorted pair list is cut into
    ``num_replicas`` chunks of ``ceil(pairs / replicas)`` and each cut is
    snapped to a row boundary, so that every replica owns whole rows."""
    n_pairs = len(row_of_pair)
    per = math.ceil(n_pairs / num_replicas)
    cuts = [0]
    for r in range(1, num_replicas):
        idx = min(r * per, n_pairs - 1)
        row = int(row_of_pair[idx])
        # snap to the first pair of this row
        if idx > 0 and row_of_pair[idx - 1] == row:
            cuts.append(row + 1 if row + 1 > cuts[-1] else cuts[-1])
        else:
            cuts.append(max(row, cuts[-1]))
    cuts.append(int(row_of_pair[-1]) + 1)
    return [range(cuts[i], cuts[i + 1]) for i in range(num_replicas)]


class DistributedIndicatesSampler:
    """The rows (sample indices) of ``balanced_row_ranges`` that ``rank``
    owns: the x1 rows of its share of the O(N^2) scan."""

    def __init__(self, row_of_pair: np.ndarray, num_replicas: int, rank: int):
        ranges = balanced_row_ranges(np.asarray(row_of_pair), num_replicas)
        self.samples = list(ranges[rank])
        self.num_samples = len(self.samples)

    def __iter__(self):
        return iter(self.samples)

    def __len__(self):
        return self.num_samples


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
