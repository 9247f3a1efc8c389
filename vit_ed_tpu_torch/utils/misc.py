"""Small host-side helpers (the port's copy of the pieces of
vit_ed_tpu/utils/misc.py that the scoring and training paths use)."""

from __future__ import annotations

import random
from typing import Callable, List, Sequence

import numpy as np
import torch


class AverageMeter:
    """Running average meter (reference misc/utils.py:276-303)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def set_seed(seed: int) -> None:
    """Seed the host RNGs the data path draws from (``np.random`` for pair
    mining, ``random`` for the augmentations) and torch's global one."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def list_to_idx(items: Sequence, name_converting_fn: Callable) -> List[int]:
    """Factorize item names into integer labels (misc/utils.py:347-352)."""
    labels = [name_converting_fn(x) for x in items]
    authors = list(set(labels))
    author_map = {x: i for i, x in enumerate(authors)}
    return [author_map[x] for x in labels]


def chunks(l: Sequence, n: int) -> List[Sequence]:
    """Yield n striped chunks from l (misc/utils.py:355-362)."""
    results = []
    for i in range(n):
        chunk = l[i::n]
        if len(chunk) > 0:
            results.append(chunk)
    return results
