"""Small host-side helpers (the port's copy of the eval-path pieces of
vit_ed_tpu/utils/misc.py)."""

from __future__ import annotations

from typing import Callable, List, Sequence


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
