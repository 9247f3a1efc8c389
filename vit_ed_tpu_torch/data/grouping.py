"""Item-group union (the port's copy of ``vit_ed_tpu/data/grouping.py``).

A list of disjoint item groups; adding a list of items merges every group
it touches into one (used by the Michigan papyrus <-> folder grouping and
the Geshaem assembled-fragment groups).
"""

from __future__ import annotations

from typing import Iterable, List, Set


def add_items_to_group(items: Iterable, groups: List[Set]) -> None:
    """Merge ``items`` and every group of ``groups`` that shares an item
    with them into one group, appended last (``groups`` is mutated)."""
    items = set(items)
    touching = [g for g in groups if g & items]
    merged = set(items)
    for g in touching:
        merged |= g
        groups.remove(g)
    groups.append(merged)
