"""wi19 metrics from row slabs (``vit_ed_tpu/metrics/wi19_sharded.py``).

Every statistic of ``wi19.get_metrics`` is a per-query (per-row) quantity
followed by a mean over rows, so a slab of complete rows reduces to a few
partial sums and any set of slabs merges exactly:

    part = row_partials(D_rows, labels, row_labels=labels[lo:hi])
    m_ap, top1, pr10, pr100 = merge_partials([part_0, ..., part_k])

Semantics are ``wi19.get_metrics``', upstream quirks included: mAP skips
singleton queries (all singletons give NaN), Pr@k is NaN as soon as one
query is a singleton (0/0 propagates, wi19_evaluate.py:7-9), and the self
column is removed per row by the argsort (the zero self-distance sorts
first).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from vit_ed_tpu_torch.metrics.wi19 import get_precision_recall_matrices


def row_partials(distance_rows: np.ndarray, labels: np.ndarray,
                 row_labels: Optional[np.ndarray] = None,
                 remove_self_column: bool = True) -> dict:
    """Partial sums of the wi19 metrics over ``distance_rows`` [R, N], R
    complete query rows; ``labels`` [N] label every column, ``row_labels``
    [R] the rows (default ``labels``: the slab is the whole matrix)."""
    labels = np.asarray(labels)
    row_labels = labels if row_labels is None else np.asarray(row_labels)
    correct = labels[None, :] == row_labels[:, None]
    precision_at, _recall, sorted_retrievals = get_precision_recall_matrices(
        distance_rows, None, remove_self_column, correct_retrievals=correct)

    relevant = sorted_retrievals.sum(axis=1)
    non_singleton = relevant > 0
    ap = np.zeros(len(sorted_retrievals))
    ap[non_singleton] = ((precision_at * sorted_retrievals).sum(axis=1)[non_singleton]
                         / relevant[non_singleton])

    def prk_sum(k):
        with np.errstate(divide="ignore", invalid="ignore"):
            pr = sorted_retrievals[:, :k].sum(axis=1) / np.minimum(relevant, k)
        return float(pr.sum())   # NaN propagates, as upstream

    return {
        "ap_sum": float(ap[non_singleton].sum()),
        "n_non_singleton": int(non_singleton.sum()),
        "top1_sum": float(sorted_retrievals[:, 0].sum()),
        "n_rows": int(len(sorted_retrievals)),
        "pr10_sum": prk_sum(10),
        "pr100_sum": prk_sum(100),
    }


def merge_partials(partials) -> tuple:
    """(mAP, top-1, Pr@10, Pr@100) of the rows behind ``partials``, equal to
    ``wi19.get_metrics`` on the matrix they cover."""
    tot = {k: sum(p[k] for p in partials) for k in partials[0]}
    # all-singleton queries: get_metrics' mAP is the mean of an empty array
    m_ap = (float("nan") if tot["n_non_singleton"] == 0
            else tot["ap_sum"] / tot["n_non_singleton"])
    rows = max(tot["n_rows"], 1)
    return m_ap, tot["top1_sum"] / rows, tot["pr10_sum"] / rows, tot["pr100_sum"] / rows
