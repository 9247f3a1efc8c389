"""mAP and Pr@k with group ground truth (the port's copy of
``vit_ed_tpu/metrics/map_prak.py``, the Geshaem evaluation's metric).

Per query q (its own column ranks first at distance 0 and is dropped):

- AP   = mean over the positive hits of (positives so far) / rank;
- Pr@k = (positives in the top k of the ranking) / min(positives, k).

An item is a positive of q when its label is in ``positive_pairs[label of
q]``. With ``negative_pairs``, items in neither set are dropped from q's
ranking before scoring. Queries whose ranking holds no positive are
skipped; where every query is, the function raises ``ValueError``. NaN
distances sort last (``np.argsort``).
"""

from __future__ import annotations

import numpy as np


def _membership_row(labels, group) -> np.ndarray:
    """Boolean mask over ``labels`` of the items whose label is in ``group``."""
    group = set(group)
    return np.fromiter((l in group for l in labels), bool, len(labels))


def calc_map_prak(distances, labels, positive_pairs, negative_pairs=None,
                  prak=(1, 5)):
    """(mAP, (Pr@k for k in ``prak``)) of the [n, n] ``distances`` with
    item ``labels``."""
    distances = np.asarray(distances)
    labels = list(labels)
    n = len(labels)

    # the masks depend on the query's label only: one per distinct label
    pos_rows, keep_rows = {}, {}
    for lab in set(labels):
        pos_rows[lab] = _membership_row(labels, positive_pairs[lab])
        if negative_pairs is not None:
            keep_rows[lab] = (pos_rows[lab]
                              | _membership_row(labels, negative_pairs[lab]))

    aps = []
    praks = [[] for _ in prak]
    for i in range(n):
        lab = labels[i]
        order = np.argsort(distances[i]).ravel()
        if negative_pairs is not None:
            order = order[keep_rows[lab][order]]
        hits = pos_rows[lab][order][1:]    # the first slot is the query
        n_pos = int(np.count_nonzero(hits))
        if n_pos == 0:
            continue
        ranks = np.flatnonzero(hits) + 1
        aps.append(float(np.mean(np.arange(1, n_pos + 1) / ranks)))
        for k_i, k in enumerate(prak):
            praks[k_i].append(int(np.count_nonzero(hits[:k])) / min(n_pos, k))

    if not aps:
        # NaN here would poison the trainer's min-loss tracking
        raise ValueError(
            "calc_map_prak: no query retrieved any positive — check the "
            "positive_pairs ground truth against the ranked labels")
    return float(np.mean(aps)), tuple(float(np.mean(p)) for p in praks)
