"""ICFHR-2020 wi19 writer-retrieval metrics.

Exact re-implementation of the official evaluator semantics used by the
reference (its misc/wi19_evaluate.py, itself from
github.com/anguelos/wi19_evaluate): mAP over non-singleton queries with the
self column removed, top-1, Pr@k.
"""

from __future__ import annotations

import numpy as np


def get_sorted_retrievals(D, classes, remove_self_column=True,
                          correct_retrievals=None):
    """wi19_evaluate.py:25-33."""
    if correct_retrievals is None:
        correct_retrievals = classes[None, :] == classes[:, None]
    sorted_indexes = np.argsort(D, axis=1)
    if remove_self_column:
        sorted_indexes = sorted_indexes[:, 1:]
    rows = np.arange(sorted_indexes.shape[0], dtype="int64")[:, None]
    return correct_retrievals[rows, sorted_indexes]


def get_precision_recall_matrices(D, classes, remove_self_column=True,
                                  correct_retrievals=None):
    """wi19_evaluate.py:36-45."""
    sorted_retrievals = get_sorted_retrievals(D, classes, remove_self_column,
                                              correct_retrievals)
    relevant_count = sorted_retrievals.sum(axis=1).reshape(-1, 1)
    precision_at = (np.cumsum(sorted_retrievals, axis=1).astype("float")
                    / np.cumsum(np.ones_like(sorted_retrievals), axis=1))
    recall_at = (np.cumsum(sorted_retrievals, axis=1).astype("float")
                 / np.maximum(relevant_count, 1))
    recall_at[relevant_count.reshape(-1) == 0, :] = 1
    return precision_at, recall_at, sorted_retrievals


def compute_map(precision_at, sorted_retrievals):
    """mAP excluding singleton queries (wi19_evaluate.py:48-55)."""
    valid_entries = sorted_retrievals.sum(axis=1) > 0
    precision_at = precision_at[valid_entries, :]
    sorted_retrievals = sorted_retrievals[valid_entries, :]
    AP = (precision_at * sorted_retrievals).sum(axis=1) / sorted_retrievals.sum(axis=1)
    return AP.mean()


def compute_pr_a_k(sorted_retrievals, k):
    """wi19_evaluate.py:7-9 (singleton queries yield nan, as upstream)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        pr_a_k = (sorted_retrievals[:, :k].sum(axis=1)
                  / np.minimum(sorted_retrievals.sum(axis=1), k))
    return pr_a_k.sum() / len(pr_a_k)


def compute_fscore(sorted_retrievals, relevant_estimate):
    """wi19_evaluate.py:58-67."""
    relevant_mask = (np.cumsum(np.ones_like(sorted_retrievals), axis=1)
                     <= relevant_estimate.reshape(-1, 1))
    tp = float((sorted_retrievals * relevant_mask).sum())
    retrieved = relevant_estimate.sum()
    relevant = sorted_retrievals.sum()
    precision = tp / retrieved
    recall = tp / relevant
    fscore = 2 * precision * recall / (precision + recall)
    return fscore, precision, recall


def compute_roc(sorted_retrievals):
    """wi19_evaluate.py:70-77."""
    true_positives = sorted_retrievals.sum(axis=0).cumsum().astype("float")
    false_positives = (1 - sorted_retrievals).sum(axis=0).cumsum().astype("float")
    relevant = np.ones_like(true_positives) * sorted_retrievals.sum()
    recalls = true_positives / relevant
    fallout = false_positives / (1 - sorted_retrievals).sum()
    return {"fallout": np.array(fallout), "recall": np.array(recalls)}


def get_metrics(distance_matrix, labels, remove_self_column=True):
    """-> (mAP, top-1, Pr@10, Pr@100) (wi19_evaluate.py:12-22)."""
    precision_at, _recall_at, sorted_retrievals = get_precision_recall_matrices(
        distance_matrix, labels, remove_self_column)
    non_singleton_idx = sorted_retrievals.sum(axis=1) > 0
    mAP = compute_map(precision_at[non_singleton_idx, :],
                      sorted_retrievals[non_singleton_idx, :])
    top_1 = sorted_retrievals[:, 0].sum() / len(sorted_retrievals)
    pr_a_k10 = compute_pr_a_k(sorted_retrievals, 10)
    pr_a_k100 = compute_pr_a_k(sorted_retrievals, 100)
    return mAP, top_1, pr_a_k10, pr_a_k100
