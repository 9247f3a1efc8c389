"""Classification metrics of the DIV2K validation in numpy: accuracy and
macro-averaged F1 / precision / recall with the semantics of
``sklearn.metrics`` at ``average="macro", zero_division=0`` (which the JAX
entry imports): the classes are the labels present in either array, and a
class nobody predicted (or nobody holds) scores 0.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def accuracy_score(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def _class_counts(y_true, y_pred) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per class present in either array: true positives, predicted count,
    true count."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    hit = y_true == y_pred
    tp = np.asarray([np.sum(hit & (y_true == l)) for l in labels], np.float64)
    n_pred = np.asarray([np.sum(y_pred == l) for l in labels], np.float64)
    n_true = np.asarray([np.sum(y_true == l) for l in labels], np.float64)
    return tp, n_pred, n_true


def _macro(num: np.ndarray, den: np.ndarray) -> float:
    return float(np.mean(np.where(den > 0, num / np.maximum(den, 1.0), 0.0)))


def precision_score(y_true, y_pred) -> float:
    tp, n_pred, _ = _class_counts(y_true, y_pred)
    return _macro(tp, n_pred)


def recall_score(y_true, y_pred) -> float:
    tp, _, n_true = _class_counts(y_true, y_pred)
    return _macro(tp, n_true)


def f1_score(y_true, y_pred) -> float:
    tp, n_pred, n_true = _class_counts(y_true, y_pred)
    return _macro(2.0 * tp, n_pred + n_true)
