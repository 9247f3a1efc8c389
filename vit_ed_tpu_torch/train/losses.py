"""Losses (``vit_ed_tpu/train/losses.py``): binary cross-entropy on
logits, plain and over a padded pair buffer, and the cosine-distance
triplet losses of the ViT embedding baselines, and the SimSiam loss
(``negative_cosine_similarity``) with ``loss_combination``.

The triplet losses copy the JAX formulas op for op, gradients included:
the norm is clamped at 1e-12 (``F.cosine_similarity`` clamps at 1e-8 and
elsewhere), the hinge is ``torch.maximum`` (a tie at 0 splits the gradient
in halves, as ``jnp.maximum`` does) and the batch-hard reductions are
``amax`` / ``amin`` (tied entries share the gradient evenly, as in JAX;
``max(dim)`` would hand all of it to one index).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

from vit_ed_tpu_torch.parallel.mesh import all_gather_rows, all_reduce_sum, batch_index


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    reduction: str = "mean") -> torch.Tensor:
    """torch BCEWithLogitsLoss semantics (float targets, per-element)."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(reduction)
    return F.binary_cross_entropy_with_logits(logits, targets,
                                              reduction=reduction)


def masked_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                           mask: torch.Tensor,
                           reduction: str = "mean") -> torch.Tensor:
    """BCE over a padded pair buffer; ``mask`` [P] selects the live rows of
    ``logits`` / ``targets`` [P, ...]. "mean" divides by the number of live
    elements (at least 1), "sum" does not."""
    per_elem = F.binary_cross_entropy_with_logits(logits, targets,
                                                  reduction="none")
    mask = mask.reshape(mask.shape + (1,) * (per_elem.ndim - mask.ndim)
                        ).expand_as(per_elem)
    total = (per_elem * mask).sum()
    if reduction == "sum":
        return total
    return total / mask.sum().clamp(min=1.0)


def cosine_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """1 - cos(a, b) over the last axis (broadcasting), each side divided
    by its norm clamped at 1e-12."""
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True).clamp(min=1e-12)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True).clamp(min=1e-12)
    return 1.0 - (an * bn).sum(dim=-1)


def _hinge(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros_like(x))


def triplet_cosine_loss(anchor: torch.Tensor, positive: torch.Tensor,
                        negative: torch.Tensor, margin: float = 0.2) -> torch.Tensor:
    """TripletMarginWithDistanceLoss with the cosine distance, mean over the
    batch."""
    d_pos = cosine_distance(anchor, positive)
    d_neg = cosine_distance(anchor, negative)
    return _hinge(d_pos - d_neg + margin).mean()


def batch_wise_triplet_loss(embeddings: torch.Tensor, labels: torch.Tensor,
                            margin: float = 0.2) -> torch.Tensor:
    """Batch-hard triplet loss over in-batch label equality: per anchor the
    farthest positive and the nearest negative; anchors without a positive
    or without a negative count zero and are left out of the mean.

    The batch is the global batch of the batch group (the default process
    group, or a mesh's data axis: the JAX loss under jit over the global
    mesh): this rank's anchors against every
    rank's embeddings and labels (``all_gather_rows``, whose backward brings
    the other ranks' gradients to this rank's rows), self left out by global
    index, the sum divided by the global count of valid anchors. The ranks'
    losses then sum to the global loss. Without a group it is the plain
    loss of this batch."""
    n = labels.shape[0]
    others, other_labels = all_gather_rows(embeddings), all_gather_rows(labels)
    d = cosine_distance(embeddings[:, None, :], others[None, :, :])
    same = labels[:, None] == other_labels[None, :]
    rows = torch.arange(n, device=labels.device)[:, None] + batch_index() * n
    eye = rows == torch.arange(other_labels.shape[0], device=labels.device)[None, :]
    pos_mask = same & ~eye
    neg_mask = ~same
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    d_pos = torch.where(pos_mask, d, -inf).amax(dim=1)
    d_neg = torch.where(neg_mask, d, inf).amin(dim=1)
    valid = pos_mask.any(dim=1) & neg_mask.any(dim=1)
    loss = _hinge(d_pos - d_neg + margin)
    count = all_reduce_sum(valid.sum())
    return torch.where(valid, loss, torch.zeros_like(loss)).sum() / count.clamp(min=1)


def negative_cosine_similarity(predict: torch.Tensor, actual: torch.Tensor) -> torch.Tensor:
    """SimSiam loss: minus the mean over the batch of the cosine of each row
    pair, each row divided by its norm clamped at 1e-12."""
    pn = predict / torch.linalg.vector_norm(predict, dim=1, keepdim=True).clamp(min=1e-12)
    an = actual / torch.linalg.vector_norm(actual, dim=1, keepdim=True).clamp(min=1e-12)
    return -(pn * an).sum(dim=1).mean()


def loss_combination(criterions: Sequence[Callable]) -> Callable:
    """The sum of ``criterions``, each called with the same arguments."""

    def fn(*args, **kwargs):
        return sum(c(*args, **kwargs) for c in criterions)

    return fn
