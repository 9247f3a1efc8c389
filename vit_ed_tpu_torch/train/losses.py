"""Losses of the training slice (``vit_ed_tpu/train/losses.py:13-36``):
binary cross-entropy on logits, plain and over a padded pair buffer. The
triplet and SimSiam losses wait for the entries that use them (ROADMAP).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
