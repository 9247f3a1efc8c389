"""Puzzle pieces as network input (``vit_ed_tpu/data/pieces.py``, the part
that puzzle evaluation runs): ``piece_to_rgb_image`` and ``PiecesImages``.

The LAB -> RGB conversion is ``solver.color.lab2rgb_u8``, equal to OpenCV's
``COLOR_LAB2RGB`` on every input. ``PiecesDataset`` and
``PiecesDatasetTriplet`` (the pair datasets of the pajigsaw and ViT
baselines) are not ported yet (ROADMAP queue A item 8).
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.solver.color import lab2rgb_u8
from vit_ed_tpu_torch.solver.piece import PuzzlePiece


def piece_to_rgb_image(piece: PuzzlePiece) -> Image.Image:
    """A piece's LAB pixels as an RGB PIL image."""
    img = piece.lab_image
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return Image.fromarray(lab2rgb_u8(img))


class PiecesImages:
    """Single-piece images, for the encode-once dense scorer
    (``PairwiseScorer.score_dense``)."""

    def __init__(self, pieces: List[PuzzlePiece], transform: Optional[Callable] = None):
        self.pieces = pieces
        self.transform = transform

    def image(self, i: int) -> np.ndarray:
        img = piece_to_rgb_image(self.pieces[i])
        if self.transform is not None:
            img, _ = self.transform(img, img)
        return np.asarray(img, np.float32)

    def all_images(self) -> np.ndarray:
        return np.stack([self.image(i) for i in range(len(self.pieces))])

    def __len__(self):
        return len(self.pieces)
