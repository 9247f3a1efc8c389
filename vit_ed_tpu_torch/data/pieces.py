"""Puzzle pieces as network input (``vit_ed_tpu/data/pieces.py``):
``piece_to_rgb_image``, ``PiecesDataset`` (every ordered pair as a stacked
pair image), ``PiecesImages`` (one image per piece, for the dense scorer)
and ``PiecesDatasetTriplet``.

The LAB -> RGB conversion is ``solver.color.lab2rgb_u8``, equal to OpenCV's
``COLOR_LAB2RGB`` on every input.
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


class PiecesDataset:
    """Every ordered pair (i, j), i != j, of ``pieces`` as a stacked pair
    image [2, H, W, 3] float32, with its index into ``entries`` as the
    target."""

    def __init__(self, pieces: List[PuzzlePiece], transform: Optional[Callable] = None):
        self.pieces = pieces
        self.transform = transform
        self.entries = [(i, j) for i in range(len(pieces))
                        for j in range(len(pieces)) if i != j]

    def __getitem__(self, index: int):
        i, j = self.entries[index]
        first_img = piece_to_rgb_image(self.pieces[i])
        second_img = piece_to_rgb_image(self.pieces[j])
        if self.transform is not None:
            first_img, second_img = self.transform(first_img, second_img)
        stacked = np.stack([np.asarray(first_img), np.asarray(second_img)], axis=0)
        return stacked.astype(np.float32), np.asarray(index, np.int32)

    def __len__(self):
        return len(self.entries)


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


class PiecesDatasetTriplet:
    """Every ordered pair (i, j), i != j, of ``pieces`` as 4 rotated
    pairings, for the triplet-ViT baseline's distances: (first, second
    rotated 180) for "second right of first", then the bottom, left and top
    pairings by PIL rotations. Items are [8, H, W, 3] float32 (the 4
    pairings' two images each) and the index into ``entries``."""

    def __init__(self, pieces: List[PuzzlePiece], transform: Optional[Callable] = None):
        self.pieces = pieces
        self.transform = transform
        self.entries = [(i, j) for i in range(len(pieces))
                        for j in range(len(pieces)) if i != j]

    def __getitem__(self, index: int):
        i, j = self.entries[index]
        first_img = piece_to_rgb_image(self.pieces[i])
        second_img = piece_to_rgb_image(self.pieces[j])

        images = []
        for f, s in [
            (first_img, second_img.rotate(180)),             # right of first
            (first_img.rotate(90), second_img.rotate(270)),  # bottom
            (first_img.rotate(180), second_img),             # left
            (first_img.rotate(270), second_img.rotate(90)),  # top
        ]:
            ft, st = self.transform(f, s)
            images.append(np.stack([np.asarray(ft), np.asarray(st)], axis=0))
        return np.concatenate(images, axis=0).astype(np.float32), np.asarray(index, np.int32)

    def __len__(self):
        return len(self.entries)
