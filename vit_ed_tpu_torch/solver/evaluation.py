"""Simple standalone neighbor/direct accuracy
(re-creates the reference's paikin_tal_solver/puzzle_evaluation.py; vectorized
over the placement matrix instead of per-cell Python loops). The port's
copy of ``vit_ed_tpu/solver/evaluation.py``."""

from __future__ import annotations

import numpy as np

from .importer import Puzzle
from .piece import PuzzlePieceSide


def compute_neighbor_accuracy(puzzle: Puzzle) -> float:
    """Fraction of adjacent placement-matrix cells whose pieces were true
    neighbors in the original image."""
    placement_matrix, _ = puzzle.build_placed_piece_info()
    rows, cols = placement_matrix.shape
    pieces_by_orig = {p.original_piece_id: p for p in puzzle.pieces}

    correct = 0
    total = 0
    for i in range(rows):
        for j in range(cols):
            pid = placement_matrix[i][j]
            if pid < 0:
                continue
            piece = pieces_by_orig[int(pid)]
            for (di, dj, side) in [(0, -1, PuzzlePieceSide.left),
                                   (0, 1, PuzzlePieceSide.right),
                                   (-1, 0, PuzzlePieceSide.top),
                                   (1, 0, PuzzlePieceSide.bottom)]:
                ni, nj = i + di, j + dj
                if 0 <= ni < rows and 0 <= nj < cols:
                    nid = placement_matrix[ni][nj]
                    if nid >= 0:
                        correct += int(piece.is_neighbor(pieces_by_orig[int(nid)], side))
                    total += 1
    return correct / max(total, 1)


def compute_direct_accuracy(puzzle: Puzzle) -> float:
    """Fraction of pieces at their exact original location."""
    correct = sum(int(p.is_correctly_placed((0, 0))) for p in puzzle.pieces)
    return correct / max(len(puzzle.pieces), 1)
