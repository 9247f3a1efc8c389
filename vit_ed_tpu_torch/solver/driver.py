"""Solver driver (reference solver_driver.py:15-33); the port's copy of
``vit_ed_tpu/solver/driver.py``.

One change from the JAX driver, by design: with a precomputed distance
tensor the placement runs in the native C++ core (``native/solver.py``),
and a failed native build raises instead of running the Python loop.
``use_native=False`` asks for the Python solver (the plain version)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from .importer import Puzzle, PuzzleType
from .piece import PuzzlePiece, PuzzlePieceRotation, PuzzlePieceSide
from .solver import PaikinTalSolver


def paikin_tal_driver(pieces: Sequence[PuzzlePiece], piece_width: int,
                      distance_fn: Optional[Callable] = None,
                      fixed_puzzle_dimensions=None,
                      distances: Optional[np.ndarray] = None,
                      use_native: Optional[bool] = None) -> Puzzle:
    """Build the solver, run it, reconstruct the single output puzzle.

    ``distances`` may carry a precomputed [4, N, N] (type 1) or
    [4, N, 4, N] (type 2) tensor, e.g. the network's pair scores. With a
    tensor the placement runs in the native core unless ``use_native`` is
    False."""
    if use_native is None:
        use_native = distances is not None
    if use_native:
        if distances is None:
            raise ValueError("the native solver needs a distance tensor")
        return _native_driver(pieces, piece_width, distances,
                              fixed_puzzle_dimensions)
    puzzle_type = (PuzzleType.type2
                   if distances is not None and distances.ndim == 4
                   else PuzzleType.type1)
    solver = PaikinTalSolver(1, pieces, distance_fn, puzzle_type, 0,
                             fixed_puzzle_dimensions, distances=distances)
    solver.run()
    paikin_tal_results, _ = solver.get_solved_puzzles()
    puzzle_pieces = paikin_tal_results[0]
    puzzle_id = puzzle_pieces[0].puzzle_id
    puzzle = Puzzle.reconstruct_from_pieces(puzzle_pieces, piece_width, puzzle_id)
    puzzle.best_buddy_pairs = solver.engine.best_buddy_pairs()
    return puzzle


def _bb_pairs_from_table(bb: np.ndarray, n: int, type2: bool):
    """Flat native best-buddy table -> (i, side, j, j_side) tuples."""
    pairs = []
    for s in range(4):
        side = PuzzlePieceSide(s)
        for i in range(n):
            flat = int(bb[s * n + i])
            if flat < 0:
                continue
            if type2:
                pairs.append((i, side, flat % n, PuzzlePieceSide(flat // n)))
            else:
                pairs.append((i, side, flat, side.complementary_side))
    return pairs


def _native_driver(pieces, piece_width, distances, fixed_puzzle_dimensions):
    from vit_ed_tpu_torch.native import solver as native

    for i, piece in enumerate(pieces):
        piece.id_number = i
    if distances.ndim == 4:
        rows, cols, pids, rots, bb = native.pt_solve2(
            distances, fixed_puzzle_dimensions, numb_puzzles=1,
            new_board_mutual_compatibility=0.0)
    else:
        rows, cols, pids, bb = native.pt_solve(
            distances, fixed_puzzle_dimensions, numb_puzzles=1,
            new_board_mutual_compatibility=0.0)
        rots = np.zeros(len(pieces), np.int32)
    placed = []
    for i, piece in enumerate(pieces):
        if pids[i] < 0:
            continue
        piece.puzzle_id = int(pids[i])
        piece.location = (int(rows[i]), int(cols[i]))
        piece.rotation = PuzzlePieceRotation(int(rots[i]) * 90)
        placed.append(piece)
    puzzle_id = placed[0].puzzle_id
    puzzle = Puzzle.reconstruct_from_pieces(placed, piece_width, puzzle_id)
    puzzle.best_buddy_pairs = _bb_pairs_from_table(bb, len(pieces),
                                                   distances.ndim == 4)
    return puzzle
