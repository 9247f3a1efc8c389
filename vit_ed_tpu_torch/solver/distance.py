"""Vectorized inter-piece distance / compatibility engine.

This replaces the O(N^2 * 4) Python loops of
the reference's paikin_tal_solver/inter_piece_distance.py (classes
PieceDistanceInformation and InterPieceDistance, ~1300 LoC of per-pair
iteration) with whole-matrix numpy computations over a [4, N, N] distance
tensor. Semantics preserved:

- asymmetric distance D[s, i, j]: distance of placing j against side s of i
  (type-1: j's side is always the complement of s,
  inter_piece_distance.py:189-237)
- min / second-best per (i, side) with the reference's sentinel
  initialisation (maxsize-1 / maxsize, inter_piece_distance.py:275-287)
- asymmetric compatibility 1 - d/second_best with the 0-distance and
  0-second-best special cases (inter_piece_distance.py:356-369)
- mutual compatibility = average of the two directed compatibilities
  (inter_piece_distance.py:491-525)
- best buddies = mutually-unique minimum pairs; ties disqualify
  (_ALLOW_MULTIPLE_BEST_BUDDIES = False, inter_piece_distance.py:136-143)
- start-piece ordering by (4*|BB| + sum of BB's |BB|, total compatibility)
  (inter_piece_distance.py:650-735)
- the placement-aware recalculation path masks placed pieces out of the
  min/second computation (inter_piece_distance.py:527-552)

The distance tensor itself can come from (a) the vectorized classical
border-extrapolation computation below, or (b) NN pair scores
(evaluation.py:116-131 routing of 4-bin sigmoid outputs).

The port's copy of ``vit_ed_tpu/solver/distance.py``.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from .piece import PuzzlePiece, PuzzlePieceSide

_MAXSIZE = float(sys.maxsize)
_SENTINEL_MIN = float(sys.maxsize - 1)

TOP, RIGHT, BOTTOM, LEFT = 0, 1, 2, 3
_COMP = np.array([2, 3, 0, 1])  # complementary side index


def classical_distance_matrix(pieces: Sequence[PuzzlePiece],
                              chunk: int = 256) -> np.ndarray:
    """All-pairs classical extrapolation distance, vectorized.

    Returns D [4, N, N] float64 where D[s, i, j] equals
    PuzzlePiece.calculate_asymmetric_distance(pieces[i], side s, pieces[j],
    complement(s)) — the type-1 pairing (no reversal is ever needed for
    complementary side pairs, puzzle_piece.py:571-598).
    """
    n = len(pieces)
    w = pieces[0].width
    imgs = np.stack([p.lab_image for p in pieces]).astype(np.int16)  # [N, W, W, 3]

    border = np.empty((4, n, w, 3), np.int16)
    second = np.empty((4, n, w, 3), np.int16)
    border[TOP] = imgs[:, 0, :, :]
    second[TOP] = imgs[:, 1, :, :]
    border[RIGHT] = imgs[:, :, w - 1, :]
    second[RIGHT] = imgs[:, :, w - 2, :]
    border[BOTTOM] = imgs[:, w - 1, :, :]
    second[BOTTOM] = imgs[:, w - 2, :, :]
    border[LEFT] = imgs[:, :, 0, :]
    second[LEFT] = imgs[:, :, 1, :]

    predicted = (2 * border.astype(np.int32) - second.astype(np.int32))  # [4, N, W, 3]

    D = np.empty((4, n, n), np.float64)
    for s in range(4):
        pj = border[_COMP[s]].astype(np.int32).reshape(n, -1)   # [N, W*3]
        pi = predicted[s].reshape(n, -1)                        # [N, W*3]
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            diff = np.abs(pi[lo:hi, None, :] - pj[None, :, :])  # [c, N, W*3]
            D[s, lo:hi] = diff.sum(axis=2)
    return D


# Reversal rule of PuzzlePiece.calculate_asymmetric_distance
# (puzzle_piece.py:571-598): j's border is index-reversed iff both sides are
# horizontal-ish (top/right) or both vertical-ish (bottom/left).
_REVERSE = np.array([[(s < 2) == (t < 2) for t in range(4)] for s in range(4)])


def classical_distance_matrix_type2(pieces: Sequence[PuzzlePiece],
                                    chunk: int = 256) -> np.ndarray:
    """All-pairs classical distance over ALL 16 side pairings.

    Returns D [4, N, 4, N] float64 where D[s, i, t, j] equals
    PuzzlePiece.calculate_asymmetric_distance(pieces[i], side s, pieces[j],
    side t) — the type-2 pairing set (inter_piece_distance.py:325-369,
    puzzle_piece.py:534-609 including the border-reversal rule).
    """
    n = len(pieces)
    w = pieces[0].width
    imgs = np.stack([p.lab_image for p in pieces]).astype(np.int16)

    border = np.empty((4, n, w, 3), np.int16)
    second = np.empty((4, n, w, 3), np.int16)
    border[TOP] = imgs[:, 0, :, :]
    second[TOP] = imgs[:, 1, :, :]
    border[RIGHT] = imgs[:, :, w - 1, :]
    second[RIGHT] = imgs[:, :, w - 2, :]
    border[BOTTOM] = imgs[:, w - 1, :, :]
    second[BOTTOM] = imgs[:, w - 2, :, :]
    border[LEFT] = imgs[:, :, 0, :]
    second[LEFT] = imgs[:, :, 1, :]

    predicted = (2 * border.astype(np.int32) - second.astype(np.int32))

    D = np.empty((4, n, 4, n), np.float64)
    for s in range(4):
        pi = predicted[s].reshape(n, -1)                     # [N, W*3]
        for t in range(4):
            bj = border[t]
            if _REVERSE[s, t]:
                bj = bj[:, ::-1, :]
            pj = bj.astype(np.int32).reshape(n, -1)
            for lo in range(0, n, chunk):
                hi = min(lo + chunk, n)
                diff = np.abs(pi[lo:hi, None, :] - pj[None, :, :])
                D[s, lo:hi, t] = diff.sum(axis=2)
    return D


def distance_matrix_from_function_type2(pieces: Sequence[PuzzlePiece],
                                        distance_function: Callable) -> np.ndarray:
    """Brute-force [4, N, 4, N] tensor from a reference-style function."""
    n = len(pieces)
    D = np.full((4, n, 4, n), np.inf, np.float64)
    sides = PuzzlePieceSide.get_all_sides()
    for i in range(n):
        for s in sides:
            for j in range(n):
                if i == j:
                    continue
                for t in sides:
                    D[s.value, i, t.value, j] = distance_function(
                        pieces[i], s, pieces[j], t)
    return D


def distance_matrix_from_predictions(preds: np.ndarray,
                                     scale: float = 1000.0) -> np.ndarray:
    """Build D [4, N, N] from 4-bin pair predictions.

    ``preds[i, j]`` = sigmoid logits-probabilities that j is
    [right-of, below, left-of, above] i. Routing follows
    evaluation.py:116-131: distance = (1 - p) * 1000 assigned to
    D[right], D[bottom], D[left], D[top] respectively; invalid side pairs
    are +inf (handled by the type-1 pairing structure).
    """
    n = preds.shape[0]
    D = np.empty((4, n, n), np.float64)
    inv = (1.0 - preds) * scale
    D[RIGHT] = inv[:, :, 0]
    D[BOTTOM] = inv[:, :, 1]
    D[LEFT] = inv[:, :, 2]
    D[TOP] = inv[:, :, 3]
    return D


def distance_matrix_from_function(pieces: Sequence[PuzzlePiece],
                                  distance_function: Callable) -> np.ndarray:
    """Fallback: evaluate an arbitrary reference-style distance function for
    every type-1 (i, side, j) triple."""
    n = len(pieces)
    D = np.full((4, n, n), np.inf, np.float64)
    sides = PuzzlePieceSide.get_all_sides()
    for i in range(n):
        for s in sides:
            for j in range(n):
                if i == j:
                    continue
                D[s.value, i, j] = distance_function(
                    pieces[i], s, pieces[j], s.complementary_side)
    return D


class CompatibilityEngine:
    """Type-1 compatibility state over a [4, N, N] distance tensor."""

    def __init__(self, distances: np.ndarray):
        assert distances.ndim == 3 and distances.shape[0] == 4
        self.n = distances.shape[1]
        self.D = distances.astype(np.float64).copy()
        idx = np.arange(self.n)
        self.D[:, idx, idx] = np.inf
        self.min_d = None            # [4, N]
        self.second_d = None         # [4, N]
        self.candidate = None        # [4, N] unique argmin or -1
        self.acompat = None          # [4, N, N]
        self.mutual = None           # [4, N, N]
        self.bb = None               # [4, N] best buddy id or -1
        self.start_piece_ordering: List[Tuple[int, int, float]] = []
        self.recompute(None)
        self.find_best_buddies()
        self.find_start_piece_candidates()

    # ------------------------------------------------------------- min/second
    def _min_second(self, mask_j: Optional[np.ndarray]):
        """Masked min/second-best over j, with sentinel semantics and the
        unique-argmin candidate (ties -> -1)."""
        D = self.D
        if mask_j is not None:
            D = np.where(mask_j[None, None, :], np.inf, D)
        part = np.sort(D, axis=2)                      # [4, N, N] ascending
        valid = np.isfinite(D).sum(axis=2)             # [4, N]
        min_d = np.where(valid >= 1, part[:, :, 0], _SENTINEL_MIN)
        second_d = np.where(valid >= 2, part[:, :, 1], _MAXSIZE)
        # only one valid j: second best stays at the pushed-down sentinel
        second_d = np.where(valid == 1, _SENTINEL_MIN, second_d)
        second_d = np.where(valid == 0, _MAXSIZE, second_d)

        is_min = (D == min_d[:, :, None]) & np.isfinite(D)
        n_min = is_min.sum(axis=2)
        argmin = np.argmax(is_min, axis=2)
        candidate = np.where(n_min == 1, argmin, -1)
        return min_d, second_d, candidate

    # -------------------------------------------------------------- compat
    def recompute(self, placed: Optional[np.ndarray],
                  placed_no_open: Optional[np.ndarray] = None):
        """(Re)compute min/second, asymmetric + mutual compatibility.

        ``placed`` masks pieces out of the min/second search; compat columns
        for masked pieces are recomputed against the reduced second-best,
        mirroring recalculate_remaining_piece_compatibilities
        (inter_piece_distance.py:527-552).
        """
        if placed_no_open is None:
            placed_no_open = placed
        self.min_d, self.second_d, self.candidate = self._min_second(placed)

        second = self.second_d[:, :, None]             # [4, N, 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            ac = 1.0 - self.D / second
        ac = np.where(self.D == 0, 1.0, ac)
        ac = np.where((second == 0) & (self.D != 0), -_MAXSIZE, ac)
        ac = np.where(np.isfinite(self.D), ac, -np.inf)
        if placed_no_open is not None:
            ac = np.where(placed_no_open[None, None, :], -np.inf, ac)
        self.acompat = ac

        # mutual[s, i, j] = (ac[s, i, j] + ac[comp(s), j, i]) / 2
        ac_rev = ac[_COMP]                              # [4, N, N] (comp side)
        self.mutual = (ac + ac_rev.transpose(0, 2, 1)) / 2.0

    def recalculate_remaining_piece_compatibilities(self, is_piece_placed,
                                                    is_piece_placed_with_no_open_neighbors):
        placed = np.asarray(is_piece_placed, bool)
        placed_no_open = np.asarray(is_piece_placed_with_no_open_neighbors, bool)
        self.recompute(placed, placed_no_open)

    # ------------------------------------------------------------ best buddies
    def find_best_buddies(self, is_piece_placed: Optional[np.ndarray] = None):
        """bb[s, i] = j iff candidate(i, s) == j uniquely AND
        candidate(j, comp(s)) == i uniquely (inter_piece_distance.py:623-648)."""
        cand = self.candidate                           # [4, N]
        bb = np.full((4, self.n), -1, np.int64)
        for s in range(4):
            j = cand[s]                                 # [N]
            valid = j >= 0
            jj = np.where(valid, j, 0)
            mutual = cand[_COMP[s]][jj] == np.arange(self.n)
            bb[s] = np.where(valid & mutual, j, -1)
        if is_piece_placed is not None:
            placed = np.asarray(is_piece_placed, bool)
            bb[:, placed] = -1
        self.bb = bb

    def best_buddies(self, p_i: int, p_i_side: PuzzlePieceSide):
        j = self.bb[p_i_side.value, p_i]
        if j < 0:
            return []
        return [(int(j), p_i_side.complementary_side)]

    def best_buddy_pairs(self):
        """All (piece_id, side, buddy_id, buddy_side) relations — the input
        of the BestBuddyAccuracy metric (importer.py)."""
        out = []
        for s in range(4):
            side = PuzzlePieceSide(s)
            for i in range(self.n):
                for j, t in self.best_buddies(i, side):
                    out.append((i, side, j, t))
        return out

    # ------------------------------------------------------------ start pieces
    def find_start_piece_candidates(self, is_piece_placed: Optional[np.ndarray] = None):
        """Ordering by best-buddy richness (inter_piece_distance.py:650-735)."""
        placed = (np.asarray(is_piece_placed, bool) if is_piece_placed is not None
                  else np.zeros(self.n, bool))
        bb = self.bb
        has_bb = bb >= 0                                # [4, N]
        n_bb = has_bb.sum(axis=0)                       # [N]
        # total compat of each piece's best buddies
        total_compat = np.zeros(self.n, np.float64)
        for s in range(4):
            j = bb[s]
            valid = j >= 0
            jj = np.where(valid, j, 0)
            mc = self.mutual[s, np.arange(self.n), jj]
            total_compat += np.where(valid, mc, 0.0)
        # neighbor count: 4 * |BB(i)| + sum over buddies of |BB(j)|
        numb_bb_neighbors = 4 * n_bb.astype(np.int64)
        for s in range(4):
            j = bb[s]
            valid = j >= 0
            jj = np.where(valid, j, 0)
            numb_bb_neighbors += np.where(valid, n_bb[jj], 0)

        order = [(i, int(numb_bb_neighbors[i]), float(total_compat[i]))
                 for i in range(self.n) if not placed[i]]
        order.sort(key=lambda t: (t[1], t[2]), reverse=True)
        self.start_piece_ordering = order

    def next_starting_piece(self, placed_pieces: Optional[Sequence[bool]] = None) -> int:
        if placed_pieces is None:
            return self.start_piece_ordering[0][0]
        i = 0
        while placed_pieces[self.start_piece_ordering[i][0]]:
            i += 1
        return self.start_piece_ordering[i][0]

    # ------------------------------------------------------------- accessors
    def asymmetric_distance(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                            p_j_side: PuzzlePieceSide):
        self._assert_type1(p_i_side, p_j_side)
        return self.D[p_i_side.value, p_i, p_j]

    def asymmetric_compatibility(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                                 p_j_side: PuzzlePieceSide):
        self._assert_type1(p_i_side, p_j_side)
        return self.acompat[p_i_side.value, p_i, p_j]

    def mutual_compatibility(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                             p_j_side: PuzzlePieceSide):
        self._assert_type1(p_i_side, p_j_side)
        return float(self.mutual[p_i_side.value, p_i, p_j])

    def mutual_for_slot(self, next_side: PuzzlePieceSide, neighbor_id: int,
                        neighbor_side: PuzzlePieceSide) -> np.ndarray:
        """Mutual compatibility of every candidate piece (on ``next_side``)
        against a placed neighbor's open ``neighbor_side`` — the vector the
        solver argmaxes when the best-buddy pool runs dry."""
        return self.mutual[next_side.value, :, neighbor_id]

    @staticmethod
    def _assert_type1(p_i_side, p_j_side):
        assert p_i_side.complementary_side == p_j_side

    @staticmethod
    def get_valid_neighbor_sides(puzzle_type, p_i_side: PuzzlePieceSide):
        from .importer import PuzzleType

        if puzzle_type == PuzzleType.type1:
            return [p_i_side.complementary_side]
        return PuzzlePieceSide.get_all_sides()


class CompatibilityEngine2:
    """Type-2 (rotation-aware) compatibility over a [4, N, 4, N] tensor.

    ``D[s, i, t, j]`` is the distance of placing piece j's side t against
    piece i's side s. Minimum / second-best run over the JOINT (side, piece)
    candidate space, exactly as the reference's per-pairing update loop
    (inter_piece_distance.py:189-369 with the type-2 pairing set); best
    buddies are mutually-unique (piece, side) argmin pairs.
    """

    def __init__(self, distances: np.ndarray):
        assert distances.ndim == 4 and distances.shape[0] == 4 \
            and distances.shape[2] == 4
        self.n = distances.shape[1]
        self.D = distances.astype(np.float64).copy()
        idx = np.arange(self.n)
        self.D[:, idx, :, idx] = np.inf
        self.min_d = None            # [4, N]
        self.second_d = None         # [4, N]
        self.candidate = None        # [4, N] flat (t*n + j) unique argmin or -1
        self.acompat = None          # [4, N, 4, N]
        self.mutual = None           # [4, N, 4, N]
        self.bb = None               # [4, N] flat (t*n + j) best buddy or -1
        self.start_piece_ordering: List[Tuple[int, int, float]] = []
        self.recompute(None)
        self.find_best_buddies()
        self.find_start_piece_candidates()

    def _flat(self):
        """View D as [4, N, 4*N] with flat index t*n + j."""
        return self.D.reshape(4, self.n, 4 * self.n)

    def _min_second(self, mask_j: Optional[np.ndarray]):
        D = self._flat()
        if mask_j is not None:
            D = np.where(np.tile(np.asarray(mask_j, bool), 4)[None, None, :],
                         np.inf, D)
        part = np.sort(D, axis=2)
        valid = np.isfinite(D).sum(axis=2)
        min_d = np.where(valid >= 1, part[:, :, 0], _SENTINEL_MIN)
        second_d = np.where(valid >= 2, part[:, :, 1], _MAXSIZE)
        second_d = np.where(valid == 1, _SENTINEL_MIN, second_d)
        second_d = np.where(valid == 0, _MAXSIZE, second_d)

        is_min = (D == min_d[:, :, None]) & np.isfinite(D)
        n_min = is_min.sum(axis=2)
        argmin = np.argmax(is_min, axis=2)
        candidate = np.where(n_min == 1, argmin, -1)
        return min_d, second_d, candidate

    def recompute(self, placed: Optional[np.ndarray],
                  placed_no_open: Optional[np.ndarray] = None):
        if placed_no_open is None:
            placed_no_open = placed
        self.min_d, self.second_d, self.candidate = self._min_second(placed)

        second = self.second_d[:, :, None, None]           # [4, N, 1, 1]
        with np.errstate(divide="ignore", invalid="ignore"):
            ac = 1.0 - self.D / second
        ac = np.where(self.D == 0, 1.0, ac)
        ac = np.where((second == 0) & (self.D != 0), -_MAXSIZE, ac)
        ac = np.where(np.isfinite(self.D), ac, -np.inf)
        if placed_no_open is not None:
            ac = np.where(np.asarray(placed_no_open, bool)[None, None, None, :],
                          -np.inf, ac)
        self.acompat = ac

        # mutual[s, i, t, j] = (ac[s, i, t, j] + ac[t, j, s, i]) / 2
        self.mutual = (ac + ac.transpose(2, 3, 0, 1)) / 2.0

    def recalculate_remaining_piece_compatibilities(self, is_piece_placed,
                                                    is_piece_placed_with_no_open_neighbors):
        placed = np.asarray(is_piece_placed, bool)
        placed_no_open = np.asarray(is_piece_placed_with_no_open_neighbors, bool)
        self.recompute(placed, placed_no_open)

    def find_best_buddies(self, is_piece_placed: Optional[np.ndarray] = None):
        """(t, j) is the best buddy of (s, i) iff both are each other's
        unique joint argmin (inter_piece_distance.py:623-648)."""
        cand = self.candidate                               # [4, N] flat
        n = self.n
        bb = np.full((4, n), -1, np.int64)
        i_flat = np.arange(n)
        for s in range(4):
            c = cand[s]                                     # [N]
            valid = c >= 0
            cc = np.where(valid, c, 0)
            t = cc // n
            j = cc % n
            back = cand[t, j]                               # candidate of (t, j)
            mutual = back == (s * n + i_flat)
            bb[s] = np.where(valid & mutual, cc, -1)
        if is_piece_placed is not None:
            bb[:, np.asarray(is_piece_placed, bool)] = -1
        self.bb = bb

    def best_buddies(self, p_i: int, p_i_side: PuzzlePieceSide):
        flat = self.bb[p_i_side.value, p_i]
        if flat < 0:
            return []
        return [(int(flat % self.n), PuzzlePieceSide(int(flat // self.n)))]

    best_buddy_pairs = CompatibilityEngine.best_buddy_pairs

    def find_start_piece_candidates(self, is_piece_placed: Optional[np.ndarray] = None):
        placed = (np.asarray(is_piece_placed, bool) if is_piece_placed is not None
                  else np.zeros(self.n, bool))
        bb = self.bb
        n = self.n
        has_bb = bb >= 0
        n_bb = has_bb.sum(axis=0)
        total_compat = np.zeros(n, np.float64)
        numb_bb_neighbors = 4 * n_bb.astype(np.int64)
        i_flat = np.arange(n)
        for s in range(4):
            flat = bb[s]
            valid = flat >= 0
            ff = np.where(valid, flat, 0)
            t = ff // n
            j = ff % n
            mc = self.mutual[s, i_flat, t, j]
            total_compat += np.where(valid, mc, 0.0)
            numb_bb_neighbors += np.where(valid, n_bb[j], 0)

        order = [(i, int(numb_bb_neighbors[i]), float(total_compat[i]))
                 for i in range(n) if not placed[i]]
        order.sort(key=lambda t_: (t_[1], t_[2]), reverse=True)
        self.start_piece_ordering = order

    def next_starting_piece(self, placed_pieces: Optional[Sequence[bool]] = None) -> int:
        if placed_pieces is None:
            return self.start_piece_ordering[0][0]
        i = 0
        while placed_pieces[self.start_piece_ordering[i][0]]:
            i += 1
        return self.start_piece_ordering[i][0]

    # ------------------------------------------------------------- accessors
    def asymmetric_distance(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                            p_j_side: PuzzlePieceSide):
        return self.D[p_i_side.value, p_i, p_j_side.value, p_j]

    def asymmetric_compatibility(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                                 p_j_side: PuzzlePieceSide):
        return self.acompat[p_i_side.value, p_i, p_j_side.value, p_j]

    def mutual_compatibility(self, p_i, p_i_side: PuzzlePieceSide, p_j,
                             p_j_side: PuzzlePieceSide):
        return float(self.mutual[p_i_side.value, p_i, p_j_side.value, p_j])

    def mutual_for_slot(self, next_side: PuzzlePieceSide, neighbor_id: int,
                        neighbor_side: PuzzlePieceSide) -> np.ndarray:
        return self.mutual[next_side.value, :, neighbor_side.value, neighbor_id]

    @staticmethod
    def get_valid_neighbor_sides(puzzle_type, p_i_side: PuzzlePieceSide):
        return CompatibilityEngine.get_valid_neighbor_sides(puzzle_type, p_i_side)
