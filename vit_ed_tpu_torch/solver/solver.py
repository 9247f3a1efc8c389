"""Paikin-Tal greedy kernel-growing solver.

Host-side placement loop (inherently sequential, tiny per-step work)
consuming the vectorized CompatibilityEngine. Re-creates
the reference's paikin_tal_solver/solver.py:142-708:

- seed piece = best-buddy-richest (solver.py:520-562)
- max-heap of (best-buddy, open-slot) pairs keyed by mutual compatibility
  (solver.py:364-391); python heapq with negated keys
- when the BB pool empties, compatibilities are recalculated over remaining
  pieces and pool x open-slots scored exhaustively (solver.py:393-411,
  456-499) — here the exhaustive scoring is a vectorized argmax
- fixed board-dimension enforcement (solver.py:427-443)
- multi-board spawning below the mutual-compatibility threshold
  (solver.py:244-249, 507-518)

The port's copy of ``vit_ed_tpu/solver/solver.py``, and the plain version
of the native core (``native/paikin_tal.cc``).
"""

from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Sequence

import numpy as np

from .distance import (
    CompatibilityEngine,
    CompatibilityEngine2,
    classical_distance_matrix,
    classical_distance_matrix_type2,
    distance_matrix_from_function,
    distance_matrix_from_function_type2,
)
from .piece import PuzzlePiece, PuzzlePieceRotation, PuzzlePieceSide


class PuzzleOpenSlot:
    """An open board location adjacent to a placed piece (solver.py:69-89)."""

    def __init__(self, puzzle_id, coord, piece_id, open_side):
        (row, column) = coord
        self.puzzle_id = puzzle_id
        self.location = (row, column)
        self.piece_id = piece_id
        self.open_side = open_side
        self._key = f"{puzzle_id}_{row}_{column}_{open_side.value}"

    @property
    def key(self):
        return self._key


class PuzzleDimensions:
    def __init__(self, puzzle_id, starting_point):
        self.puzzle_id = puzzle_id
        self.top_left = [starting_point[0], starting_point[1]]
        self.bottom_right = [starting_point[0], starting_point[1]]
        self.total_size = (1, 1)

    def update_dimensions(self):
        self.total_size = (self.bottom_right[0] - self.top_left[0] + 1,
                           self.bottom_right[1] - self.top_left[1] + 1)


class NextPieceToPlace:
    def __init__(self, puzzle_id, open_slot_location, next_piece_id, next_piece_side,
                 neighbor_piece_id, neighbor_piece_side, compatibility, is_best_buddy):
        self.puzzle_id = puzzle_id
        self.open_slot_location = open_slot_location
        self.next_piece_id = next_piece_id
        self.next_piece_side = next_piece_side
        self.neighbor_piece_id = neighbor_piece_id
        self.neighbor_piece_side = neighbor_piece_side
        self.mutual_compatibility = compatibility
        self.is_best_buddy = is_best_buddy


class PaikinTalSolver:
    DEFAULT_MINIMUM_MUTUAL_COMPATIBILITY_FOR_NEW_BOARD = 0.5
    _PERFORM_ASSERTION_CHECK = True

    def __init__(self, numb_puzzles: int, pieces: Sequence[PuzzlePiece],
                 distance_function: Optional[Callable] = None, puzzle_type=None,
                 new_board_mutual_compatibility=None, fixed_puzzle_dimensions=None,
                 distances: Optional[np.ndarray] = None):
        from .importer import PuzzleType

        if numb_puzzles < 0:
            raise ValueError("At least a single puzzle is required.")
        if numb_puzzles > 1 and fixed_puzzle_dimensions is not None:
            raise ValueError("When specifying puzzle dimensions, only a single puzzle is allowed.")

        self._pieces = list(pieces)
        for i, piece in enumerate(self._pieces):
            piece.id_number = i
        self._piece_placed = [False] * len(pieces)
        self._numb_unplaced_pieces = len(pieces)
        self._open_locations: List[PuzzleOpenSlot] = []
        self._piece_locations = []
        self._actual_numb_puzzles = numb_puzzles
        self._actual_puzzle_dimensions = fixed_puzzle_dimensions
        self._placed_puzzle_dimensions: List[PuzzleDimensions] = []
        self._puzzle_type = puzzle_type if puzzle_type is not None else PuzzleType.type1
        self._new_board_mutual_compatibility = (
            new_board_mutual_compatibility if new_board_mutual_compatibility is not None
            else PaikinTalSolver.DEFAULT_MINIMUM_MUTUAL_COMPATIBILITY_FOR_NEW_BOARD)

        self._best_buddies_pool = {}
        self._best_buddy_open_slot_heap: List = []
        self._heap_counter = itertools.count()
        self._numb_puzzles = 0

        type2 = self._puzzle_type == PuzzleType.type2
        if distances is None:
            if distance_function is PuzzlePiece.calculate_asymmetric_distance:
                distances = (classical_distance_matrix_type2(self._pieces) if type2
                             else classical_distance_matrix(self._pieces))
            elif distance_function is not None:
                distances = (distance_matrix_from_function_type2(
                                 self._pieces, distance_function) if type2
                             else distance_matrix_from_function(
                                 self._pieces, distance_function))
            else:
                raise ValueError("Either distances or distance_function is required")
        if type2 and distances.ndim != 4:
            raise ValueError("Type-2 puzzles need a [4, N, 4, N] distance tensor")
        self._engine = (CompatibilityEngine2(distances) if distances.ndim == 4
                        else CompatibilityEngine(distances))

    @property
    def engine(self) -> CompatibilityEngine:
        return self._engine

    # ---------------------------------------------------------------- main loop
    def run(self, skip_initial=False):
        if not skip_initial:
            self._place_seed_piece()

        while self._numb_unplaced_pieces > 0:
            next_piece = self._find_next_piece()
            if (self._numb_puzzles < self._actual_numb_puzzles
                    and next_piece.mutual_compatibility < self._new_board_mutual_compatibility):
                self._spawn_new_board()
            else:
                self._place_normal_piece(next_piece)

    def get_solved_puzzles(self):
        solved_puzzles = [[] for _ in range(self._actual_numb_puzzles)]
        unassigned_pieces = []
        for piece in self._pieces:
            if piece.puzzle_id is None:
                unassigned_pieces.append(piece)
            else:
                solved_puzzles[piece.puzzle_id].append(piece)
        return solved_puzzles, unassigned_pieces

    # ---------------------------------------------------------------- placement
    def _place_normal_piece(self, info: NextPieceToPlace):
        puzzle_id = info.puzzle_id
        next_piece = self._pieces[info.next_piece_id]
        neighbor_piece = self._pieces[info.neighbor_piece_id]

        next_piece.set_placed_piece_rotation(info.next_piece_side,
                                             info.neighbor_piece_side,
                                             neighbor_piece.rotation)
        next_piece.puzzle_id = puzzle_id
        next_piece.location = info.open_slot_location

        self._updated_puzzle_dimensions(puzzle_id, next_piece.location)
        self._piece_locations[puzzle_id][next_piece.location] = True
        self._mark_piece_placed(next_piece.id_number)
        self._remove_open_slot(puzzle_id, next_piece.location)
        if info.is_best_buddy:
            del self._best_buddies_pool[str(next_piece.id_number)]

        self._add_best_buddies_to_pool(next_piece.id_number)
        self._update_open_slots(next_piece)

    def _find_next_piece(self) -> NextPieceToPlace:
        if len(self._best_buddies_pool) > 0:
            while True:
                neg_compat, _cnt, payload = heapq.heappop(self._best_buddy_open_slot_heap)
                (bb_id, bb_side, neighbor_id, neighbor_side, puzzle_id, location) = payload
                if not self._piece_placed[bb_id] and self._is_slot_open(puzzle_id, location):
                    return NextPieceToPlace(puzzle_id, location, bb_id, bb_side,
                                            neighbor_id, neighbor_side, -neg_compat, True)
        # BB pool dry: recalculate over remaining pieces then argmax over
        # (unplaced piece) x (open slot).
        placed_and_open = list(self._piece_placed)
        for open_location in self._open_locations:
            placed_and_open[open_location.piece_id] = False
        self._engine.recalculate_remaining_piece_compatibilities(
            self._piece_placed, placed_and_open)
        unplaced = [i for i in range(len(self._pieces)) if not self._piece_placed[i]]
        return self._get_next_piece_from_pool(unplaced)

    def _get_next_piece_from_pool(self, unplaced_pieces: Sequence[int]) -> NextPieceToPlace:
        """Vectorized exhaustive scoring of unplaced pieces against open
        slots (replaces the triple loop of solver.py:456-499)."""
        best = None
        unplaced = np.asarray(unplaced_pieces)
        for open_slot in self._open_locations:
            if not self._is_slot_open(open_slot.puzzle_id, open_slot.location):
                continue
            neighbor_id = open_slot.piece_id
            neighbor_side = open_slot.open_side
            for next_side in self._engine.get_valid_neighbor_sides(
                    self._puzzle_type, neighbor_side):
                # mutual_compat(next_piece, next_side, neighbor, neighbor_side)
                compats = self._engine.mutual_for_slot(
                    next_side, neighbor_id, neighbor_side)[unplaced]
                k = int(np.argmax(compats))
                if best is None or compats[k] > best.mutual_compatibility:
                    best = NextPieceToPlace(open_slot.puzzle_id, open_slot.location,
                                            int(unplaced[k]), next_side,
                                            neighbor_id, neighbor_side,
                                            float(compats[k]), False)
        return best

    # ---------------------------------------------------------------- slots
    def _is_slot_open(self, puzzle_id, location):
        return (not self._piece_locations[puzzle_id][location]
                and self._check_board_dimensions(puzzle_id, location))

    def _check_board_dimensions(self, puzzle_id, location):
        actual = self._actual_puzzle_dimensions
        if actual is None:
            return True
        dims = self._placed_puzzle_dimensions[puzzle_id]
        for d in range(len(actual)):
            if location[d] - dims.top_left[d] + 1 > actual[d]:
                return False
            if dims.bottom_right[d] - location[d] + 1 > actual[d]:
                return False
        return True

    def _remove_open_slot(self, puzzle_id, location):
        self._open_locations = [
            s for s in self._open_locations
            if not (s.puzzle_id == puzzle_id and s.location == location)
        ]

    def _update_open_slots(self, placed_piece: PuzzlePiece):
        piece_id = placed_piece.id_number
        puzzle_id = placed_piece.puzzle_id
        for location, piece_side in placed_piece.get_neighbor_locations_and_sides():
            if self._is_slot_open(puzzle_id, location):
                self._open_locations.append(
                    PuzzleOpenSlot(puzzle_id, location, piece_id, piece_side))
                for bb_id in list(self._best_buddies_pool.values()):
                    for bb_side in self._engine.get_valid_neighbor_sides(
                            self._puzzle_type, piece_side):
                        compat = self._engine.mutual_compatibility(
                            piece_id, piece_side, bb_id, bb_side)
                        self._heap_push(bb_id, bb_side, piece_id, piece_side,
                                        puzzle_id, location, compat)

    def _heap_push(self, bb_id, bb_side, neighbor_id, neighbor_side, puzzle_id,
                   location, compat):
        heapq.heappush(self._best_buddy_open_slot_heap,
                       (-compat, next(self._heap_counter),
                        (bb_id, bb_side, neighbor_id, neighbor_side,
                         puzzle_id, location)))

    # ---------------------------------------------------------------- boards
    def _spawn_new_board(self):
        self._best_buddies_pool = {}
        self._best_buddy_open_slot_heap = []
        self._place_seed_piece()

    def _place_seed_piece(self):
        self._numb_puzzles += 1
        seed_piece_id = self._engine.next_starting_piece(self._piece_placed)
        seed = self._pieces[seed_piece_id]
        self._mark_piece_placed(seed_piece_id)
        seed.puzzle_id = self._numb_puzzles - 1

        # the native core's board: (2N + 3)^2 with the seed at its centre,
        # so that a chain of all N pieces stays on it in every direction
        # (the JAX package's N x N board lets a chain run off its edge)
        n = len(self._pieces)
        board = np.zeros((2 * n + 3, 2 * n + 3), dtype=bool)
        self._piece_locations.append(board)

        board_center = (n + 1, n + 1)
        seed.location = board_center
        seed.rotation = PuzzlePieceRotation.degree_0
        board[board_center] = True

        self._placed_puzzle_dimensions.append(
            PuzzleDimensions(seed.puzzle_id, board_center))
        self._add_best_buddies_to_pool(seed.id_number)
        self._update_open_slots(seed)

    def _updated_puzzle_dimensions(self, puzzle_id, placed_piece_location):
        dims = self._placed_puzzle_dimensions[puzzle_id]
        if PaikinTalSolver._PERFORM_ASSERTION_CHECK:
            assert (dims.top_left[0] <= dims.bottom_right[0]
                    and dims.top_left[1] <= dims.bottom_right[1])
        changed = False
        for d in range(len(dims.top_left)):
            if dims.top_left[d] > placed_piece_location[d]:
                dims.top_left[d] = placed_piece_location[d]
                changed = True
            elif dims.bottom_right[d] < placed_piece_location[d]:
                dims.bottom_right[d] = placed_piece_location[d]
                changed = True
        if changed:
            dims.update_dimensions()
            self._placed_puzzle_dimensions[puzzle_id] = dims

    def _mark_piece_placed(self, piece_id):
        self._piece_placed[piece_id] = True
        self._numb_unplaced_pieces -= 1

    def _add_best_buddies_to_pool(self, piece_id):
        for p_i_side in PuzzlePieceSide.get_all_sides():
            for bb in self._engine.best_buddies(piece_id, p_i_side):
                bb_id = bb[0]
                key = str(bb_id)
                if self._piece_placed[bb_id] or key in self._best_buddies_pool:
                    continue
                self._best_buddies_pool[key] = bb_id
                for open_slot_info in self._open_locations:
                    for bb_side in self._engine.get_valid_neighbor_sides(
                            self._puzzle_type, open_slot_info.open_side):
                        compat = self._engine.mutual_compatibility(
                            bb_id, bb_side, open_slot_info.piece_id,
                            open_slot_info.open_side)
                        self._heap_push(bb_id, bb_side, open_slot_info.piece_id,
                                        open_slot_info.open_side,
                                        open_slot_info.puzzle_id,
                                        open_slot_info.location, compat)

    @property
    def puzzle_type(self):
        return self._puzzle_type
