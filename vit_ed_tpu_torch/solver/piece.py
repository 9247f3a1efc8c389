"""Puzzle piece primitives: sides, rotations, and the piece object.

Re-creates the semantics of the reference's paikin_tal_solver/puzzle_piece.py
(side/rotation algebra, ground-truth neighbor ids, border pixel extraction,
classical extrapolation distance) with numpy. The all-pairs classical
distance lives in solver/distance.py as a single vectorized computation.
The port's copy of ``vit_ed_tpu/solver/piece.py``; the LAB -> BGR
conversion is ``color.lab2bgr_u8`` (OpenCV's, without OpenCV).
"""

from __future__ import annotations

import random
from enum import Enum
from typing import Optional, Tuple

import numpy as np

from .color import lab2bgr_u8


class Location:
    def __init__(self, coord):
        (row, column) = coord
        self.row = row
        self.column = column


class PuzzlePieceRotation(Enum):
    """90-degree step rotations (puzzle_piece.py:25-65)."""

    degree_0 = 0
    degree_90 = 90
    degree_180 = 180
    degree_270 = 270
    degree_360 = 360

    @staticmethod
    def all_rotations():
        return [PuzzlePieceRotation.degree_0, PuzzlePieceRotation.degree_90,
                PuzzlePieceRotation.degree_180, PuzzlePieceRotation.degree_270]

    @staticmethod
    def random_rotation():
        return random.choice(PuzzlePieceRotation.all_rotations())


class PuzzlePieceSide(Enum):
    """Sides clockwise from top (puzzle_piece.py:68-132)."""

    top = 0
    right = 1
    bottom = 2
    left = 3

    @staticmethod
    def get_numb_sides():
        return 4

    @staticmethod
    def get_all_sides():
        return [PuzzlePieceSide.top, PuzzlePieceSide.right,
                PuzzlePieceSide.bottom, PuzzlePieceSide.left]

    @property
    def complementary_side(self) -> "PuzzlePieceSide":
        return PuzzlePieceSide((self.value + 2) % 4)

    @property
    def side_name(self):
        return self.name


class PuzzlePiece:
    """A square LAB-image puzzle piece (puzzle_piece.py:135-242)."""

    NUMB_LAB_COLORSPACE_DIMENSIONS = 3
    _PERFORM_ASSERTION_CHECKS = True

    def __init__(self, puzzle_id: int, location: Tuple[int, int], lab_img: np.ndarray,
                 piece_id: Optional[int] = None, puzzle_grid_size=None):
        if piece_id is None and puzzle_grid_size is not None:
            raise ValueError('Using the puzzle grid size is not supported if piece id is "None".')

        self._piece_id = piece_id
        self.origin_piece_id = piece_id
        self._orig_piece_id = piece_id
        self._orig_puzzle_id = puzzle_id
        self._assigned_puzzle_id = None
        self._orig_loc = location
        self._assigned_loc = None

        self._img = lab_img
        (length, width, dim) = self._img.shape
        if width != length:
            raise ValueError("Only square puzzle pieces are supported at this time.")
        if dim != PuzzlePiece.NUMB_LAB_COLORSPACE_DIMENSIONS:
            raise ValueError("This image does not appear to be in the LAB colorspace "
                             "as it does not have 3 dimensions")
        self._width = width

        self._rotation = None
        self._actual_neighbor_ids = None
        if puzzle_grid_size is not None:
            self.calculate_actual_neighbor_id_numbers(puzzle_grid_size)

    # ---------------------------------------------------------------- ground truth
    def calculate_actual_neighbor_id_numbers(self, puzzle_grid_size):
        """Ground-truth neighbor ids from the original grid
        (puzzle_piece.py:189-242)."""
        if self._actual_neighbor_ids is not None:
            return
        (numb_rows, numb_cols) = puzzle_grid_size
        ids = []
        # top
        ids.append((None if self._orig_loc[0] == 0 else self._orig_piece_id - numb_cols,
                    PuzzlePieceSide.top))
        # right
        ids.append((None if self._orig_loc[1] + 1 == numb_cols else self._orig_piece_id + 1,
                    PuzzlePieceSide.right))
        # bottom
        ids.append((None if self._orig_loc[0] + 1 == numb_rows else self._orig_piece_id + numb_cols,
                    PuzzlePieceSide.bottom))
        # left
        ids.append((None if self._orig_loc[1] == 0 else self._orig_piece_id - 1,
                    PuzzlePieceSide.left))
        self._actual_neighbor_ids = tuple(ids)

    def is_correctly_placed(self, puzzle_offset_upper_left_location) -> bool:
        for i in range(len(self._orig_loc)):
            if self._assigned_loc[i] - self._orig_loc[i] - puzzle_offset_upper_left_location[i] != 0:
                return False
        return True

    def is_neighbor(self, piece: "PuzzlePiece", side: PuzzlePieceSide) -> bool:
        cur, oth = self._orig_loc, piece._orig_loc
        if side == PuzzlePieceSide.top:
            return cur[1] == oth[1] and cur[0] - oth[0] == 1
        if side == PuzzlePieceSide.bottom:
            return cur[1] == oth[1] and oth[0] - cur[0] == 1
        if side == PuzzlePieceSide.left:
            return cur[0] == oth[0] and cur[1] - oth[1] == 1
        if side == PuzzlePieceSide.right:
            return cur[0] == oth[0] and oth[1] - cur[1] == 1
        raise Exception(f"Side {side} does not exist!")

    # ---------------------------------------------------------------- accessors
    @property
    def original_neighbor_id_numbers_and_sides(self):
        assert self._actual_neighbor_ids is not None
        return self._actual_neighbor_ids

    @property
    def original_puzzle_id(self):
        return self._orig_puzzle_id

    @property
    def original_piece_id(self):
        return self._orig_piece_id

    @property
    def width(self):
        return self._width

    @property
    def location(self):
        return self._assigned_loc

    @location.setter
    def location(self, new_loc):
        if len(new_loc) != 2:
            raise ValueError("Location of a puzzle piece must be a two dimensional tuple")
        self._assigned_loc = new_loc

    @property
    def puzzle_id(self):
        return self._assigned_puzzle_id

    @puzzle_id.setter
    def puzzle_id(self, new_puzzle_id):
        self._assigned_puzzle_id = new_puzzle_id

    @property
    def id_number(self):
        return self._piece_id

    @id_number.setter
    def id_number(self, new_piece_id):
        self._piece_id = new_piece_id

    @property
    def lab_image(self):
        return self._img

    @property
    def rotation(self):
        return self._rotation

    @rotation.setter
    def rotation(self, new_rotation):
        self._rotation = new_rotation

    def bgr_image(self):
        img = self._img
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        return lab2bgr_u8(img)

    # ---------------------------------------------------------------- pixels
    def get_row_pixels(self, row_numb: int, reverse: bool = False):
        if row_numb < 0 or row_numb >= self._width:
            raise ValueError("Row number out of bounds")
        return self._img[row_numb, ::-1, :] if reverse else self._img[row_numb, :, :]

    def get_column_pixels(self, col_numb: int, reverse: bool = False):
        if col_numb < 0 or col_numb >= self._width:
            raise ValueError("Column number out of bounds")
        return self._img[::-1, col_numb, :] if reverse else self._img[:, col_numb, :]

    @staticmethod
    def calculate_asymmetric_distance(piece_i: "PuzzlePiece", piece_i_side: PuzzlePieceSide,
                                      piece_j: "PuzzlePiece", piece_j_side: PuzzlePieceSide):
        """Classical border-extrapolation distance
        (puzzle_piece.py:534-609): predict piece_j's border as
        2*border_i - second_to_last_i and sum absolute differences."""
        if piece_i_side == PuzzlePieceSide.top:
            i_border = piece_i.get_row_pixels(0)
            i_second_to_last = piece_i.get_row_pixels(1)
        elif piece_i_side == PuzzlePieceSide.right:
            i_border = piece_i.get_column_pixels(piece_i.width - 1)
            i_second_to_last = piece_i.get_column_pixels(piece_i.width - 2)
        elif piece_i_side == PuzzlePieceSide.bottom:
            i_border = piece_i.get_row_pixels(piece_i.width - 1)
            i_second_to_last = piece_i.get_row_pixels(piece_i.width - 2)
        elif piece_i_side == PuzzlePieceSide.left:
            i_border = piece_i.get_column_pixels(0)
            i_second_to_last = piece_i.get_column_pixels(1)
        else:
            raise ValueError("Invalid edge for piece i")

        reverse = piece_i_side == piece_j_side
        if piece_j_side == PuzzlePieceSide.top:
            if piece_i_side == PuzzlePieceSide.right:
                reverse = True
            j_border = piece_j.get_row_pixels(0, reverse)
        elif piece_j_side == PuzzlePieceSide.right:
            if piece_i_side == PuzzlePieceSide.top:
                reverse = True
            j_border = piece_j.get_column_pixels(piece_i.width - 1, reverse)
        elif piece_j_side == PuzzlePieceSide.bottom:
            if piece_i_side == PuzzlePieceSide.left:
                reverse = True
            j_border = piece_j.get_row_pixels(piece_i.width - 1, reverse)
        elif piece_j_side == PuzzlePieceSide.left:
            if piece_i_side == PuzzlePieceSide.bottom:
                reverse = True
            j_border = piece_j.get_column_pixels(0, reverse)
        else:
            raise ValueError("Invalid edge for piece j")

        predicted_j = 2 * i_border.astype(np.int16) - i_second_to_last.astype(np.int16)
        pixel_diff = predicted_j.astype(np.int16) - j_border.astype(np.int16)
        return int(np.sum(np.absolute(pixel_diff), dtype=np.int32))

    # ---------------------------------------------------------------- rotation algebra
    def set_placed_piece_rotation(self, placed_side: PuzzlePieceSide,
                                  neighbor_piece_side: PuzzlePieceSide,
                                  neighbor_piece_rotation: PuzzlePieceRotation):
        self.rotation = PuzzlePiece._calculate_placed_piece_rotation(
            placed_side, neighbor_piece_side, neighbor_piece_rotation)

    @staticmethod
    def _calculate_placed_piece_rotation(placed_piece_side: PuzzlePieceSide,
                                         neighbor_piece_side: PuzzlePieceSide,
                                         neighbor_piece_rotation: PuzzlePieceRotation):
        """puzzle_piece.py:630-660."""
        unrotated_complement = neighbor_piece_side.complementary_side
        placed_rotation_val = int(neighbor_piece_rotation.value)
        placed_rotation_val += 90 * (PuzzlePieceRotation.degree_360.value // 90
                                     + (unrotated_complement.value - placed_piece_side.value))
        placed_rotation_val %= PuzzlePieceRotation.degree_360.value
        if PuzzlePiece._PERFORM_ASSERTION_CHECKS:
            assert placed_rotation_val % 90 == 0
        return PuzzlePieceRotation(placed_rotation_val % PuzzlePieceRotation.degree_360.value)

    @staticmethod
    def _determine_unrotated_side(piece_rotation: PuzzlePieceRotation,
                                  rotated_side: PuzzlePieceSide):
        """puzzle_piece.py:662-685."""
        numb_90 = int(piece_rotation.value / 90)
        unrotated = (rotated_side.value + (4 - numb_90)) % 4
        return PuzzlePieceSide(unrotated)

    def get_neighbor_locations_and_sides(self):
        if PuzzlePiece._PERFORM_ASSERTION_CHECKS:
            assert self.location is not None
            assert self.rotation is not None
        return PuzzlePiece._get_neighbor_locations_and_sides(self.location, self.rotation)

    @staticmethod
    def _get_neighbor_locations_and_sides(piece_loc, piece_rotation):
        """puzzle_piece.py:445-481."""
        locs = [
            ((piece_loc[0] - 1, piece_loc[1]), PuzzlePieceSide.top),
            ((piece_loc[0], piece_loc[1] + 1), PuzzlePieceSide.right),
            ((piece_loc[0] + 1, piece_loc[1]), PuzzlePieceSide.bottom),
            ((piece_loc[0], piece_loc[1] - 1), PuzzlePieceSide.left),
        ]
        return [(loc, PuzzlePiece._determine_unrotated_side(piece_rotation, side))
                for loc, side in locs]

    @staticmethod
    def _get_neighbor_piece_rotated_side(placed_piece_loc, neighbor_piece_loc):
        """puzzle_piece.py:687-717."""
        row_dist = placed_piece_loc[0] - neighbor_piece_loc[0]
        col_dist = placed_piece_loc[1] - neighbor_piece_loc[1]
        if PuzzlePiece._PERFORM_ASSERTION_CHECKS:
            assert abs(row_dist) + abs(col_dist) == 1
        if row_dist == -1:
            return PuzzlePieceSide.top
        if row_dist == 1:
            return PuzzlePieceSide.bottom
        if col_dist == -1:
            return PuzzlePieceSide.left
        return PuzzlePieceSide.right
