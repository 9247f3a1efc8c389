"""Puzzle import, reconstruction, and accuracy metrics.

Re-creates the reference's paikin_tal_solver/puzzle_importer.py (1861 LoC)
— image-to-pieces with erosion, reconstruction with wrong-placement
marking, standard/modified direct accuracy (BFS over candidate upper-left
origins), modified neighbor accuracy, results aggregation, and the
closed-form PuzzleTester fixture.

The port's copy of ``vit_ed_tpu/solver/importer.py``: image reading, the
LAB conversions, padding and writing go through ``color`` (OpenCV's
functions without OpenCV).
"""

from __future__ import annotations

import copy
import math
import os
import random
from enum import Enum
from typing import List, Optional

import numpy as np

from .color import bgr2lab_u8, imread_bgr, imwrite, pad_constant
from .piece import PuzzlePiece, PuzzlePieceRotation, PuzzlePieceSide


class PuzzleType(Enum):
    """type1: no rotation; type2: 90-degree rotations allowed."""

    type1 = 1
    type2 = 2


class ImageColor(Enum):
    black = 1


class PuzzleSolver(Enum):
    PaikinTal = "paikin_tal"
    MultiPuzzle = "multipuzzle"


class DirectAccuracyResultType(Enum):
    AccuracyScore = 1
    DifferentPuzzleScore = 2
    WrongRotationScore = 3
    WrongLocationScore = 4
    MissingPieceScore = 5


class ResultAccuracyMetric(Enum):
    StandardDirectAccuracy = 1
    ModifiedDirectAccuracy = 2
    ModifiedNeighborAccuracy = 3


class PieceDirectAccuracyResult(Enum):
    """BGR marker colors (puzzle_importer.py:1151-1159)."""

    different_puzzle = (255, 0, 0)
    correct_placement = (0, 204, 0)
    wrong_location = (0, 0, 255)
    wrong_rotation = (51, 153, 255)


class PieceSideNeighborAccuracyResult(Enum):
    correct_neighbor = (0, 204, 0)
    wrong_neighbor = (0, 0, 255)
    different_puzzle_id = (255, 0, 0)


class PieceSideBestBuddyAccuracyResult(Enum):
    """puzzle_importer.py:38-47."""

    wrong_best_buddy = (0, 0, 255)
    correct_best_buddy = (0, 204, 0)
    open_best_buddy = (255, 0, 0)
    no_best_buddy = (255, 255, 255)


class Puzzle:
    """A jigsaw puzzle: image -> grid of eroded LAB pieces
    (puzzle_importer.py:82-232)."""

    print_debug_messages = True
    DEFAULT_PIECE_WIDTH = 25
    NUMBER_BGR_DIMENSIONS = 3

    def __init__(self, id_number: int, image_filename: Optional[str] = None,
                 piece_width: Optional[int] = None, starting_piece_id: int = 0,
                 erosion: float = 0):
        self._id = id_number
        self._img = None
        self._img_LAB = None
        self._grid_size = None
        self._piece_width = piece_width if piece_width is not None else Puzzle.DEFAULT_PIECE_WIDTH
        self._erosion = erosion
        self._img_width = None
        self._img_height = None
        self._pieces: List[PuzzlePiece] = []
        # (piece_id, side, buddy_id, buddy_side) tuples attached by the
        # solver driver for the best-buddy accuracy metric
        self.best_buddy_pairs = None

        if image_filename is None:
            self._filename = ""
            return
        self._filename = image_filename
        self._load_puzzle_image()
        self.make_pieces(starting_piece_id)

    def _load_puzzle_image(self):
        if not os.path.exists(self._filename):
            raise ValueError(f'Invalid "{self._filename}" value.  File does not exist')
        self._img = imread_bgr(self._filename)  # BGR
        if self._img is None:
            raise IOError(f'Unable to load the image at "{self._filename}".')
        self._img_height, self._img_width = self._img.shape[:2]
        self._img_LAB = bgr2lab_u8(self._img)

    def make_pieces(self, starting_id_numb=0):
        """Cut the image into a grid of eroded LAB pieces.

        One strided reshape does the whole grid at once — [rows, w, cols,
        w, 3] -> [rows, cols, w, w, 3] — and the erosion centre-crop of
        every cell is a single slice of that view (semantics of the
        reference's per-piece subimage loop, puzzle_importer.py:182-232:
        floor grid, centre-shave the remainder, per-cell centre-crop to
        ceil(w * (1 - erosion)) with round-half-even offsets)."""
        w = self.piece_width
        rows = self._img_height // w
        cols = self._img_width // w
        if rows == 0 or cols == 0:
            raise ValueError(
                f"piece width {w} exceeds the {self._img_height}x"
                f"{self._img_width} image: no pieces can be cut")
        self._grid_size = (rows, cols)

        # centre-shave the division remainder so the grid tiles exactly
        top = (self._img_height - rows * w) // 2
        left = (self._img_width - cols * w) // 2
        self._img_height, self._img_width = rows * w, cols * w
        self._img = self._img[top:top + rows * w, left:left + cols * w]
        self._img_LAB = self._img_LAB[top:top + rows * w, left:left + cols * w]

        grid = self._img_LAB.reshape(rows, w, cols, w, 3).swapaxes(1, 2)
        eroded = math.ceil(w * (1 - self._erosion))
        off = int(round((w - eroded) / 2.0))   # centre_crop's rounding
        cells = grid[:, :, off:off + eroded, off:off + eroded]
        self._pieces = [
            PuzzlePiece(self._id, (r, c), np.ascontiguousarray(cells[r, c]),
                        piece_id=starting_id_numb + r * cols + c,
                        puzzle_grid_size=self._grid_size)
            for r in range(rows) for c in range(cols)]

    # ------------------------------------------------------------- accessors
    @property
    def id_number(self):
        return self._id

    @property
    def pieces(self):
        return self._pieces

    @property
    def piece_width(self):
        return self._piece_width

    @property
    def grid_size(self):
        return self._grid_size

    # ------------------------------------------------------------ reconstruct
    def build_placed_piece_info(self):
        """[grid] matrices of original piece id and rotation per placed
        location; -1 where empty (puzzle_importer.py:158-180)."""
        placed_piece_matrix = np.full(self._grid_size, -1, np.int32)
        placed_piece_rotation = np.full(self._grid_size, -1, np.int32)
        for piece in self._pieces:
            placed_piece_matrix[piece.location] = piece.original_piece_id
            placed_piece_rotation[piece.location] = piece.rotation.value
        return placed_piece_matrix, placed_piece_rotation

    @staticmethod
    def reconstruct_from_pieces(pieces, piece_width, id_numb=-1, display_image=False):
        """Assemble a board image from PLACED pieces: shift locations to a
        zero-based grid, paste each piece into its cell (wrong placements
        get the red ring marker), convert back to LAB (semantics of
        puzzle_importer.py:264-321)."""
        if not pieces:
            raise ValueError("a reconstructed puzzle needs at least one piece")

        board = Puzzle(id_numb)
        board._pieces = copy.deepcopy(pieces)
        board._piece_width = piece_width

        locs = np.asarray([p.location for p in board._pieces])
        origin = locs.min(axis=0)
        rows, cols = (locs.max(axis=0) - origin + 1)
        for piece, (r, c) in zip(board._pieces, locs - origin):
            piece.location = (int(r), int(c))

        board._grid_size = (int(rows), int(cols))
        board._img_height = int(rows) * piece_width
        board._img_width = int(cols) * piece_width
        board._img = np.zeros((board._img_height, board._img_width,
                               Puzzle.NUMBER_BGR_DIMENSIONS), np.uint8)
        for piece in board._pieces:
            board.insert_piece_into_image(piece, (piece_width - piece.width) // 2)
        board._img_LAB = bgr2lab_u8(board._img)
        return board

    def randomize_puzzle_piece_locations(self):
        all_locations = [p.location for p in self._pieces]
        random.shuffle(all_locations)
        for i, piece in enumerate(self._pieces):
            piece.location = all_locations[i]

    def randomize_puzzle_piece_rotations(self):
        for piece in self._pieces:
            piece.rotation = PuzzlePieceRotation.random_rotation()

    def get_min_and_max_row_and_columns(self):
        locs = np.asarray([p.location for p in self._pieces])
        return (int(locs[:, 0].min()), int(locs[:, 0].max()),
                int(locs[:, 1].min()), int(locs[:, 1].max()))

    @staticmethod
    def create_solid_bgr_image(size, color):
        return np.zeros((size[0], size[1], Puzzle.NUMBER_BGR_DIMENSIONS), np.uint8)

    @staticmethod
    def extract_subimage(img, upper_left, size):
        r, c = upper_left
        return img[r:r + size[0], c:c + size[1], :]

    @staticmethod
    def centre_crop(img, dim):
        """Centre crop to (width, height) = ``dim``, bounded by the image,
        with round-half-even offsets (the reference convention the erosion
        geometry depends on)."""
        out_w = min(dim[0], img.shape[1])
        out_h = min(dim[1], img.shape[0])
        top = int(round((img.shape[0] - out_h) / 2.0))
        left = int(round((img.shape[1] - out_w) / 2.0))
        return img[top:top + out_h, left:left + out_w, :]

    def insert_piece_into_image(self, piece: PuzzlePiece, pad_size=0):
        """Paste one piece into its grid cell. A wrongly placed piece gets
        a 1px red ring first (and is cropped back to the cell when erosion
        left no padding room) — the reference's marker scheme
        (puzzle_importer.py:448-473)."""
        bgr = piece.bgr_image()
        if piece.is_correctly_placed((0, 0)):
            p = pad_size
            bgr = pad_constant(bgr, p, p, p, p)
        else:
            bgr = pad_constant(bgr, 1, 1, 1, 1, value=[0, 0, 255])
            p = max(pad_size - 1, 0)
            bgr = pad_constant(bgr, p, p, p, p)
            if bgr.shape[0] > self._piece_width:
                bgr = Puzzle.centre_crop(bgr, (self._piece_width,
                                               self._piece_width))
        turns = 0 if piece.rotation is None else piece.rotation.value // 90
        if turns:
            bgr = np.rot90(bgr, turns)
        cell = (piece.location[0] * self._piece_width,
                piece.location[1] * self._piece_width)
        Puzzle.insert_subimage(self._img, cell, bgr)

    @staticmethod
    def insert_subimage(master_img, upper_left, subimage):
        r, c = upper_left
        h, w = subimage.shape[:2]
        if r < 0 or c < 0:
            raise ValueError("subimage upper-left must be on the board (>= 0)")
        assert master_img.shape[0] >= r + h and master_img.shape[1] >= c + w
        master_img[r:r + h, c:c + w, :] = subimage

    def save_to_file(self, filename):
        imwrite(filename, self._img)

    def build_direct_accuracy_image(self, direct_acc, filename=None):
        """Render the solved board with each piece framed in its
        direct-accuracy result color (green correct / red wrong location /
        orange wrong rotation / blue different puzzle — the color table at
        puzzle_importer.py:1151-1159 used by the reference's accuracy image
        output)."""
        size = (self._grid_size[0] * self._piece_width,
                self._grid_size[1] * self._piece_width)
        img = Puzzle.create_solid_bgr_image(size, ImageColor.black)
        for piece in self._pieces:
            result = direct_acc.get_piece_result(piece.id_number)
            color = np.asarray(result.value, np.uint8)
            piece_bgr = piece.bgr_image().copy()
            # paint the marker border inside the piece so zero-erosion
            # pieces keep it after fitting into the cell
            piece_bgr[:2] = color
            piece_bgr[-2:] = color
            piece_bgr[:, :2] = color
            piece_bgr[:, -2:] = color
            if piece_bgr.shape[0] < self._piece_width:
                p0 = (self._piece_width - piece_bgr.shape[0] + 1) // 2
                p1 = (self._piece_width - piece_bgr.shape[1] + 1) // 2
                piece_bgr = pad_constant(
                    piece_bgr, p0, self._piece_width - piece_bgr.shape[0] - p0,
                    p1, self._piece_width - piece_bgr.shape[1] - p1)
            if piece.rotation is not None and piece.rotation != PuzzlePieceRotation.degree_0:
                piece_bgr = np.rot90(piece_bgr, piece.rotation.value // 90)
            upper_left = (piece.location[0] * self._piece_width,
                          piece.location[1] * self._piece_width)
            Puzzle.insert_subimage(img, upper_left, piece_bgr)
        if filename is not None:
            imwrite(filename, img)
        return img

    # ------------------------------------------------------------ accuracies
    def determine_standard_direct_accuracy(self, expected_puzzle_id,
                                           numb_pieces_in_original_puzzle):
        return self.determine_modified_direct_accuracy(expected_puzzle_id, (0, 0),
                                                       numb_pieces_in_original_puzzle)

    def determine_modified_direct_accuracy(self, expected_puzzle_id, upper_left,
                                           numb_pieces_in_original_puzzle):
        """Classify every placed piece at one assumed upper-left origin.

        Three predicate arrays (same puzzle / at the offset location /
        unrotated) are gathered in one pass and combined into a flat code
        array (semantics of the reference's per-piece if/elif chain,
        puzzle_importer.py:558-598)."""
        n = len(self._pieces)
        ids = np.fromiter((p.id_number for p in self._pieces), np.int64, n)
        same_puzzle = np.fromiter(
            (p.original_puzzle_id == expected_puzzle_id for p in self._pieces),
            bool, n)
        at_origin_offset = np.fromiter(
            (p.is_correctly_placed(upper_left) for p in self._pieces), bool, n)
        unrotated = np.fromiter(
            (p.rotation == PuzzlePieceRotation.degree_0 for p in self._pieces),
            bool, n)
        R = DirectAccuracyPuzzleResults
        codes = np.select(
            [~same_puzzle, ~at_origin_offset, ~unrotated],
            [R.DIFFERENT_PUZZLE, R.WRONG_LOCATION, R.WRONG_ROTATION],
            default=R.CORRECT)
        return DirectAccuracyPuzzleResults(expected_puzzle_id, self.id_number,
                                           numb_pieces_in_original_puzzle,
                                           piece_ids=ids, codes=codes)


class DirectAccuracyPuzzleResults:
    """Per-piece direct-accuracy classification for one (original puzzle,
    solved puzzle, origin) triple.

    The reference spreads the classification over four str-keyed dicts and
    counts their lengths (puzzle_importer.py:1162-1383); here it is one
    flat int code array aligned with the piece ids, every count a
    vectorized reduction over it.
    """

    CORRECT, WRONG_ROTATION, WRONG_LOCATION, DIFFERENT_PUZZLE = range(4)
    _ENUM_BY_CODE = (PieceDirectAccuracyResult.correct_placement,
                     PieceDirectAccuracyResult.wrong_rotation,
                     PieceDirectAccuracyResult.wrong_location,
                     PieceDirectAccuracyResult.different_puzzle)

    def __init__(self, original_puzzle_id, solved_puzzle_id,
                 numb_pieces_in_original_puzzle, piece_ids=None, codes=None):
        self._orig_puzzle_id = original_puzzle_id
        self._solved_puzzle_id = solved_puzzle_id
        self.numb_pieces_in_original_puzzle = numb_pieces_in_original_puzzle
        self._piece_ids = (np.zeros(0, np.int64) if piece_ids is None
                           else np.asarray(piece_ids, np.int64))
        self._codes = (np.zeros(0, np.int64) if codes is None
                       else np.asarray(codes, np.int64))
        self._code_of = {int(i): int(c)
                         for i, c in zip(self._piece_ids, self._codes)}

    def get_piece_result(self, piece_id):
        code = self._code_of.get(int(piece_id))
        if code is None:
            raise ValueError(f'Piece id: "{piece_id}" does not exist in '
                             f"this result set.")
        return self._ENUM_BY_CODE[code]

    def _count(self, code):
        return int(np.count_nonzero(self._codes == code))

    @property
    def original_puzzle_id(self):
        return self._orig_puzzle_id

    @property
    def solved_puzzle_id(self):
        return self._solved_puzzle_id

    @property
    def numb_correct_placements(self):
        return self._count(self.CORRECT)

    @property
    def numb_wrong_location(self):
        return self._count(self.WRONG_LOCATION)

    @property
    def numb_wrong_rotation(self):
        return self._count(self.WRONG_ROTATION)

    @property
    def numb_different_puzzle(self):
        return self._count(self.DIFFERENT_PUZZLE)

    @property
    def weighted_accuracy(self):
        return self.numb_correct_placements / (
            self.numb_pieces_in_original_puzzle + self.numb_different_puzzle)

    @property
    def numb_pieces_from_original_puzzle_in_solved_puzzle(self):
        return len(self._codes) - self.numb_different_puzzle

    @property
    def total_numb_pieces_in_solved_puzzle(self):
        return len(self._codes)

    @staticmethod
    def check_if_update_direct_accuracy(current_best, new):
        """new wins on strictly higher weighted accuracy, or on more
        included original-puzzle pieces at equal accuracy."""
        if current_best is None:
            return True
        if current_best.weighted_accuracy != new.weighted_accuracy:
            return current_best.weighted_accuracy < new.weighted_accuracy
        return (current_best.numb_pieces_from_original_puzzle_in_solved_puzzle
                < new.numb_pieces_from_original_puzzle_in_solved_puzzle)


class ModifiedNeighborAccuracy:
    """Per-(piece, side) neighbor-accuracy classification.

    One ``{(piece_id, side_value): result}`` record replaces the
    reference's three str-keyed dicts (puzzle_importer.py:1386-1627);
    the per-class counts are tallied as records land.
    """

    def __init__(self, original_puzzle_id, solved_puzzle_id, number_of_pieces):
        self._original_puzzle_id = original_puzzle_id
        self._solved_puzzle_id = solved_puzzle_id
        self._actual_number_of_pieces = number_of_pieces
        self._records = {}
        self._tally = {r: 0 for r in PieceSideNeighborAccuracyResult}

    def _record(self, piece_id, side, result):
        self._records[(piece_id, side.value)] = result
        self._tally[result] += 1

    def get_piece_side_result(self, piece_id, side):
        result = self._records.get((piece_id, side.value))
        if result is None:
            raise ValueError(f'Pairing of piece id "{piece_id}" and side '
                             f'"{side.side_name}" does not exist in this puzzle')
        return result

    def add_wrong_puzzle_id(self, piece_id, side):
        self._record(piece_id, side,
                     PieceSideNeighborAccuracyResult.different_puzzle_id)

    def add_correct_neighbor(self, piece_id, side):
        self._record(piece_id, side,
                     PieceSideNeighborAccuracyResult.correct_neighbor)

    def add_wrong_neighbor(self, piece_id, side):
        self._record(piece_id, side,
                     PieceSideNeighborAccuracyResult.wrong_neighbor)

    @property
    def wrong_puzzle_id(self):
        return self._tally[PieceSideNeighborAccuracyResult.different_puzzle_id]

    @property
    def correct_neighbor_count(self):
        return self._tally[PieceSideNeighborAccuracyResult.correct_neighbor]

    @property
    def wrong_neighbor_count(self):
        return self._tally[PieceSideNeighborAccuracyResult.wrong_neighbor]

    @property
    def original_puzzle_id(self):
        return self._original_puzzle_id

    @property
    def solved_puzzle_id(self):
        return self._solved_puzzle_id

    @property
    def numb_pieces_in_original_puzzle(self):
        return self._actual_number_of_pieces

    @property
    def numb_pieces_from_original_puzzle_in_solved_puzzle(self):
        # sides are recorded per piece, so pieces = side records / 4
        return ((self.correct_neighbor_count + self.wrong_neighbor_count)
                / PuzzlePieceSide.get_numb_sides())

    @property
    def total_numb_pieces_in_solved_puzzle(self):
        return (self.numb_pieces_from_original_puzzle_in_solved_puzzle
                + self.wrong_puzzle_id)

    @property
    def weighted_accuracy(self):
        denom = ((self._actual_number_of_pieces + self.wrong_puzzle_id)
                 * PuzzlePieceSide.get_numb_sides())
        return self.correct_neighbor_count / denom

    @staticmethod
    def check_if_update_neighbor_accuracy(current_best, new):
        """new wins on strictly higher weighted accuracy, or on more
        correct sides at equal accuracy."""
        if current_best is None:
            return True
        if current_best.weighted_accuracy != new.weighted_accuracy:
            return current_best.weighted_accuracy < new.weighted_accuracy
        return current_best.correct_neighbor_count < new.correct_neighbor_count


class BestBuddyAccuracy:
    """Best-buddy accuracy for one solved puzzle (puzzle_importer.py:1630+).

    Each (piece, side) best-buddy relation is classified: CORRECT when the
    best buddy is the piece's actual original neighbor on that side, WRONG
    otherwise, OPEN when the partner was never placed into this puzzle, and
    EXCLUDED for pieces outside the scored region.
    """

    # the 'excluded' class is bookkept but never counted toward accuracy
    _EXCLUDED = "excluded"

    def __init__(self, puzzle_id):
        self.puzzle_id = puzzle_id
        self._records = {}

    def _set(self, piece_id, side, result):
        self._records[(piece_id, side.value)] = result

    def add_excluded_best_buddy(self, piece_id, side):
        self._set(piece_id, side, self._EXCLUDED)

    def add_open_best_buddy(self, piece_id, side):
        self._set(piece_id, side,
                  PieceSideBestBuddyAccuracyResult.open_best_buddy)

    def add_wrong_best_buddy(self, piece_id, side):
        self._set(piece_id, side,
                  PieceSideBestBuddyAccuracyResult.wrong_best_buddy)

    def add_correct_best_buddy(self, piece_id, side):
        self._set(piece_id, side,
                  PieceSideBestBuddyAccuracyResult.correct_best_buddy)

    def delete_open_best_buddy(self, piece_id, side):
        if self.exists_open_best_buddy(piece_id, side):
            del self._records[(piece_id, side.value)]

    def _is(self, piece_id, side, result):
        return self._records.get((piece_id, side.value)) is result

    def exists_open_best_buddy(self, piece_id, side):
        return self._is(piece_id, side,
                        PieceSideBestBuddyAccuracyResult.open_best_buddy)

    def exists_wrong_best_buddy(self, piece_id, side):
        return self._is(piece_id, side,
                        PieceSideBestBuddyAccuracyResult.wrong_best_buddy)

    def exists_correct_best_buddy(self, piece_id, side):
        return self._is(piece_id, side,
                        PieceSideBestBuddyAccuracyResult.correct_best_buddy)

    def get_piece_side_result(self, piece_id, side):
        result = self._records.get((piece_id, side.value))
        if isinstance(result, PieceSideBestBuddyAccuracyResult):
            return result
        return PieceSideBestBuddyAccuracyResult.no_best_buddy

    def _count(self, result):
        return sum(1 for r in self._records.values() if r is result)

    @property
    def numb_open_best_buddies(self):
        return self._count(PieceSideBestBuddyAccuracyResult.open_best_buddy)

    @property
    def numb_wrong_best_buddies(self):
        return self._count(PieceSideBestBuddyAccuracyResult.wrong_best_buddy)

    @property
    def numb_correct_best_buddies(self):
        return self._count(PieceSideBestBuddyAccuracyResult.correct_best_buddy)

    @property
    def total_best_buddies(self):
        return (self.numb_open_best_buddies + self.numb_wrong_best_buddies
                + self.numb_correct_best_buddies)

    @property
    def accuracy(self):
        total = self.total_best_buddies
        return self.numb_correct_best_buddies / total if total else 0.0


class PuzzleResultsInformation:
    """Accuracy results for one original puzzle (puzzle_importer.py:846-1148)."""

    def __init__(self, puzzle_id, original_img_filename):
        self.original_id_number = puzzle_id
        self._numb_pieces = 0
        self._original_img_filename = original_img_filename
        self.standard_direct_accuracy = None
        self.modified_direct_accuracy = None
        self.modified_neighbor_accuracy = None
        self.best_buddy_accuracy = None

    def resolve_best_buddy_accuracy(self, solved_puzzle: Puzzle, best_buddy_pairs):
        """Classify engine best-buddy relations against ground truth.

        ``best_buddy_pairs``: iterable of (piece_id, side, buddy_id,
        buddy_side) in UNROTATED piece frames (the space the compatibility
        engine works in; see CompatibilityEngine.find_best_buddies).
        """
        info = BestBuddyAccuracy(solved_puzzle.id_number)
        by_id = {p.id_number: p for p in solved_puzzle.pieces}
        for piece_id, side, buddy_id, buddy_side in best_buddy_pairs:
            piece = by_id.get(piece_id)
            buddy = by_id.get(buddy_id)
            if piece is None or piece.original_puzzle_id != self.original_id_number:
                if piece is not None:
                    info.add_excluded_best_buddy(piece_id, side)
                continue
            if buddy is None:
                info.add_open_best_buddy(piece_id, side)
                continue
            expected = piece.original_neighbor_id_numbers_and_sides[side.value]
            correct = (expected[0] == buddy.original_piece_id
                       and buddy_side == side.complementary_side)
            if correct:
                info.add_correct_best_buddy(piece_id, side)
            else:
                info.add_wrong_best_buddy(piece_id, side)
        self.best_buddy_accuracy = info

    @property
    def numb_pieces(self):
        return self._numb_pieces

    @numb_pieces.setter
    def numb_pieces(self, value):
        self._numb_pieces = value

    @property
    def original_filename(self):
        return self._original_img_filename

    def resolve_neighbor_accuracies(self, solved_puzzle: Puzzle):
        """Neighbor accuracy for one solved puzzle.

        A (piece, side) is CORRECT when the board cell adjacent in the
        piece's rotated frame holds exactly its ground-truth neighbor with
        a matching rotation — or is empty/off-board for a ground-truth
        border side. Off-board and empty lookups collapse into ONE padded
        -1 ring around the placed/rotation matrices, so the per-side check
        is a single indexed comparison (semantics of the reference's
        bounds-checked walk, puzzle_importer.py:985-1058)."""
        placed, rotations = solved_puzzle.build_placed_piece_info()
        placed_pad = np.pad(placed, 1, constant_values=-1)
        rot_pad = np.pad(rotations, 1, constant_values=-1)
        info = ModifiedNeighborAccuracy(self.original_id_number,
                                        solved_puzzle.id_number,
                                        self.numb_pieces)

        for piece in solved_puzzle.pieces:
            if piece.original_puzzle_id != self.original_id_number:
                for side in PuzzlePieceSide.get_all_sides():
                    info.add_wrong_puzzle_id(piece.id_number, side)
                continue

            # adjacent board cell per UNROTATED side
            cell_of = {s.value: loc
                       for loc, s in piece.get_neighbor_locations_and_sides()}
            for expected_id, side in piece.original_neighbor_id_numbers_and_sides:
                r, c = cell_of[side.value]
                found_id = int(placed_pad[r + 1, c + 1])
                if expected_id is None:
                    ok = found_id == -1
                else:
                    ok = (found_id == expected_id
                          and piece.rotation.value == rot_pad[r + 1, c + 1])
                (info.add_correct_neighbor if ok
                 else info.add_wrong_neighbor)(piece.id_number, side)

        if ModifiedNeighborAccuracy.check_if_update_neighbor_accuracy(
                self.modified_neighbor_accuracy, info):
            self.modified_neighbor_accuracy = info

    def resolve_direct_accuracies(self, puzzle: Puzzle):
        """puzzle_importer.py:1060-1137."""
        new_direct = puzzle.determine_standard_direct_accuracy(self.original_id_number,
                                                               self.numb_pieces)
        if DirectAccuracyPuzzleResults.check_if_update_direct_accuracy(
                self.standard_direct_accuracy, new_direct):
            self.standard_direct_accuracy = new_direct
        self._resolve_modified_direct_accuracy(puzzle)

    def _resolve_modified_direct_accuracy(self, puzzle: Puzzle):
        """Modified direct accuracy: try every candidate upper-left origin.

        The candidate set is every grid location whose Manhattan distance
        from (0, 0) is at most that of the NEAREST placed piece — computed
        here in closed form with one mask (the reference enumerates the
        identical set with an explicit down/right BFS from the corner,
        puzzle_importer.py:1081-1137)."""
        placed_piece_matrix, _ = puzzle.build_placed_piece_info()
        rr, cc = np.nonzero(placed_piece_matrix != -1)
        if rr.size == 0:
            raise ValueError("modified direct accuracy needs at least one "
                             "placed piece in the solved board")
        nearest = int(np.min(rr + cc))
        rows, cols = puzzle.grid_size
        r_grid, c_grid = np.meshgrid(np.arange(rows), np.arange(cols),
                                     indexing="ij")
        candidates = [(int(r), int(c))
                      for r, c in np.argwhere(r_grid + c_grid <= nearest)]
        for possible_upper_left in candidates:
            modified = puzzle.determine_modified_direct_accuracy(
                self.original_id_number, possible_upper_left, self.numb_pieces)
            if DirectAccuracyPuzzleResults.check_if_update_direct_accuracy(
                    self.modified_direct_accuracy, modified):
                self.modified_direct_accuracy = modified


class PuzzleResultsCollection:
    """Accuracy aggregation over all solved boards, one results record per
    ORIGINAL puzzle (puzzle_importer.py:731-843 — its nested existence
    scan is a piece count per original id here)."""

    def __init__(self, puzzle_solver_type, puzzle_type, solved_puzzles, image_file_paths):
        from collections import Counter

        self._puzzle_solver_type = puzzle_solver_type
        self._puzzle_type = puzzle_type
        self._image_filenames = image_file_paths
        self._numb_output_puzzles = len(solved_puzzles)

        piece_counts = Counter(piece.original_puzzle_id
                               for board in solved_puzzles for piece in board)
        self._puzzle_results: List[PuzzleResultsInformation] = []
        for original_id in sorted(piece_counts):
            record = PuzzleResultsInformation(original_id,
                                              image_file_paths[original_id])
            record.numb_pieces = piece_counts[original_id]
            self._puzzle_results.append(record)

    def calculate_accuracies(self, solved_puzzles, best_buddy_pairs=None):
        """``best_buddy_pairs``: optional per-puzzle lists of (piece_id,
        side, buddy_id, buddy_side) tuples from the compatibility engine
        (or the ``best_buddy_pairs`` attribute the solver driver attaches
        to reconstructed puzzles); enables the best-buddy accuracy metric
        (puzzle_importer.py:1630+)."""
        if best_buddy_pairs is None:
            best_buddy_pairs = [getattr(p, "best_buddy_pairs", None)
                                for p in solved_puzzles]
        for puzzle_results, puzzle, pairs in zip(self._puzzle_results,
                                                 solved_puzzles, best_buddy_pairs):
            puzzle_results.resolve_direct_accuracies(puzzle)
            puzzle_results.resolve_neighbor_accuracies(puzzle)
            if pairs is not None:
                puzzle_results.resolve_best_buddy_accuracy(puzzle, pairs)

    @property
    def results(self):
        return self._puzzle_results

    def collect_results(self):
        """-> ({Direct_Standard, Direct_Modified, neighbor[, best_buddy]}:
        [per-puzzle fractions], perfect flags). Fractions are weighted by
        original piece count + pieces leaked in from other puzzles; a
        puzzle is 'perfect' when its STANDARD direct accuracy is 1
        (puzzle_importer.py:805-843)."""
        result = {"neighbor": [], "Direct_Standard": [], "Direct_Modified": []}
        perfect_puzzles = []
        for res in self._puzzle_results:
            for name, direct in (("Direct_Standard", res.standard_direct_accuracy),
                                 ("Direct_Modified", res.modified_direct_accuracy)):
                weight = res.numb_pieces + direct.numb_different_puzzle
                result[name].append(direct.numb_correct_placements / weight)
                if name == "Direct_Standard":
                    perfect_puzzles.append(
                        direct.numb_correct_placements == weight)

            neighbor = res.modified_neighbor_accuracy
            sides = ((neighbor.numb_pieces_in_original_puzzle
                      + neighbor.wrong_puzzle_id)
                     * PuzzlePieceSide.get_numb_sides())
            result["neighbor"].append(neighbor.correct_neighbor_count / sides)

            if res.best_buddy_accuracy is not None:
                result.setdefault("best_buddy", []).append(
                    res.best_buddy_accuracy.accuracy)
        return result, perfect_puzzles


class PuzzleTester:
    """Synthetic 9-piece puzzle whose pixel values increase sequentially so
    expected distances are computable in closed form
    (puzzle_importer.py:601-728). True-neighbor asymmetric distances are
    exactly 0 under the border-extrapolation distance."""

    PIECE_WIDTH = 5
    NUMB_PUZZLE_PIECES = 9
    GRID_SIZE = (3, 3)
    NUMB_PIXEL_DIMENSIONS = 3
    TEST_ARRAY_FIRST_PIXEL_VALUE = 0

    @staticmethod
    def build_pixel_list(start_value, is_row, reverse_list=False):
        """Expected border strip: start_value + i*step + j, as one
        broadcasted arange sum."""
        step = (PuzzleTester.NUMB_PIXEL_DIMENSIONS if is_row
                else PuzzleTester.row_to_row_step_size())
        pixels = (start_value
                  + step * np.arange(PuzzleTester.PIECE_WIDTH)[:, None]
                  + np.arange(PuzzleTester.NUMB_PIXEL_DIMENSIONS)[None, :]
                  ).astype(float)
        return pixels[::-1] if reverse_list else pixels

    @staticmethod
    def row_to_row_step_size():
        return int(PuzzleTester.NUMB_PIXEL_DIMENSIONS * PuzzleTester.PIECE_WIDTH
                   * math.sqrt(PuzzleTester.NUMB_PUZZLE_PIECES))

    @staticmethod
    def piece_to_piece_step_size():
        return PuzzleTester.NUMB_PIXEL_DIMENSIONS * PuzzleTester.PIECE_WIDTH

    @staticmethod
    def build_dummy_puzzle():
        """3x3 puzzle over a sequentially-valued image: one arange reshaped
        to HWC (value = first + (row*W + col)*C + channel)."""
        puzzle = Puzzle(0)
        width = PuzzleTester.PIECE_WIDTH
        grid = int(math.sqrt(PuzzleTester.NUMB_PUZZLE_PIECES))
        side = width * grid
        dims = PuzzleTester.NUMB_PIXEL_DIMENSIONS

        img = (PuzzleTester.TEST_ARRAY_FIRST_PIXEL_VALUE
               + np.arange(side * side * dims, dtype=float)
               ).reshape(side, side, dims)

        puzzle._img = img
        puzzle._img_LAB = img
        puzzle._img_height, puzzle._img_width = side, side
        puzzle._piece_width = width
        puzzle._grid_size = (grid, grid)
        puzzle.make_pieces()
        return puzzle
