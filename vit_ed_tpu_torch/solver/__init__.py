"""The Paikin-Tal puzzle solver of the port (``vit_ed_tpu/solver``): pieces,
puzzles and their accuracies, the distance / compatibility engine, the
Python solver (the plain version of the native core in
``native/paikin_tal.cc``) and ``paikin_tal_driver``. Images are read,
converted to LAB and written without OpenCV (``color``)."""

from .piece import Location, PuzzlePiece, PuzzlePieceRotation, PuzzlePieceSide
from .importer import Puzzle, PuzzleResultsCollection, PuzzleSolver, PuzzleType
from .solver import PaikinTalSolver
from .driver import paikin_tal_driver

__all__ = [
    "Location",
    "PaikinTalSolver",
    "Puzzle",
    "PuzzlePiece",
    "PuzzlePieceRotation",
    "PuzzlePieceSide",
    "PuzzleResultsCollection",
    "PuzzleSolver",
    "PuzzleType",
    "paikin_tal_driver",
]
