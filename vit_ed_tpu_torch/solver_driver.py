"""Classical-distance puzzle solving with the port (the root
``solver_driver.py`` of the JAX package): no network, no device.

    python -m vit_ed_tpu_torch.solver_driver [--images <folder of .jpg>] \\
        [--output <folder>]

Each ``*.jpg`` of the images folder is cut into LAB pieces of 64 px with
7% erosion (``solver.importer.Puzzle``); the pieces
are shuffled with Python's ``random``, scored with the border-extrapolation
distance (``solver.distance.classical_distance_matrix``), placed by the
Paikin-Tal solver, and the reconstruction is written to the output folder
under the image's name; one line per image gives its accuracies. The
folders default to what the root script reads and writes: ``images/`` and
``output/reconstructed/`` at the root of the repository.
"""

from __future__ import annotations

import argparse
import glob
import os
import random
from typing import Dict, List, Optional

from vit_ed_tpu_torch.solver.distance import classical_distance_matrix
from vit_ed_tpu_torch.solver.driver import paikin_tal_driver
from vit_ed_tpu_torch.solver.importer import (
    Puzzle,
    PuzzleResultsCollection,
    PuzzleSolver,
    PuzzleType,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECE_WIDTH = 64


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("Classical-distance solver driver (PyTorch port)")
    parser.add_argument("--images", default=os.path.join(REPO, "images"),
                        help="folder of the .jpg images to cut and solve")
    parser.add_argument("--output", default=os.path.join(REPO, "output", "reconstructed"),
                        help="folder for the reconstructions")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict[str, object]]:
    """Solve every image; returns per image its path, the accuracies
    (``collect_results``' dict), the perfect count and the solved puzzle."""
    args = parse_option(argv)
    records = []
    for img_path in sorted(glob.glob(os.path.join(args.images, "*.jpg"))):
        puzzle = Puzzle(0, img_path, PIECE_WIDTH, starting_piece_id=0, erosion=0.07)
        pieces = puzzle.pieces
        random.shuffle(pieces)

        distances = classical_distance_matrix(pieces)
        new_puzzle = paikin_tal_driver(pieces, PIECE_WIDTH, None,
                                       puzzle.grid_size, distances=distances)

        results_information = PuzzleResultsCollection(
            PuzzleSolver.PaikinTal, PuzzleType.type1, [new_puzzle.pieces], [img_path])
        results_information.calculate_accuracies([new_puzzle])
        result, perfect = results_information.collect_results()
        print(img_path, dict(result), "perfect:", sum(perfect))

        os.makedirs(args.output, exist_ok=True)
        new_puzzle.save_to_file(os.path.join(args.output, os.path.basename(img_path)))
        records.append({"image": img_path, "result": result, "perfect": sum(perfect),
                        "puzzle": new_puzzle})
    return records


if __name__ == "__main__":
    main()
