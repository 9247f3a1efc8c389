"""``python -m vit_ed_tpu_torch.solver_driver`` against the root
``solver_driver.py`` of the JAX package on the CPU: one seeded image, cut
into 64 px pieces with 7% erosion, shuffled under the same ``random.seed``,
scored with the classical border distance and solved. The JAX driver's
steps are its ``__main__`` body, run here with the JAX package's modules;
the accuracies must be equal, and the port writes the reconstruction under
the image's name.
"""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import os
import random

import numpy as np
from PIL import Image

from vit_ed_tpu_torch import solver_driver


def _jax_driver(img_path, piece_width=64):
    """The root solver_driver.py's loop body for one image."""
    from vit_ed_tpu.solver.distance import classical_distance_matrix
    from vit_ed_tpu.solver.driver import paikin_tal_driver
    from vit_ed_tpu.solver.importer import (
        Puzzle,
        PuzzleResultsCollection,
        PuzzleSolver,
        PuzzleType,
    )

    puzzle = Puzzle(0, img_path, piece_width, starting_piece_id=0, erosion=0.07)
    pieces = puzzle.pieces
    random.shuffle(pieces)
    distances = classical_distance_matrix(pieces)
    new_puzzle = paikin_tal_driver(pieces, piece_width, None, puzzle.grid_size,
                                   distances=distances)
    results = PuzzleResultsCollection(PuzzleSolver.PaikinTal, PuzzleType.type1,
                                      [new_puzzle.pieces], [img_path])
    results.calculate_accuracies([new_puzzle])
    result, perfect = results.collect_results()
    return result, sum(perfect), new_puzzle


def test_accuracies_equal_the_jax_driver(tmp_path):
    images = tmp_path / "images"
    os.makedirs(images)
    small = np.random.default_rng(0).integers(0, 256, (7, 6, 3), dtype=np.uint8)
    Image.fromarray(small).resize((320, 256), Image.BICUBIC).save(images / "a.jpg",
                                                                  quality=95)
    random.seed(4)
    ref, ref_perfect, ref_puzzle = _jax_driver(str(images / "a.jpg"))
    random.seed(4)
    (rec,) = solver_driver.main(["--images", str(images), "--output", str(tmp_path / "o")])
    assert rec["result"] == ref and rec["perfect"] == ref_perfect
    assert sorted((p.original_piece_id, p.location) for p in rec["puzzle"].pieces) == \
        sorted((p.original_piece_id, p.location) for p in ref_puzzle.pieces)
    assert len(rec["puzzle"].pieces) == 20 and 0.0 <= ref["neighbor"][0] <= 1.0
    with Image.open(tmp_path / "o" / "a.jpg") as im:
        assert im.size[0] > 0


def test_default_folders_are_the_root_scripts():
    args = solver_driver.parse_option([])
    root = os.path.dirname(os.path.dirname(os.path.abspath(solver_driver.__file__)))
    assert args.images == os.path.join(root, "images")
    assert args.output == os.path.join(root, "output", "reconstructed")
