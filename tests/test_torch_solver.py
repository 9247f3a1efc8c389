"""The port's Paikin-Tal solver (vit_ed_tpu_torch/solver and its native core
native/paikin_tal.cc) against the JAX package's solver on the same pieces
and distance tensors: type 1 and type 2 (rotations), through the native
core and through the Python solver, with identical placements, rotations,
best-buddy pairs, accuracies and Perfect count. The port's native core is
held against its own Python solver (its plain version) as
tests/test_native_solver.py holds the JAX pair, the distance functions are
compared exactly, and a native build that fails raises."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import copy

import numpy as np
import pytest

from vit_ed_tpu.solver import distance as jdist
from vit_ed_tpu.solver import driver as jdriver
from vit_ed_tpu.solver import importer as jimp
from vit_ed_tpu.solver import piece as jpiece
from vit_ed_tpu_torch.native import solver as native
from vit_ed_tpu_torch.solver import distance as tdist
from vit_ed_tpu_torch.solver import driver as tdriver
from vit_ed_tpu_torch.solver import importer as timp
from vit_ed_tpu_torch.solver import piece as tpiece
from vit_ed_tpu_torch.solver.solver import PaikinTalSolver

ROWS, COLS, W = 3, 4, 8


def _grid_image(seed):
    """Smooth, asymmetric LAB-like pixels: unique borders in every
    orientation (the image of tests/test_type2.py)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(10, 120, ROWS * W)[:, None, None]
    x = np.linspace(0, 80, COLS * W)[None, :, None]
    c = np.arange(3)[None, None, :] * 12.0
    img = y + 0.7 * x + c + 8.0 * np.sin(y / 17.0 + 2.0 * c) * np.cos(x / 23.0)
    return (img + rng.normal(0, 1.0, img.shape)).astype(np.uint8)


def _pieces(mod, img, turns):
    out = []
    for r in range(ROWS):
        for c in range(COLS):
            patch = np.rot90(img[r * W:(r + 1) * W, c * W:(c + 1) * W],
                             turns[r * COLS + c]).copy()
            out.append(mod.PuzzlePiece(0, (r, c), patch, piece_id=r * COLS + c,
                                       puzzle_grid_size=(ROWS, COLS)))
    return out


def _distances(mod, pieces, source, type2, rng):
    n = len(pieces)
    if source == "classical":
        return (mod.classical_distance_matrix_type2(pieces) if type2
                else mod.classical_distance_matrix(pieces))
    if type2:
        return rng.uniform(1.0, 100.0, size=(4, n, 4, n))
    return mod.distance_matrix_from_predictions(rng.uniform(size=(n, n, 4)))


def _solve(drv, imp, pieces, distances, type2, use_native):
    puzzle = drv.paikin_tal_driver(pieces, W, None, (ROWS, COLS),
                                   distances=distances.copy(),
                                   use_native=use_native)
    ptype = imp.PuzzleType.type2 if type2 else imp.PuzzleType.type1
    results = imp.PuzzleResultsCollection(imp.PuzzleSolver.PaikinTal, ptype,
                                          [puzzle.pieces], ["puzzle.png"])
    results.calculate_accuracies([puzzle])
    result, perfect = results.collect_results()
    placements = sorted((p.original_piece_id, p.location, p.rotation.value)
                        for p in puzzle.pieces)
    bb = sorted((i, s.value, j, t.value) for i, s, j, t in puzzle.best_buddy_pairs)
    return placements, bb, result, sum(perfect)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("source", ["classical", "random"])
@pytest.mark.parametrize("type2", [False, True], ids=["type1", "type2"])
def test_solver_matches_jax(type2, source, use_native):
    img = _grid_image(3)
    rng = np.random.default_rng(7)
    turns = rng.integers(0, 4, ROWS * COLS) if type2 else np.zeros(ROWS * COLS, int)
    order = rng.permutation(ROWS * COLS)
    jp = [_pieces(jpiece, img, turns)[i] for i in order]
    tp = [_pieces(tpiece, img, turns)[i] for i in order]
    dj = _distances(jdist, jp, source, type2, np.random.default_rng(11))
    dt = _distances(tdist, tp, source, type2, np.random.default_rng(11))
    np.testing.assert_array_equal(dt, dj)
    ref = _solve(jdriver, jimp, jp, dj, type2, use_native)
    ours = _solve(tdriver, timp, tp, dt, type2, use_native)
    assert ours[0] == ref[0]            # placements and rotations
    assert ours[1] == ref[1]            # best-buddy pairs
    assert ours[2] == ref[2]            # Direct / Modified / neighbor / best buddy
    assert ours[3] == ref[3]            # Perfect
    if source == "classical" and not type2:
        assert ours[3] == 1             # a clean puzzle reassembles


@pytest.mark.parametrize("erosion", [0.0, 0.07])
def test_distance_functions_equal_jax(tmp_path, erosion):
    from PIL import Image

    path = str(tmp_path / "p.png")
    Image.fromarray(np.repeat(np.repeat(_grid_image(1), 2, 0), 2, 1)).save(path)
    jp = jimp.Puzzle(0, path, 2 * W, erosion=erosion).pieces
    tp = timp.Puzzle(0, path, 2 * W, erosion=erosion).pieces
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(b.lab_image, a.lab_image)
    np.testing.assert_array_equal(tdist.classical_distance_matrix(tp),
                                  jdist.classical_distance_matrix(jp))
    np.testing.assert_array_equal(tdist.classical_distance_matrix_type2(tp),
                                  jdist.classical_distance_matrix_type2(jp))
    preds = np.random.default_rng(2).uniform(size=(len(tp), len(tp), 4))
    np.testing.assert_array_equal(tdist.distance_matrix_from_predictions(preds),
                                  jdist.distance_matrix_from_predictions(preds))


def _python_solve(distances, fixed_dims, type2):
    n = distances.shape[1]
    pieces = [tpiece.PuzzlePiece(0, (i, 0), np.zeros((8, 8, 3), np.uint8),
                                 piece_id=i, puzzle_grid_size=(n, 1))
              for i in range(n)]
    ptype = timp.PuzzleType.type2 if type2 else timp.PuzzleType.type1
    solver = PaikinTalSolver(1, pieces, None, ptype, 0.0, fixed_dims,
                             distances=distances)
    solver.run()
    rows = np.array([p.location[0] for p in pieces])
    cols = np.array([p.location[1] for p in pieces])
    rots = np.array([p.rotation.value // 90 for p in pieces])
    return rows - rows.min(), cols - cols.min(), rots


@pytest.mark.parametrize("trial", range(4))
@pytest.mark.parametrize("type2", [False, True], ids=["type1", "type2"])
def test_native_core_matches_python_solver(type2, trial):
    n = 9
    rng = np.random.default_rng(100 + trial)
    shape = (4, n, 4, n) if type2 else (4, n, n)
    d = rng.uniform(1.0, 100.0, size=shape)
    rows_p, cols_p, rots_p = _python_solve(d.copy(), None, type2)
    if type2:
        rows_n, cols_n, pids, rots_n, _bb = native.pt_solve2(d, None, 1, 0.0)
        np.testing.assert_array_equal(rots_n, rots_p)
    else:
        rows_n, cols_n, pids, _bb = native.pt_solve(d, None, 1, 0.0)
    np.testing.assert_array_equal(rows_n, rows_p)
    np.testing.assert_array_equal(cols_n, cols_p)
    assert (pids == 0).all()


def test_native_core_reassembles_the_dummy_puzzle():
    puzzle = timp.PuzzleTester.build_dummy_puzzle()
    d = tdist.classical_distance_matrix(puzzle.pieces)
    rows, cols, pids, bb = native.pt_solve(d, puzzle.grid_size, 1, 0.0)
    assert [(r, c) for r, c in zip(rows, cols)] == [(i // 3, i % 3) for i in range(9)]
    assert bb.shape == (36,) and (bb >= -1).all()


def test_failed_native_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "paikin_tal.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    puzzle = timp.PuzzleTester.build_dummy_puzzle()
    d = tdist.classical_distance_matrix(puzzle.pieces)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.pt_solve(d, puzzle.grid_size, 1, 0.0)
    # paikin_tal_driver does not fall back to the Python solver
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tdriver.paikin_tal_driver(copy.deepcopy(puzzle.pieces), 3, None,
                                  puzzle.grid_size, distances=d)


def test_python_solver_keeps_a_long_chain_on_its_board():
    """Distances under which the placement runs more than N / 2 cells
    from the seed: the JAX package's Python solver (an N x N board around
    the seed) steps off its board; the port's, on the native core's (2N + 3)^2 board, places every
    piece where the native core does."""
    from vit_ed_tpu.solver.solver import PaikinTalSolver as JaxPaikinTalSolver

    n = 9
    d = np.random.default_rng(103).uniform(1.0, 100.0, size=(4, n, 4, n))
    jax_pieces = [jpiece.PuzzlePiece(0, (i, 0), np.zeros((8, 8, 3), np.uint8),
                                     piece_id=i, puzzle_grid_size=(n, 1))
                  for i in range(n)]
    with pytest.raises(IndexError):
        JaxPaikinTalSolver(1, jax_pieces, None, jimp.PuzzleType.type2, 0.0,
                           None, distances=d.copy()).run()
    rows_p, cols_p, rots_p = _python_solve(d.copy(), None, True)
    rows_n, cols_n, _pids, rots_n, _bb = native.pt_solve2(d, None, 1, 0.0)
    np.testing.assert_array_equal(rows_n, rows_p)
    np.testing.assert_array_equal(cols_n, cols_p)
    np.testing.assert_array_equal(rots_n, rots_p)


def test_standalone_accuracies_equal_jax():
    """solver/evaluation.py's neighbor and direct accuracies on one solved
    puzzle, port against JAX."""
    from vit_ed_tpu.solver import evaluation as jeval
    from vit_ed_tpu_torch.solver import evaluation as teval

    img = _grid_image(5)
    order = np.random.default_rng(9).permutation(ROWS * COLS)
    turns = np.zeros(ROWS * COLS, int)
    preds = np.random.default_rng(4).uniform(size=(ROWS * COLS, ROWS * COLS, 4))
    solved = []
    for drv, pmod, dmod in ((jdriver, jpiece, jdist), (tdriver, tpiece, tdist)):
        pieces = [_pieces(pmod, img, turns)[i] for i in order]
        solved.append(drv.paikin_tal_driver(
            pieces, W, None, (ROWS, COLS),
            distances=dmod.distance_matrix_from_predictions(preds)))
    ref, ours = solved
    assert teval.compute_neighbor_accuracy(ours) == jeval.compute_neighbor_accuracy(ref)
    assert teval.compute_direct_accuracy(ours) == jeval.compute_direct_accuracy(ref)
    assert 0.0 <= teval.compute_neighbor_accuracy(ours) <= 1.0
