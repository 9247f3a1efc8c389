"""ctypes binding of the native Paikin-Tal placement core
(``native/paikin_tal.cc``, the port's copy of the JAX package's).

The library is built with g++ at the first call (``ops/_build.py::
load_host``, into ``vit_ed_tpu_torch/build/``) with ``-ffp-contract=off``,
so that its float64 compatibilities round as the Python solver's
(``solver/solver.py``, the plain version) do. A failed build raises with
g++'s output; nothing falls back to the Python solver.

``pt_solve`` (type 1, [4, N, N] distances) and ``pt_solve2`` (type 2,
rotations, [4, N, 4, N]) are the counterparts of
``vit_ed_tpu/native/__init__.py``'s functions of the same names.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np

from vit_ed_tpu_torch.ops._build import load_host

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "paikin_tal.cc")
FLAGS = ["-ffp-contract=off"]

_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_SCALARS = [ctypes.c_int, _f64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = load_host(SRC, FLAGS)
            lib.pt_solve.restype = ctypes.c_int
            lib.pt_solve.argtypes = _SCALARS + [_i32, _i32, _i32, _i64]
            lib.pt_solve2.restype = ctypes.c_int
            lib.pt_solve2.argtypes = _SCALARS + [_i32, _i32, _i32, _i32, _i64]
            _lib = lib
    return _lib


def _fixed(fixed_puzzle_dimensions) -> Tuple[int, int]:
    if fixed_puzzle_dimensions is None:
        return 0, 0
    return int(fixed_puzzle_dimensions[0]), int(fixed_puzzle_dimensions[1])


def pt_solve(distances: np.ndarray, fixed_puzzle_dimensions=None,
             numb_puzzles: int = 1, new_board_mutual_compatibility: float = 0.5
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Type-1 placement of the [4, N, N] distance tensor.

    Returns (rows, cols, puzzle_ids, bb): int32 arrays of length N
    (locations normalized per output puzzle) and the initial best buddies,
    bb[s * N + i] = buddy id or -1 (int64, length 4N)."""
    lib = _load()
    d = np.ascontiguousarray(distances, np.float64)
    if not (d.ndim == 3 and d.shape[0] == 4 and d.shape[1] == d.shape[2]):
        raise ValueError(f"expected [4, N, N] distances, got {d.shape}")
    n = d.shape[1]
    rows, cols, pids = (np.empty(n, np.int32) for _ in range(3))
    bb = np.empty(4 * n, np.int64)
    rc = lib.pt_solve(n, d.reshape(-1), *_fixed(fixed_puzzle_dimensions),
                      int(numb_puzzles), float(new_board_mutual_compatibility),
                      rows, cols, pids, bb)
    if rc != 0:
        raise RuntimeError(f"native solver failed with code {rc}")
    return rows, cols, pids, bb


def pt_solve2(distances: np.ndarray, fixed_puzzle_dimensions=None,
              numb_puzzles: int = 1, new_board_mutual_compatibility: float = 0.5
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Type-2 (rotation-aware) placement of the [4, N, 4, N] distances.

    Returns (rows, cols, puzzle_ids, rotations, bb): int32 arrays, the
    rotations in quarter turns (0..3); bb[s * N + i] = t * N + j or -1."""
    lib = _load()
    d = np.ascontiguousarray(distances, np.float64)
    if not (d.ndim == 4 and d.shape[0] == 4 and d.shape[2] == 4
            and d.shape[1] == d.shape[3]):
        raise ValueError(f"expected [4, N, 4, N] distances, got {d.shape}")
    n = d.shape[1]
    rows, cols, pids, rots = (np.empty(n, np.int32) for _ in range(4))
    bb = np.empty(4 * n, np.int64)
    rc = lib.pt_solve2(n, d.reshape(-1), *_fixed(fixed_puzzle_dimensions),
                       int(numb_puzzles), float(new_board_mutual_compatibility),
                       rows, cols, pids, rots, bb)
    if rc != 0:
        raise RuntimeError(f"native type-2 solver failed with code {rc}")
    return rows, cols, pids, rots, bb
