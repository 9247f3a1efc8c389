"""Pajigsaw fragment datasets (the port's copy of
``vit_ed_tpu/data/pajigsaw.py``): a JSON manifest per split,
``<root>/<split>.json``, maps each image to its fragments (``im_path``,
grid ``row`` / ``col``, rotation ``degree``, ``white_percentage``); only the
upright (degree 0) fragments are used.

- ``Pajigsaw`` yields training pairs: for each anchor (a fragment with at
  least one eligible grid neighbour), 75% of draws take a random 4-neighbour
  as the second image with a one-hot direction label (right / below / left
  / above), the rest a negative (all-zero label): an in-image non-neighbour
  half of the time when one exists, else an anchor of another image.
- ``PajigsawPieces`` yields per image ``(pieces, image name, grid size)``:
  the fragments as solver pieces with their LAB pixels and grid locations.

The draws use Python's global ``random`` in the JAX package's order (first
``random.random() < 0.75``, then ``random.choice`` over numpy index arrays;
the cross-image draw picks from a list of image ids in the dict's insertion
order), the anchors are ordered by a stable ``np.lexsort`` on (col, row),
so one ``random.seed`` gives the same items in both packages. Images are
read with the port's decoder (``transforms.open_rgb``) and, for the pieces,
converted with ``solver/color.py``, equal to OpenCV's ``imread`` +
``COLOR_BGR2LAB``.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional

import numpy as np

from vit_ed_tpu_torch.data.transforms import as_sample_array, open_rgb
from vit_ed_tpu_torch.solver.color import bgr2lab_u8, imread_bgr
from vit_ed_tpu_torch.solver.piece import PuzzlePiece

# (row step, col step) of the second fragment relative to the first -> bin
_DIRECTION_BIN = {(0, 1): 0, (1, 0): 1, (0, -1): 2, (-1, 0): 3}

# fragments whiter than this are never drawn as a pair's second element
_WHITE_LIMIT = 0.85


class Split(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"

    def is_train(self):
        return self is Split.TRAIN

    @staticmethod
    def from_string(name):
        try:
            return Split(name)
        except ValueError:
            return None


@dataclass
class _FragmentGrid:
    """Upright fragments of one manifest image as parallel columns."""

    image: str
    paths: List[str]
    rows: np.ndarray   # (n,) int32 grid coordinates
    cols: np.ndarray   # (n,) int32
    white: np.ndarray  # (n,) float32 white-pixel fraction

    def __len__(self) -> int:
        return len(self.paths)

    @property
    def grid_size(self):
        return int(self.rows.max()) + 1, int(self.cols.max()) + 1


def _load_grids(root: str, split: Split) -> List[_FragmentGrid]:
    """``<root>/<split>.json`` -> one coordinate table per image, in the
    manifest's order."""
    with open(os.path.join(root, f"{split.value}.json")) as f:
        manifest = json.load(f)
    grids = []
    for image, record in manifest.items():
        upright = [f for f in record["Fragment1v1Rotate90"] if f["degree"] == 0]
        grids.append(_FragmentGrid(
            image=image,
            paths=[f["im_path"] for f in upright],
            rows=np.asarray([f["row"] for f in upright], np.int32),
            cols=np.asarray([f["col"] for f in upright], np.int32),
            white=np.asarray([f["white_percentage"] for f in upright], np.float32),
        ))
    return grids


class Pajigsaw:
    """Training pairs over the manifest's fragments: items are
    (stacked [2, H, W, 3] float32, or uint8 from a transform that emits it;
    label [4] float32)."""

    Split = Split

    def __init__(self, root: str, split: Split,
                 transform: Optional[Callable] = None, image_size: int = 512):
        self.root = root
        self.transform = transform
        self._split = split
        grids = _load_grids(root, split)

        # one flat fragment table over all images
        self._paths = [p for g in grids for p in g.paths]
        empty = np.zeros(0, np.int32)
        self._rows = np.concatenate([g.rows for g in grids]) if grids else empty
        self._cols = np.concatenate([g.cols for g in grids]) if grids else empty
        self._image_id = (np.concatenate([np.full(len(g), i, np.int32)
                                          for i, g in enumerate(grids)])
                          if grids else empty)

        # per fragment: eligible seconds (same image, another path, not
        # mostly white) that are grid neighbours (positives) or not
        self._positive: List[np.ndarray] = []
        self._negative: List[np.ndarray] = []
        base = 0
        for g in grids:
            paths = np.asarray(g.paths)
            eligible = (g.white[None, :] <= _WHITE_LIMIT) & (paths[:, None] != paths[None, :])
            ring = (np.abs(g.rows[:, None] - g.rows[None, :])
                    + np.abs(g.cols[:, None] - g.cols[None, :])) == 1
            for i in range(len(g)):
                self._positive.append(base + np.nonzero(eligible[i] & ring[i])[0])
                self._negative.append(base + np.nonzero(eligible[i] & ~ring[i])[0])
            base += len(g)

        # anchors: fragments with a positive, ordered by (col, row) over the
        # whole manifest; lexsort is stable, so ties keep manifest order
        anchors = np.asarray([i for i in range(base) if len(self._positive[i])], np.int64)
        order = (np.lexsort((self._rows[anchors], self._cols[anchors]))
                 if len(anchors) else np.zeros(0, np.int64))
        self._sample_ids = anchors[order]

        # anchor ids by image, for the cross-image negatives
        by_image: Dict[int, list] = {}
        for gid in anchors:
            by_image.setdefault(int(self._image_id[gid]), []).append(int(gid))
        self._anchors_by_image = {k: np.asarray(v, np.int64) for k, v in by_image.items()}
        self.im_names = sorted(g.image for g in grids)

    @property
    def split(self) -> Split:
        return self._split

    def _draw_negative(self, first: int) -> int:
        """An in-image non-neighbour with probability 0.5 (when one exists),
        else an anchor of another image; a single-image manifest without
        in-image negatives falls back to another anchor of the same image."""
        my_image = int(self._image_id[first])
        other_images = [g for g in self._anchors_by_image if g != my_image]
        in_image = self._negative[first]
        if len(in_image) and (random.random() < 0.5 or not other_images):
            return int(random.choice(in_image))
        if other_images:
            return int(random.choice(self._anchors_by_image[random.choice(other_images)]))
        mine = self._anchors_by_image[my_image]
        return int(random.choice(mine[mine != first]))

    def __getitem__(self, index: int):
        first = int(self._sample_ids[index])
        label = np.zeros(4, np.float32)
        if random.random() < 0.75:
            second = int(random.choice(self._positive[first]))
            step = (int(self._rows[second]) - int(self._rows[first]),
                    int(self._cols[second]) - int(self._cols[first]))
            label[_DIRECTION_BIN[step]] = 1.0
        else:
            second = self._draw_negative(first)

        first_img = open_rgb(os.path.join(self.root, self._paths[first]))
        second_img = open_rgb(os.path.join(self.root, self._paths[second]))
        if self.transform is not None:
            first_img, second_img = self.transform(first_img, second_img)
        stacked = np.stack([as_sample_array(first_img), as_sample_array(second_img)], axis=0)
        return stacked, label

    def __len__(self) -> int:
        return len(self._sample_ids)


class PajigsawPieces:
    """Per-image puzzle pieces for the solver: item i is ``(pieces, image
    name, grid size)`` of the i-th image in sorted order, the pieces with
    their ground-truth grid locations and LAB pixels."""

    Split = Split

    def __init__(self, root: str, split: Split):
        self.root = root
        self._split = split
        self._grids = {g.image: g for g in _load_grids(root, split)}
        self.entries = sorted(self._grids)

    @property
    def split(self) -> Split:
        return self._split

    def __getitem__(self, index: int):
        grid = self._grids[self.entries[index]]
        grid_size = grid.grid_size
        pieces = []
        for piece_id, (path, row, col) in enumerate(zip(grid.paths, grid.rows, grid.cols)):
            bgr = imread_bgr(os.path.join(self.root, path))
            pieces.append(PuzzlePiece(index, (int(row), int(col)), bgr2lab_u8(bgr),
                                      piece_id=piece_id, puzzle_grid_size=grid_size))
        return pieces, grid.image, grid_size

    def __len__(self) -> int:
        return len(self.entries)
