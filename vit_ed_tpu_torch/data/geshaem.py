"""Geshaem papyrus fragment dataset (the port's copy of
``vit_ed_tpu/data/geshaem.py``).

Images sit at ``<root>/<name>/papyrus/<x>/<file>.jpg`` where ``<name>`` is
``<fragment>_<r|v>_<column>``; a fragment name joined from several piece
ids with ``_`` (a hand-assembled fragment) puts those pieces in one
positive group. Recto images only unless ``include_verso``; images under
``min_size_limit``² pixels are dropped, and at train so are the assembled
fragments (they would leak the answer), and each image repeats by its area
in units of 512². ``GeshaemPatch`` items are the stacked pairs of the
upper triangle (i <= j) of all images; it also serves the loader's
multi-image whole-batch protocol: ``raw_images(i)`` (both decoded images)
and ``item_meta(i)``.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.grouping import add_items_to_group
from vit_ed_tpu_torch.data.transforms import as_sample_array

_NAME_RE = re.compile(r"^([\w']+)_([rv])_(\w+)(\s.+)?$")
_REFERENCE_AREA = 512 * 512   # the train repetition unit


class Split(Enum):
    TRAIN = "train"
    VAL = "validation"
    TEST = "test"

    def is_train(self) -> bool:
        return self is Split.TRAIN

    def is_val(self) -> bool:
        return self is Split.VAL

    def is_test(self) -> bool:
        return self is Split.TEST

    @staticmethod
    def from_string(name: str) -> Optional["Split"]:
        try:
            return Split(name)
        except ValueError:
            return None


def parse_name(name: str) -> Tuple[str, str, str]:
    """A folder name -> (fragment, recto/verso, column)."""
    m = _NAME_RE.match(name)
    if m is None:
        raise ValueError(f"Fragment name {name} not recognized")
    return m.group(1), m.group(2), m.group(3)


@dataclass(frozen=True)
class _Record:
    """One papyrus image: its path and its folder name's fields."""

    path: str
    fragment: str     # the full (possibly assembled) fragment name
    recto: bool
    area: int

    @property
    def piece_ids(self) -> List[str]:
        return self.fragment.split("_")

    @property
    def assembled(self) -> bool:
        return len(self.piece_ids) > 1


def _folder_name(path: str, levels: int) -> str:
    for _ in range(levels):
        path = os.path.dirname(path)
    return os.path.basename(path)


def _pixel_area(path: str) -> int:
    with Image.open(path) as im:
        w, h = im.size
    return w * h


def _scan_records(root: str) -> List[_Record]:
    """Every ``**/papyrus/*/<file>.jpg`` image, path-sorted."""
    records = []
    for path in sorted(glob.glob(os.path.join(root, "**", "*.jpg"),
                                 recursive=True)):
        if path.split(os.sep)[-3] != "papyrus":
            continue
        fragment, rv, _col = parse_name(_folder_name(path, 3))
        records.append(_Record(path=path, fragment=fragment,
                               recto=rv.upper() != "V",
                               area=_pixel_area(path)))
    return records


def extract_relations(dataset_path: str) -> List[Set[str]]:
    """The positive groups that assembled fragment names imply, parsed from
    the folder two levels above each jpg (as the JAX package's)."""
    groups: List[Set[str]] = []
    for path in glob.glob(os.path.join(dataset_path, "**", "*.jpg"),
                          recursive=True):
        fragment, _rv, _col = parse_name(_folder_name(path, 2))
        add_items_to_group(fragment.split("_"), groups)
    return groups


class MergeDataset:
    """Concatenation of GeshaemPatch-style datasets."""

    def __init__(self, datasets, transform):
        self.data = [p for ds in datasets for p in ds.data]
        self.data_labels = [l for ds in datasets for l in ds.data_labels]
        self.transform = transform

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int):
        image = self.transform(T.open_rgb(self.data[idx]))
        return (as_sample_array(image),
                np.asarray(self.data_labels[idx], np.int32))


class GeshaemPatch:
    """All upper-triangle pairs of fragment images, stacked [2, H, W, C],
    with the fragment-group ground truth."""

    Split = Split

    def __init__(self, root: str, split: Split,
                 transform: Optional[Callable] = None,
                 include_verso: bool = False, min_size_limit: int = 112,
                 base_idx: int = 0):
        self._split = split
        self.root_dir = root
        self.transform = transform

        records = _scan_records(root)
        usable = [r for r in records if r.recto or include_verso]

        # every usable image's piece ids and full name form one group,
        # including images the data pass below drops
        groups: List[Set[str]] = []
        for r in usable:
            add_items_to_group(r.piece_ids + [r.fragment], groups)

        # singleton groups have no positive to retrieve at eval
        self.fragment_to_group: Dict[str, Set[str]] = {}
        self.fragment_to_group_id: Dict[str, int] = {}
        for idx, group in enumerate(groups):
            if len(group) < 2 and split.is_val():
                continue
            for member in group:
                self.fragment_to_group_id[member] = idx
                self.fragment_to_group.setdefault(member, set()).update(group)

        kept = [r for r in usable
                if not (split.is_train() and r.assembled)
                and r.area >= min_size_limit * min_size_limit]

        by_fragment: Dict[str, List[_Record]] = {}
        for r in kept:
            by_fragment.setdefault(r.fragment, []).append(r)
        self.fragments = sorted(by_fragment)
        self.fragment_idx = {name: i for i, name in enumerate(self.fragments)}

        self.data: List[str] = []
        self.data_labels: List[int] = []
        for idx, name in enumerate(self.fragments):
            for r in sorted(by_fragment[name], key=lambda rec: rec.path):
                if r.piece_ids[0] not in self.fragment_to_group:
                    continue
                repeats = 1
                if split.is_train():
                    repeats = max(round(r.area / _REFERENCE_AREA), 1)
                self.data.extend([r.path] * int(repeats))
                self.data_labels.extend([idx + base_idx] * int(repeats))

        hi, lo = np.triu_indices(len(self.data))
        self.pairs = np.stack([hi, lo], axis=1).astype(np.int64)

    def get_group_id(self, fragment_id: int) -> int:
        return self.fragment_to_group_id[self.fragments[fragment_id]]

    @property
    def split(self) -> Split:
        return self._split

    def __getitem__(self, index: int):
        i, j = (int(x) for x in self.pairs[index])
        first = T.open_rgb(self.data[i])
        second = T.open_rgb(self.data[j])
        if self.transform:
            first = self.transform(first)
            second = self.transform(second)
        stacked = np.stack([as_sample_array(first), as_sample_array(second)],
                           axis=0)
        labels = np.asarray([self.data_labels[i], self.data_labels[j]], np.int64)
        return stacked, labels

    def __len__(self) -> int:
        return len(self.pairs)

    # the loader's multi-image whole-batch protocol: both decoded images of
    # a pair, pooled flat and re-stacked [B, 2, H, W, C]
    def raw_images(self, index: int) -> List[np.ndarray]:
        i, j = (int(x) for x in self.pairs[index])
        return [np.asarray(T.open_rgb(self.data[i]), np.uint8),
                np.asarray(T.open_rgb(self.data[j]), np.uint8)]

    def item_meta(self, index: int):
        i, j = (int(x) for x in self.pairs[index])
        return (np.asarray([self.data_labels[i], self.data_labels[j]],
                           np.int64),)
