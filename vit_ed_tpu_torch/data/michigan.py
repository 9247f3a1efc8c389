"""Michigan papyrus datasets (the port's copy of
``vit_ed_tpu/data/michigan.py``).

Files sit at ``<papyrus>/<side>/<detail|summary>/<folder>/<medium>/<x>/
<file>`` (the 7 trailing path components). Only front (recto) scans of
medium ``papyrus`` are used; per papyrus the ``detail`` scans when there
are any, else the ``summary`` ones. A papyrus and its folder name are one
fragment group (transitively, over every file of the tree). Papyri are
carved into splits by sorted order: train the first 85%, val the last 15%
(which keeps ``val_n_items_per_writer`` files per papyrus and drops papyri
left with one). The sample order is the JAX package's exactly.

``MichiganTest`` (the val scan) also serves the whole-batch protocol of
the loader and the scorer: ``raw_image(i)``, ``item_meta(i)``.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.grouping import add_items_to_group
from vit_ed_tpu_torch.data.transforms import as_sample_array


class Split(Enum):
    TRAIN = "train"
    VAL = "validation"
    ALL = "all"

    @property
    def length(self) -> float:
        return {Split.TRAIN: 0.85, Split.VAL: 0.15, Split.ALL: 1.0}[self]

    def is_train(self):
        return self.value == "train"

    def is_val(self):
        return self.value == "validation"

    @staticmethod
    def from_string(name):
        for key in Split:
            if key.value == name:
                return key
        return None


@dataclass(frozen=True)
class PapyrusFile:
    """One scanned file, described by the 7 trailing path components."""

    papyrus: str   # papyrus (writer) name
    side: str      # 'front' (recto) / 'back'
    kind: str      # 'detail' / 'summary' scan
    folder: str    # sub-collection folder, grouped with the papyrus name
    medium: str    # 'papyrus' or another material
    path: str

    @staticmethod
    def parse(path: str) -> "PapyrusFile":
        parts = path.split(os.sep)[-7:]
        return PapyrusFile(papyrus=parts[0], side=parts[1], kind=parts[2],
                           folder=parts[3], medium=parts[4], path=path)


def _file_table(root: str) -> List[PapyrusFile]:
    """Every png / jpg under ``root``, path-sorted."""
    paths = glob.glob(os.path.join(root, "**", "*.png"), recursive=True)
    paths += glob.glob(os.path.join(root, "**", "*.jpg"), recursive=True)
    return [PapyrusFile.parse(p) for p in sorted(paths)]


def _fragment_groups(table: Sequence[PapyrusFile]):
    """Papyrus <-> folder groups over ALL records: (groups, name -> group
    index, name -> the members of its group)."""
    groups: List[set] = []
    for rec in table:
        add_items_to_group([rec.papyrus, rec.folder], groups)
    group_of: Dict[str, int] = {}
    members: Dict[str, set] = {}
    for gi, group in enumerate(groups):
        for name in group:
            group_of[name] = gi
            members[name] = set(group)
    return groups, group_of, members


def _select_scans(table: Sequence[PapyrusFile], keep_first: Optional[int]
                  ) -> Dict[str, List[str]]:
    """Per papyrus: its front / papyrus records of the preferred kind
    ('detail' where there is one, else 'summary'), cut to ``keep_first``
    (0 keeps none; None keeps all)."""
    by_papyrus: Dict[str, List[PapyrusFile]] = {}
    for rec in table:
        if rec.side == "front" and rec.medium == "papyrus":
            by_papyrus.setdefault(rec.papyrus, []).append(rec)

    selected: Dict[str, List[str]] = {}
    for papyrus, recs in by_papyrus.items():
        kind = ("detail" if any(r.kind == "detail" for r in recs)
                else "summary")
        paths = [r.path for r in recs if r.kind == kind]
        selected[papyrus] = (paths[:keep_first] if keep_first is not None
                             else paths)
    return selected


class MichiganDataset:
    """Training dataset: (augmented fragment image, papyrus-group label)."""

    Split = Split

    def __init__(self, dataset_path: str, split: Split, transforms: Callable,
                 samples=None, val_n_items_per_writer: Optional[int] = None):
        self.dataset_path = dataset_path
        self.samples = samples
        self.transforms = transforms
        if samples is not None:
            self.data = samples
            return

        table = _file_table(dataset_path)
        self.groups, self.fragment_to_group_id, self.fragment_to_group = \
            _fragment_groups(table)
        keep_first = val_n_items_per_writer if split.is_val() else None
        scans = _select_scans(table, keep_first)

        papyri = sorted(scans)
        if split == Split.TRAIN:
            papyri = papyri[: int(len(papyri) * split.length)]
        elif split == Split.VAL:
            papyri = papyri[-int(len(papyri) * split.length):]
        self.image_names = papyri
        self.image_idxes = {name: i for i, name in enumerate(papyri)}

        self.data: List[str] = []
        self.data_labels: List[int] = []
        for papyrus in papyri:
            fragments = sorted(scans[papyrus])
            if split.is_val() and len(fragments) < 2:
                continue   # one fragment makes no retrieval pair
            self.data += fragments
            self.data_labels += [self.fragment_to_group_id[papyrus]] * len(fragments)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        image = self.transforms(T.open_rgb(self.data[idx]))
        return (as_sample_array(image),
                np.asarray(self.data_labels[idx], np.int32))


class MichiganTest(MichiganDataset):
    """The val scan's dataset: (image, global index), indices offset by
    ``lower_bound``."""

    Split = Split

    def __init__(self, dataset_path: str, split: Split, transforms,
                 lower_bound: int = 0, samples=None,
                 val_n_items_per_writer: int = 2):
        super().__init__(dataset_path, split, transforms, samples=samples,
                         val_n_items_per_writer=val_n_items_per_writer)
        self.lower_bound = lower_bound
        if samples is not None:
            self.data = samples

    def __getitem__(self, index: int):
        index = index + self.lower_bound
        image = self.transforms(T.open_rgb(self.data[index]))
        return as_sample_array(image), np.asarray(index, np.int64)

    def __len__(self):
        return len(self.data) - self.lower_bound

    # the whole-batch protocol (data/loader.py, parallel/pairs.py), indexed
    # as __getitem__ is
    @property
    def transform(self):
        return self.transforms

    def raw_image(self, index: int) -> np.ndarray:
        return np.asarray(T.open_rgb(self.data[index + self.lower_bound]),
                          np.uint8)

    def item_meta(self, index: int):
        return (np.asarray(index + self.lower_bound, np.int64),)
