"""HisFrag20 datasets (the port's copy of ``vit_ed_tpu/data/hisfrag.py``):
``HisFrag20`` for training (augmented image, writer index) and
``HisFrag20Test`` for the val and test scans.

Files are named ``writer_page_fragment.jpg``. Writers are carved into
splits by sorted order (93% train / 7% val inside ``train/``, all of
``test/``); the val split keeps ~``val_n_items_per_writer`` fragments per
writer by striding. The sample order is the JAX package's exactly, so both
frameworks score the same matrix.

Both datasets also serve the whole-batch protocol of the loader and the
scorer (``data/loader.py``, ``parallel/pairs.py``): ``raw_image(i)`` is the
decoded u8 image of item i without its transform, ``item_meta(i)`` the
item's other fields, so that a transform with ``pool_crop`` runs for a
whole batch in the native ``PipelinePool``.
"""

from __future__ import annotations

import glob
import math
import os
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from vit_ed_tpu_torch.data.transforms import as_sample_array, open_rgb
from vit_ed_tpu_torch.utils.misc import chunks


class Split(Enum):
    TRAIN = "train"
    VAL = "val"
    TEST = "test"

    @property
    def length(self) -> float:
        return {Split.TRAIN: 0.93, Split.VAL: 0.07, Split.TEST: 1.0}[self]

    @property
    def sub_dir(self) -> str:
        # val images live inside the train directory (held-out writers)
        return "test" if self is Split.TEST else "train"

    @staticmethod
    def from_string(name: str) -> "Split":
        return Split(name)


@dataclass(frozen=True, order=True)
class Fragment:
    """One fragment image file, keyed ``writer_page_fragment.jpg``."""

    writer: str
    page: str
    path: str

    @staticmethod
    def parse(path: str) -> "Fragment":
        stem = os.path.splitext(os.path.basename(path))[0]
        writer, page, _frag = stem.split("_")
        return Fragment(writer=writer, page=page, path=path)


def _fragment_table(root_dir: str) -> List[Fragment]:
    """All fragments under ``root_dir``, ordered by (writer, page, path)."""
    paths = sorted(glob.glob(os.path.join(root_dir, "**", "*.jpg"),
                             recursive=True))
    return sorted(Fragment.parse(p) for p in paths)


def _writer_window(table: Sequence[Fragment],
                   proportion: Tuple[float, float]) -> List[str]:
    """The sorted-writer slice [lo*n : hi*n) the split owns."""
    writers = sorted({f.writer for f in table})
    lo, hi = (int(p * len(writers)) for p in proportion)
    return writers[lo:hi]


def _split_proportion(split: Split) -> Tuple[float, float]:
    if split is Split.VAL:
        return (1.0 - split.length, 1.0)
    return (0.0, split.length)


class HisFrag20:
    """Train-time dataset of a split's writers: items are ``(augmented
    image, writer index)``; ``data_labels`` lists every item's writer
    index (the M-per-class sampler reads it)."""

    Split = Split

    def __init__(self, root: str, split: Split,
                 transform: Optional[Callable] = None):
        self.split = split
        self.transform = transform
        self.root_dir = os.path.join(root, split.sub_dir)

        table = _fragment_table(self.root_dir)
        self.writers = _writer_window(table, _split_proportion(split))
        rank = {w: i for i, w in enumerate(self.writers)}
        mine = [f for f in table if f.writer in rank]

        self.samples = [f.path for f in mine]
        self.data_labels = [rank[f.writer] for f in mine]
        self.writer_to_idx = rank

    def __getitem__(self, index: int):
        image = open_rgb(self.samples[index])
        if self.transform is not None:
            image = self.transform(image)
        return (as_sample_array(image),
                np.asarray(self.data_labels[index], np.int32))

    def raw_image(self, index: int) -> np.ndarray:
        return np.asarray(open_rgb(self.samples[index]), np.uint8)

    def item_meta(self, index: int):
        return (np.asarray(self.data_labels[index], np.int32),)

    def __len__(self) -> int:
        return len(self.samples)


def _eval_samples(root_dir: str, split: Split,
                  val_n_items_per_writer: int) -> List[str]:
    """Every fragment of the split's writers, the val split strided down
    to ~``val_n_items_per_writer`` per writer."""
    table = _fragment_table(root_dir)
    keep = set(_writer_window(table, _split_proportion(split)))

    samples: List[str] = []
    for writer in sorted(keep):
        paths = [f.path for f in table if f.writer == writer]
        if split is Split.VAL:
            stride = math.ceil(len(paths) / val_n_items_per_writer)
            paths = chunks(paths, stride)[0]
        samples.extend(paths)
    return samples


class HisFrag20Test:
    """Eval sample list of the val or test split; items are
    ``(image, index)``."""

    Split = Split

    def __init__(self, root: str, split: Split,
                 transform: Optional[Callable] = None,
                 val_n_items_per_writer: int = 2):
        if split is Split.TRAIN:
            raise ValueError(
                "HisFrag20Test serves the val and test splits only")
        self.transform = transform
        self.samples = _eval_samples(os.path.join(root, split.sub_dir), split,
                                     val_n_items_per_writer)

    def __getitem__(self, index: int):
        image = open_rgb(self.samples[index])
        if self.transform:
            image = self.transform(image)
        return as_sample_array(image), np.asarray(index, np.int64)

    def raw_image(self, index: int) -> np.ndarray:
        return np.asarray(open_rgb(self.samples[index]), np.uint8)

    def item_meta(self, index: int):
        return (np.asarray(index, np.int64),)

    def __len__(self) -> int:
        return len(self.samples)
