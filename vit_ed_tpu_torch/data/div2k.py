"""DIV2K puzzle-pair generator (``vit_ed_tpu/data/div2k.py``): the dataset
that synthesises training pairs for the 4-bin spatial-compatibility task,
and ``Div2kPatchTriplet``, its rotated triplets for the ViT baseline. The
draws from Python's ``random`` come in the JAX package's order, so one
seed gives the same items in both.

- load a DIV2K image; at train time augment with flips + shift/scale/rotate
  + RGB shift
- crop a (2*size x 3*size) region (random at train, center at eval)
- split into a 3x2 grid; center-crop each cell to
  ceil(size * (1 - erosion)) with erosion ~ U[r, 2r] at train
- labels: [right, below, left, above] one-hot; 30% all-zero negatives via
  non-adjacent/swapped crops

Outputs stacked pairs [2, H, W, 3] float32 (NHWC) + float label [4].
"""

from __future__ import annotations

import math
import os
import random
from enum import Enum
from typing import Callable, Optional

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.data import transforms as T


class Split(Enum):
    TRAIN = "train"
    VAL = "validation"

    @property
    def sub_dir(self) -> str:
        return {Split.TRAIN: "DIV2K_train_HR", Split.VAL: "DIV2K_valid_HR"}[self]

    def is_train(self):
        return self.value == "train"

    @staticmethod
    def from_string(name):
        for key in Split:
            if key.value == name:
                return key
        return None


class DIV2KPatch:
    Split = Split

    def __init__(self, root: str, split: Split, transform: Optional[Callable] = None,
                 image_size=64, erosion_ratio=0.07, with_negative=False):
        self.root_dir = root
        self._split = split
        self.image_size = image_size
        self.with_negative = with_negative
        self.erosion_ratio = erosion_ratio
        self.transform = transform
        self.dataset = self.load_dataset()

    @property
    def split(self):
        return self._split

    def load_dataset(self):
        dataset_dir = os.path.join(self.root_dir, self._split.sub_dir)
        images = []
        for root, _dirs, files in os.walk(dataset_dir):
            for file in files:
                if file.lower().endswith((".jpg", ".png")):
                    images.append(os.path.join(root, file))
        return sorted(images)

    def read_image(self, index: int) -> Image.Image:
        img_path = self.dataset[index]
        image = T.open_rgb(img_path)
        if self._split.is_train():
            if random.random() < 0.5:
                image = image.transpose(Image.FLIP_LEFT_RIGHT)
            if random.random() < 0.5:
                image = image.transpose(Image.FLIP_TOP_BOTTOM)
            image = T.shift_scale_rotate(image, shift_limit=0.05, scale_limit=0.15,
                                         rotate_limit=20, p=0.5)
            image = T.rgb_shift(image, limit=15, p=0.5)
        return image

    def _crop_region(self, image: Image.Image) -> Image.Image:
        size = (self.image_size * 2, self.image_size * 3)  # (h, w)
        if self._split.is_train():
            return T.random_crop(image, size, pad_if_needed=True)
        return T.center_crop(image, size)

    def __getitem__(self, index: int):
        image = self.read_image(index)
        patch = self._crop_region(image)

        # 3x2 grid, row-major: crops[0..2] top row, crops[3..5] bottom row
        crops = T.crop(patch, 3, 2)
        erosion_ratio = self.erosion_ratio
        if self._split.is_train():
            erosion_ratio = random.uniform(self.erosion_ratio, self.erosion_ratio * 2)
        piece = math.ceil(self.image_size * (1 - erosion_ratio))

        first_img = T.center_crop(crops[0], piece)
        second_img = T.center_crop(crops[1], piece)   # right of first
        third_img = T.center_crop(crops[4], piece)    # below second
        fourth_img = T.center_crop(crops[3], piece)   # below first

        label = [1.0, 0.0, 0.0, 0.0]
        if self.with_negative and random.random() < 0.3:
            if random.random() < 0.5:
                second_img, third_img = third_img, second_img
            else:
                second_img = T.center_crop(crops[2], piece)
            if random.random() < 0.5:
                second_img, first_img = first_img, second_img
            label = [0.0, 0.0, 0.0, 0.0]
        else:
            if random.random() < 0.5:
                second_img, fourth_img = fourth_img, second_img
                label = [0.0, 1.0, 0.0, 0.0]
            if random.random() < 0.5:
                first_img, second_img = second_img, first_img
                if label[0] == 1:
                    label = [0.0, 0.0, 1.0, 0.0]
                else:
                    label = [0.0, 0.0, 0.0, 1.0]

        if self.transform is not None:
            first_img, second_img = self.transform(first_img, second_img)

        stacked = np.stack([np.asarray(first_img), np.asarray(second_img)], axis=0)
        return stacked.astype(np.float32), np.asarray(label, np.float32)

    def __len__(self):
        return len(self.dataset)


class Div2kPatchTriplet(DIV2KPatch):
    """4 directional (anchor, positive, negative) triplets per image made
    with PIL's 90-degree rotations, for the triplet-ViT baseline. Items are
    [4, 3, H, W, 3] float32 and the index. The ``random`` draws are
    ``DIV2KPatch``'s up to the erosion ratio; no label draw follows."""

    def __getitem__(self, index: int):
        image = self.read_image(index)
        patch = self._crop_region(image)
        crops = T.crop(patch, 3, 2)
        erosion_ratio = self.erosion_ratio
        if self._split.is_train():
            erosion_ratio = random.uniform(self.erosion_ratio, self.erosion_ratio * 2)
        piece = math.ceil(self.image_size * (1 - erosion_ratio))

        def tr(img):
            # the single-image path of the pair transform
            out = self.transform(img, img)[0] if self.transform else T.normalize_image(img)
            return np.asarray(out)

        def cc(i):
            return T.center_crop(crops[i], piece)

        results = [
            # right of first
            np.stack([tr(cc(0)), tr(cc(1).rotate(180)), tr(cc(1))]),
            # left of first
            np.stack([tr(cc(5).rotate(180)), tr(cc(4)), tr(cc(1))]),
            # bottom of first
            np.stack([tr(cc(1).rotate(90)), tr(cc(4).rotate(270)), tr(cc(3))]),
            # top of first
            np.stack([tr(cc(3).rotate(270)), tr(cc(1).rotate(90)), tr(cc(2))]),
        ]
        return np.stack(results).astype(np.float32), np.asarray(index, np.int32)
