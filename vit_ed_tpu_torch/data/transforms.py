"""Eval-time image transforms of the scoring path (PIL / numpy).

The port's copy of the eval pieces of ``vit_ed_tpu/data/transforms.py``:
``open_rgb``, ``center_crop``, ``to_tensor``, ``normalize``,
``as_sample_array`` and ``OneImgEval``. The JAX package also has a native
C++ fast path for these; it is bit-exact to the PIL + numpy chain below,
so the port keeps only the chain. Outputs are NHWC numpy arrays, float32
normalized with mean = std = 0.5, or raw uint8 with ``emit_u8``.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def open_rgb(path: str) -> Image.Image:
    """``Image.open(path).convert("RGB")`` with the file closed afterwards."""
    with Image.open(path) as f:
        return f.convert("RGB")


def to_tensor(img: Image.Image) -> np.ndarray:
    """PIL -> float32 HWC in [0, 1] (torchvision ToTensor, but channel-last)."""
    arr = np.asarray(img, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def normalize(arr: np.ndarray, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> np.ndarray:
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return (arr - mean) / std


def as_sample_array(image) -> np.ndarray:
    """Dataset output dtype policy: uint8 arrays (the ``emit_u8`` wire, which
    the model normalizes on the device) pass through; everything else
    becomes float32."""
    if isinstance(image, np.ndarray) and image.dtype == np.uint8:
        return image
    return np.asarray(image, np.float32)


def _resize(img: Image.Image, size) -> Image.Image:
    """torchvision Resize semantics: an int size resizes the SHORTER side."""
    if isinstance(size, int):
        w, h = img.size
        if (w <= h and w == size) or (h <= w and h == size):
            return img
        if w < h:
            return img.resize((size, int(size * h / w)), Image.BILINEAR)
        return img.resize((int(size * w / h), size), Image.BILINEAR)
    return img.resize((size[1], size[0]), Image.BILINEAR)


def center_crop(img: Image.Image, size) -> Image.Image:
    """Center crop to ``size``; short images are zero-padded first
    (torchvision CenterCrop)."""
    if isinstance(size, int):
        size = (size, size)
    th, tw = size
    w, h = img.size
    if w < tw or h < th:
        pad_w = max(tw - w, 0)
        pad_h = max(th - h, 0)
        new = Image.new(img.mode, (w + pad_w, h + pad_h))
        new.paste(img, (pad_w // 2, pad_h // 2))
        img = new
        w, h = img.size
    left = int(round((w - tw) / 2.0))
    top = int(round((h - th) / 2.0))
    return img.crop((left, top, left + tw, top + th))


class OneImgEval:
    """Center-crop (or resize) + normalize a single image.

    ``emit_u8`` skips the host normalize and returns the cropped uint8
    array; the model then normalizes on the device ((x/255 - 0.5)/0.5,
    ViTED._embed)."""

    def __init__(self, image_size, crop=False, emit_u8=False):
        self.image_size = image_size
        self.crop = crop
        self.emit_u8 = emit_u8

    def __call__(self, img):
        img = (center_crop(img, self.image_size) if self.crop
               else _resize(img, self.image_size))
        if self.emit_u8:
            arr = np.asarray(img, np.uint8)
            return arr[:, :, None] if arr.ndim == 2 else arr
        return normalize(to_tensor(img))
