"""Image transforms of the scoring and training paths (PIL / numpy).

The port's copy of the pieces of ``vit_ed_tpu/data/transforms.py`` that
the hisfrag entry uses. Eval: ``open_rgb``, ``center_crop``, ``to_tensor``,
``normalize``, ``as_sample_array`` and ``OneImgEval``. Training:
``random_affine``, ``shift_scale_rotate`` (both through ``warp_affine``,
the numpy affine warp with cv2 INTER_LINEAR semantics), ``random_crop``,
``color_jitter``, ``GaussianBlur`` and ``normalize_image``. The JAX package
also has a native C++ fast path for these; it is bit-exact to the PIL +
numpy chain below, so the port keeps only the chain (no cv2, no native
code). The random draws come from Python's ``random`` in the JAX package's
order, so one seed gives the same augmentations in both. Outputs are NHWC
numpy arrays, float32 normalized with mean = std = 0.5, or raw uint8 with
``emit_u8``.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageFilter


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


def normalize_image(img: Image.Image, mean=(0.5, 0.5, 0.5),
                    std=(0.5, 0.5, 0.5)) -> np.ndarray:
    return normalize(to_tensor(img), mean, std)


# ---------------------------------------------------------------------------
# training augmentations
# ---------------------------------------------------------------------------

def random_crop(img: Image.Image, size, pad_if_needed=False, fill=0,
                rng: Optional[random.Random] = None) -> Image.Image:
    if isinstance(size, int):
        size = (size, size)
    th, tw = size
    r = rng or random
    w, h = img.size
    if pad_if_needed and (w < tw or h < th):
        pad_w = max(tw - w, 0)
        pad_h = max(th - h, 0)
        color = (fill,) * len(img.getbands()) if isinstance(fill, int) else fill
        new = Image.new(img.mode, (w + pad_w, h + pad_h), color)
        new.paste(img, (pad_w // 2, pad_h // 2))
        img = new
        w, h = img.size
    if w == tw and h == th:
        return img
    left = r.randint(0, w - tw)
    top = r.randint(0, h - th)
    return img.crop((left, top, left + tw, top + th))


def rotation_matrix(center: Tuple[float, float], angle: float,
                    scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D (same closed form, float64)."""
    a = angle * math.pi / 180.0
    alpha, beta = scale * math.cos(a), scale * math.sin(a)
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform (double, same op order)."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0.0 else 0.0
    a11, a22 = m[1, 1] * d, m[0, 0] * d
    a12, a21 = -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], np.float64)


def _reflect101(p: np.ndarray, n: int) -> np.ndarray:
    if n == 1:
        return np.zeros_like(p)
    per = 2 * (n - 1)
    out = np.abs(p) % per
    return np.where(out >= n, per - out, out)


def warp_affine(arr: np.ndarray, m, border_value=None) -> np.ndarray:
    """Affine warp of a uint8 image with the forward 2x3 matrix ``m``:
    cv2.warpAffine(INTER_LINEAR) semantics under a fixed float recipe (f32
    row-constant + double product+add coordinates, f32 weight products,
    left-to-right tap sum, nearest-even rounding), the JAX package's
    ``_warp_affine_np``. Border REFLECT_101 when ``border_value`` is None,
    else CONSTANT."""
    f32, f64 = np.float32, np.float64
    m = np.asarray(m, f64).reshape(2, 3)
    im = _invert_affine(m)
    h, w = arr.shape[:2]
    arr3 = arr[:, :, None] if arr.ndim == 2 else arr
    ys, xs = np.mgrid[0:h, 0:w]
    ia = [f32(v) for v in im[0]]
    ib = [f32(v) for v in im[1]]
    rcx = (ia[1] * ys.astype(f32) + ia[2]).astype(f32)
    rcy = (ib[1] * ys.astype(f32) + ib[2]).astype(f32)
    sx = (f64(ia[0]) * xs + rcx.astype(f64)).astype(f32)
    sy = (f64(ib[0]) * xs + rcy.astype(f64)).astype(f32)
    x0 = np.floor(sx).astype(np.int64)
    y0 = np.floor(sy).astype(np.int64)
    fx = (sx - x0).astype(f32)
    fy = (sy - y0).astype(f32)
    w00 = ((1 - fx) * (1 - fy)).astype(f32)
    w01 = (fx * (1 - fy)).astype(f32)
    w10 = ((1 - fx) * fy).astype(f32)
    w11 = (fx * fy).astype(f32)
    c = arr3.shape[2]
    if border_value is None:
        x0r, x1r = _reflect101(x0, w), _reflect101(x0 + 1, w)
        y0r, y1r = _reflect101(y0, h), _reflect101(y0 + 1, h)

        def taps(ch):
            return (arr3[y0r, x0r, ch], arr3[y0r, x1r, ch],
                    arr3[y1r, x0r, ch], arr3[y1r, x1r, ch])
    else:
        bvv = np.asarray(border_value, f64).reshape(-1)
        if bvv.size > c:
            bvv = bvv[:c]  # cv2 Scalar semantics: extra entries ignored
        bv = np.clip(np.rint(np.broadcast_to(bvv, (c,))), 0, 255)

        def taps(ch):
            def get(yy, xx):
                ok = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
                v = arr3[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1), ch]
                return np.where(ok, v, np.uint8(bv[ch]))
            return (get(y0, x0), get(y0, x0 + 1),
                    get(y0 + 1, x0), get(y0 + 1, x0 + 1))

    out = np.empty_like(arr3)
    for ch in range(c):
        p00, p01, p10, p11 = (t.astype(f32) for t in taps(ch))
        v = p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11
        out[..., ch] = np.clip(np.rint(v), 0, 255).astype(np.uint8)
    return out[:, :, 0] if arr.ndim == 2 else out


def shift_scale_rotate(img: Image.Image, shift_limit=0.05, scale_limit=0.15,
                       rotate_limit=20, p=0.5, border_value=None) -> Image.Image:
    """albumentations ShiftScaleRotate equivalent (affine warp)."""
    if random.random() >= p:
        return img
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    angle = random.uniform(-rotate_limit, rotate_limit)
    scale = 1.0 + random.uniform(-scale_limit, scale_limit)
    dx = random.uniform(-shift_limit, shift_limit) * w
    dy = random.uniform(-shift_limit, shift_limit) * h
    m = rotation_matrix((w / 2, h / 2), angle, scale)
    m[0, 2] += dx
    m[1, 2] += dy
    return Image.fromarray(warp_affine(arr, m, border_value))


def random_affine(img: Image.Image, degrees=5, translate=(0.1, 0.1), fill=0,
                  p=1.0) -> Image.Image:
    """torchvision RandomAffine equivalent (rotation + translation)."""
    if random.random() >= p:
        return img
    arr = np.asarray(img)
    h, w = arr.shape[:2]
    angle = random.uniform(-degrees, degrees)
    tx = random.uniform(-translate[0], translate[0]) * w
    ty = random.uniform(-translate[1], translate[1]) * h
    m = rotation_matrix((w / 2, h / 2), angle, 1.0)
    m[0, 2] += tx
    m[1, 2] += ty
    bv = (fill,) * 3 if isinstance(fill, int) else fill
    return Image.fromarray(warp_affine(arr, m, bv))


def _pil_l_channel(arr: np.ndarray) -> np.ndarray:
    """PIL convert("L"): (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    return ((arr[..., 0].astype(np.uint32) * 19595
             + arr[..., 1].astype(np.uint32) * 38470
             + arr[..., 2].astype(np.uint32) * 7471 + 0x8000) >> 16)


def _jitter_hue_int(arr: np.ndarray, shift: int) -> np.ndarray:
    """Hue rotation through exact integer HSV (h = floor(255*num/(6*cr)),
    s = floor(255*cr/maxc), v = maxc) and PIL's float HSV->RGB back."""
    r = arr[..., 0].astype(np.int64)
    g = arr[..., 1].astype(np.int64)
    b = arr[..., 2].astype(np.int64)
    maxc = np.maximum(np.maximum(r, g), b)
    minc = np.minimum(np.minimum(r, g), b)
    cr = maxc - minc
    crs = np.maximum(cr, 1)
    num = np.where(r == maxc, g - b,
                   np.where(g == maxc, 2 * cr + (b - r), 4 * cr + (r - g)))
    num = num % (6 * crs)
    h = np.where(cr == 0, 0, (255 * num) // (6 * crs))
    s = np.where(cr == 0, 0, (255 * cr) // np.maximum(maxc, 1))
    v = maxc

    h = (h + shift) % 256
    f32 = np.float32
    hf = (h.astype(f32) / f32(255.0)).astype(f32)
    sf = (s.astype(f32) / f32(255.0)).astype(f32)
    vf = v.astype(f32)
    i6 = (hf * f32(6.0)).astype(np.int32)
    fr = (hf * f32(6.0) - i6.astype(f32)).astype(f32)
    p = (vf * (f32(1.0) - sf) + f32(0.5)).astype(np.int32)
    q = (vf * (f32(1.0) - sf * fr) + f32(0.5)).astype(np.int32)
    t = (vf * (f32(1.0) - sf * (f32(1.0) - fr)) + f32(0.5)).astype(np.int32)
    vi = v.astype(np.int32)
    im = i6 % 6

    def sel(*choices):
        return np.select([im == i for i in range(6)], choices)

    out = np.stack([sel(vi, q, p, p, t, vi),
                    sel(t, vi, vi, q, p, p),
                    sel(p, p, t, vi, vi, q)], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def _jitter_apply(arr: np.ndarray, ops) -> np.ndarray:
    """The jitter op sequence on a uint8 RGB array. Brightness, contrast
    and saturation are PIL ImageEnhance bit-exact (float32 blend with the
    degenerate image, truncating cast)."""
    f32 = np.float32
    for op, f in ops:
        x = arr.astype(f32)
        if op == "brightness":
            arr = np.clip((f32(f) * x).astype(np.int32), 0, 255).astype(np.uint8)
        elif op == "contrast":
            mean = f32(int(_pil_l_channel(arr).mean() + 0.5))
            arr = np.clip((mean + f32(f) * (x - mean)).astype(np.int32),
                          0, 255).astype(np.uint8)
        elif op == "saturation":
            l = _pil_l_channel(arr).astype(f32)[..., None]
            arr = np.clip((l + f32(f) * (x - l)).astype(np.int32),
                          0, 255).astype(np.uint8)
        elif op == "hue":
            arr = _jitter_hue_int(arr, int(f))
    return arr


def color_jitter(img: Image.Image, brightness=0.3, contrast=0.3, saturation=0.3,
                 hue=0.3, p=0.5) -> Image.Image:
    """torchvision ColorJitter equivalent (random order of 4 adjustments)."""
    if random.random() >= p:
        return img
    ops = []
    if brightness:
        ops.append(("brightness",
                    random.uniform(max(0, 1 - brightness), 1 + brightness)))
    if contrast:
        ops.append(("contrast",
                    random.uniform(max(0, 1 - contrast), 1 + contrast)))
    if saturation:
        ops.append(("saturation",
                    random.uniform(max(0, 1 - saturation), 1 + saturation)))
    if hue:
        ops.append(("hue", int(random.uniform(-hue, hue) * 255)))
    random.shuffle(ops)
    arr = np.asarray(img, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return img
    return Image.fromarray(_jitter_apply(arr, ops))


class GaussianBlur:
    """PIL Gaussian blur with a random radius, applied with probability p."""

    def __init__(self, p=0.5, radius_min=0.1, radius_max=2.0):
        self.prob = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img):
        if random.random() > self.prob:
            return img
        radius = random.uniform(self.radius_min, self.radius_max)
        return img.filter(ImageFilter.GaussianBlur(radius=radius))
