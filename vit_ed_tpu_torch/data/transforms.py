"""Image transforms of the scoring and training paths.

The port's copy of the pieces of ``vit_ed_tpu/data/transforms.py`` that
the hisfrag and DIV2K entries use. Eval: ``open_rgb``, ``resize``,
``center_crop``, ``to_tensor``, ``normalize``, ``as_sample_array``,
``OneImgEval`` and ``TwoImgSyncEval``. Training: ``random_affine``,
``shift_scale_rotate`` (both through ``warp_affine``, an affine warp with
cv2 INTER_LINEAR semantics), ``rgb_shift``, ``random_crop``,
``color_jitter``, ``GaussianBlur`` and ``normalize_image``; ``crop`` splits
an image into the puzzle grid.

The numeric work runs in the native pipeline (``native/pipeline.cc``,
built with g++ at the first call) wherever it takes the input: JPEG decode
(``open_rgb``), the warp, the jitter, the blur, normalize and the fused
crop -> resize -> normalize of the eval transforms. It is bit-exact against
the PIL / numpy chain, which stays here as each step's plain version under
its own name (``open_rgb_plain``, ``warp_affine_plain``, ``jitter_plain``,
``normalize_image_plain``; the blur's is PIL's filter) and runs only on
inputs the native code does not take: images that are not RGB (``_native_ok``),
and the padding cases of the eval crops. The random draws come from
Python's ``random`` in the JAX package's order and stay in Python, so one
seed gives the same augmentations in both packages. Outputs are NHWC numpy
arrays, float32 normalized with mean = std = 0.5, or raw uint8 with
``emit_u8``.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageFilter

from vit_ed_tpu_torch.native import pipeline as npipe


def _native_ok(x) -> bool:
    """Whether the native pipeline takes ``x``: a PIL image in mode RGB, or
    (the warp) a u8 HWC array."""
    if isinstance(x, Image.Image):
        return x.mode == "RGB"
    return isinstance(x, np.ndarray) and x.ndim == 3


def open_rgb_plain(path: str) -> Image.Image:
    """``Image.open(path).convert("RGB")`` with the file closed afterwards."""
    with Image.open(path) as f:
        return f.convert("RGB")


def open_rgb(path: str) -> Image.Image:
    """``open_rgb_plain`` with .jpg / .jpeg files decoded by the native
    libjpeg decoder where it decodes as PIL does (``npipe.decode_route``);
    a stream it rejects, and every other file, goes to PIL."""
    if (path.lower().endswith((".jpg", ".jpeg"))
            and npipe.decode_route() == "libjpeg"):
        with open(path, "rb") as f:
            arr = npipe.decode_jpeg(f.read())
        if arr is not None:
            return Image.fromarray(arr)
    return open_rgb_plain(path)


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


def _resize_target(h: int, w: int, size) -> Tuple[int, int]:
    """(out_h, out_w) of ``resize`` on an h x w image."""
    if isinstance(size, int):
        if (w <= h and w == size) or (h <= w and h == size):
            return h, w
        if w < h:
            return int(size * h / w), size
        return size, int(size * w / h)
    return size[0], size[1]


def resize(img: Image.Image, size, interpolation=Image.BILINEAR) -> Image.Image:
    """torchvision Resize semantics: an int size resizes the SHORTER side."""
    h, w = _resize_target(img.height, img.width, size)
    if (h, w) == (img.height, img.width):
        return img
    return img.resize((w, h), interpolation)


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
    """Center-crop (or resize) + normalize a single image: on an RGB image
    the native fused crop -> resize -> normalize (``pool_crop`` gives its
    rectangle and size), else the plain chain (a crop larger than the
    image pads it first).

    ``emit_u8`` skips the host normalize and returns the cropped uint8
    array; the model then normalizes on the device ((x/255 - 0.5)/0.5,
    ViTED._embed)."""

    def __init__(self, image_size, crop=False, emit_u8=False):
        self.image_size = image_size
        self.crop = crop
        self.emit_u8 = emit_u8

    def pool_crop(self, shape_hw):
        """(crop rect (y0, x0, h, w), output size) of the native fused prep
        for an image of ``shape_hw``, or None where the plain chain runs
        (the padding case, or the u8 wire: the prep emits normalized f32).
        The loader's and the scorer's whole-batch pools read it too."""
        if self.emit_u8:
            return None
        h, w = shape_hw
        if not self.crop:
            return (0, 0, h, w), _resize_target(h, w, self.image_size)
        th, tw = ((self.image_size, self.image_size)
                  if isinstance(self.image_size, int) else self.image_size)
        if w < tw or h < th:
            return None
        left = int(round((w - tw) / 2.0))
        top = int(round((h - th) / 2.0))
        return (top, left, th, tw), (th, tw)

    def __call__(self, img):
        if _native_ok(img):
            pc = self.pool_crop((img.height, img.width))
            if pc is not None:
                return npipe.prep(img, pc[1], crop=pc[0])
        img = (center_crop(img, self.image_size) if self.crop
               else resize(img, self.image_size))
        if self.emit_u8:
            arr = np.asarray(img, np.uint8)
            return arr[:, :, None] if arr.ndim == 2 else arr
        return normalize(to_tensor(img))


class TwoImgSyncEval:
    """Resize + normalize both images of a pair (native ``prep`` on RGB)."""

    def __init__(self, image_size):
        self.image_size = image_size

    def _one(self, img: Image.Image) -> np.ndarray:
        if _native_ok(img):
            return npipe.prep(img, _resize_target(img.height, img.width,
                                                  self.image_size))
        return normalize(to_tensor(resize(img, self.image_size)))

    def __call__(self, first_img, second_img):
        return self._one(first_img), self._one(second_img)


def normalize_image_plain(img: Image.Image, mean=(0.5, 0.5, 0.5),
                          std=(0.5, 0.5, 0.5)) -> np.ndarray:
    return normalize(to_tensor(img), mean, std)


def normalize_image(img: Image.Image, mean=(0.5, 0.5, 0.5),
                    std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """``normalize(to_tensor(img))``, in one native pass on RGB."""
    if _native_ok(img):
        return npipe.normalize_u8(np.asarray(img), mean, std)
    return normalize_image_plain(img, mean, std)


def crop(im: Image.Image, n_cols: int, n_rows: int):
    """Split an image into a row-major grid of n_rows x n_cols patches."""
    width = im.width // n_cols
    height = im.height // n_rows
    patches = []
    for i in range(n_rows):
        for j in range(n_cols):
            box = (j * width, i * height, (j + 1) * width, (i + 1) * height)
            patches.append(im.crop(box))
    return patches


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


def warp_affine_plain(arr: np.ndarray, m, border_value=None) -> np.ndarray:
    """Affine warp of a uint8 image with the forward 2x3 matrix ``m``:
    cv2.warpAffine(INTER_LINEAR) semantics under a fixed float recipe (f32
    row-constant + double product+add coordinates, f32 weight products,
    left-to-right tap sum, nearest-even rounding), the numpy mirror of
    ``native/pipeline.cc::warp_affine_u8``. Border REFLECT_101 when
    ``border_value`` is None, else CONSTANT."""
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


def warp_affine(arr: np.ndarray, m, border_value=None) -> np.ndarray:
    """``warp_affine_plain`` in the native pipeline for an HWC array."""
    if _native_ok(arr):
        return npipe.warp_affine(arr, m, border_value)
    return warp_affine_plain(arr, m, border_value)


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


def rgb_shift(img: Image.Image, limit=15, p=0.5) -> Image.Image:
    """albumentations RGBShift equivalent."""
    if random.random() >= p:
        return img
    arr = np.asarray(img).astype(np.int16)
    for c in range(min(3, arr.shape[-1])):
        arr[..., c] += random.randint(-limit, limit)
    return Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8))


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


def jitter_plain(arr: np.ndarray, ops) -> np.ndarray:
    """The jitter op sequence on a uint8 RGB array, the numpy mirror of
    ``native/pipeline.cc::vt_color_jitter``. Brightness, contrast and
    saturation are PIL ImageEnhance bit-exact (float32 blend with the
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
    if _native_ok(img):
        return Image.fromarray(npipe.color_jitter(img, ops))
    arr = np.asarray(img, np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        return img
    return Image.fromarray(jitter_plain(arr, ops))


class GaussianBlur:
    """PIL Gaussian blur with a random radius, applied with probability p
    (native box passes on RGB, bit-exact against PIL's filter)."""

    def __init__(self, p=0.5, radius_min=0.1, radius_max=2.0):
        self.prob = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img):
        if random.random() > self.prob:
            return img
        radius = random.uniform(self.radius_min, self.radius_max)
        if _native_ok(img):
            return Image.fromarray(npipe.gaussian_blur(np.asarray(img), radius))
        return img.filter(ImageFilter.GaussianBlur(radius=radius))
