"""OpenCV-free image I/O and 8-bit CIE L*a*b* conversions for the puzzle path.

The JAX package cuts its puzzle pieces with OpenCV: ``cv2.imread``,
``cv2.cvtColor`` (BGR -> LAB for the pieces, LAB -> RGB for the network's
input, LAB -> BGR for the reconstructions), ``cv2.copyMakeBorder`` and
``cv2.imwrite``. The port runs where OpenCV is not installed, so this module
holds their counterparts, equal to OpenCV's on uint8 input:

- ``bgr2lab_u8``, ``lab2rgb_u8``, ``lab2bgr_u8``: OpenCV's 8-bit path
  (``imgproc/src/color_lab.cpp``: ``RGB2Lab_b`` and ``Lab2RGBinteger``) in
  numpy, from its fixed-point coefficients and lookup tables. The tables are
  built here the way OpenCV builds them (IEEE float32 arithmetic, round half
  to even; the cube root is OpenCV's rational approximation with its
  result's mantissa cut to float32, which decides one table entry that a
  correctly rounded cube root would round the other way). A textbook float
  formula is not enough: it differs from OpenCV's ``BGR2LAB`` on about a
  quarter of all colours, and the network sees LAB -> RGB round trips.
  ``tests/test_torch_color.py`` holds all three against ``cv2.cvtColor``
  on all 2^24 inputs.
- ``imread_bgr``: ``cv2.imread(path)`` (``IMREAD_COLOR``): EXIF orientation
  applied, alpha dropped, grey replicated to three channels, 16-bit samples
  reduced to their high byte; JPEG files go through the port's decoder
  (``data/transforms.open_rgb``, native libjpeg where it decodes as PIL).
- ``pad_constant``: ``cv2.copyMakeBorder(..., BORDER_CONSTANT, value)``.
- ``imwrite``: ``cv2.imwrite`` through PIL (JPEG at OpenCV's default
  quality 95).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.data.transforms import open_rgb

_f32 = np.float32
LAB_SHIFT = 12           # fixed-point shift of the RGB <-> XYZ coefficients
GAMMA_SHIFT = 3          # extra bits of the 8-bit gamma table
LAB_SHIFT2 = LAB_SHIFT + GAMMA_SHIFT
BASE_SHIFT = 14          # fixed point of the LAB -> XYZ path
INV_GAMMA_SIZE = 1 << 12
MIN_AB = -8145           # first index of the a/b -> X/Z table

# sRGB D65 (OpenCV's constants)
_D65 = (0.950456, 1.0, 1.088754)
_RGB2XYZ = (0.412453, 0.357580, 0.180423,
            0.212671, 0.715160, 0.072169,
            0.019334, 0.119193, 0.950227)
_XYZ2RGB = (3.240479, -1.53715, -0.498535,
            -0.969256, 1.875991, 0.041556,
            0.055648, -0.204043, 1.057311)
# OpenCV's quartic rational approximation of the cube root on [1/8, 1)
_CBRT_P = (45.2548339756803022511987494, 192.2798368355061050458134625,
           119.1654824285581628956914143, 13.43250139086239872172837314,
           0.1636161226585754240958355063)
_CBRT_Q = (14.80884093219134573786480845, 151.9714051044435648658557668,
           168.5254414101568283957668343, 33.9905941350215598754191872, 1.0)


def _round(x) -> int:
    """cvRound: to the nearest integer, half to even."""
    return int(np.rint(np.float64(x)))


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _gamma(x: np.float32) -> np.float32:
    """sRGB companding, linear <- encoded (in float64, rounded to float32)."""
    xd = float(x)
    if xd <= 809 / 20000:
        return _f32(xd / (323 / 25))
    return _f32(((xd + 11 / 200) / (1 + 11 / 200)) ** (12 / 5))


def _inv_gamma(x: np.float32) -> np.float32:
    """sRGB companding, encoded <- linear."""
    xd = float(x)
    if xd <= 7827 / 2500000:
        return _f32(xd * (323 / 25))
    return _f32(xd ** (1 / (12 / 5)) * (1 + 11 / 200) - 11 / 200)


def _cbrt(x: np.float32) -> np.float32:
    """OpenCV's cube root of a positive float32: the mantissa scaled into
    [1/8, 1), the rational approximation in float64, the exponent restored,
    and the float64 result cut (not rounded) to float32."""
    m, e = math.frexp(float(x))
    ex = e - 1
    shx = int(math.fmod(ex, 3))
    if shx >= 0:
        shx -= 3
    fr = 2.0 * m * 2.0 ** shx
    p, q = _CBRT_P[0], _CBRT_Q[0]
    for c in _CBRT_P[1:]:
        p = p * fr + c
    for c in _CBRT_Q[1:]:
        q = q * fr + c
    bits = np.float64(p / q * 2.0 ** ((ex - shx) // 3)).view(np.uint64)
    return _f32((bits & ~np.uint64((1 << 29) - 1)).view(np.float64))


@functools.lru_cache(maxsize=None)
def _tables():
    """OpenCV's 8-bit LAB lookup tables (``initLabTabs``)."""
    gamma = np.array([_round(_f32(255 * (1 << GAMMA_SHIFT)) * _gamma(_f32(i) / _f32(255)))
                      for i in range(256)], np.int64)
    inv_gamma = np.array([_round(_f32(255) * _inv_gamma(_f32(1) / _f32(INV_GAMMA_SIZE) * _f32(i)))
                          for i in range(INV_GAMMA_SIZE)], np.int64)

    lthresh = _f32(216) / _f32(24389)
    lscale = _f32(841) / _f32(108)
    lbias = _f32(16) / _f32(116)
    step = _f32(1) / (_f32(255) * _f32(1 << GAMMA_SHIFT))
    cbrt = np.empty(256 * 3 // 2 * (1 << GAMMA_SHIFT), np.int64)
    for i in range(len(cbrt)):
        x = step * _f32(i)
        # mulAdd: one rounding of the exact x * lscale + lbias
        f = (_f32(np.float64(x) * np.float64(lscale) + np.float64(lbias))
             if x < lthresh else _cbrt(x))
        cbrt[i] = _round(_f32(1 << LAB_SHIFT2) * f)

    base = 1 << BASE_SHIFT
    l_to_yf = np.empty((256, 2), np.int64)
    for i in range(256):
        if i <= 20:
            y = _round(_f32(i * base * 20 * 9) / _f32(17 * 29 * 29 * 29))
            ify = _round(_f32(base) * (_f32(16) / _f32(116) + _f32(i * 5) / _f32(3 * 17 * 29)))
        else:
            fy = _f32(i * 100 * base) / _f32(255 * 116) + _f32(16 * base) / _f32(116)
            ify = _round(fy)
            y = _round(fy * fy * fy / _f32(base * base))
        l_to_yf[i] = (y, ify)

    ab_to_xz = np.empty(base * 9 // 4, np.int64)
    offset = _cdiv(_cdiv(base * 16, 116) * 108, 841)
    for i in range(MIN_AB, MIN_AB + len(ab_to_xz)):
        ab_to_xz[i - MIN_AB] = (_cdiv(i * 108, 841) - offset if i <= 3390
                                else _cdiv(_cdiv(i * i, base) * i, base))
    return gamma, inv_gamma, cbrt, l_to_yf, ab_to_xz


def _rgb2lab_coeffs(blue_idx: int) -> np.ndarray:
    """[3 (X, Y, Z), 3 (input channels)] fixed-point coefficients, the
    white point divided out."""
    co = np.empty((3, 3), np.int64)
    for i in range(3):
        r, g, b = _RGB2XYZ[3 * i: 3 * i + 3]
        co[i, blue_idx ^ 2] = _round((1 << LAB_SHIFT) * r / _D65[i])
        co[i, 1] = _round((1 << LAB_SHIFT) * g / _D65[i])
        co[i, blue_idx] = _round((1 << LAB_SHIFT) * b / _D65[i])
    return co


def _lab2rgb_coeffs(blue_idx: int) -> np.ndarray:
    """[3 (output channels), 3 (X, Y, Z)] fixed-point coefficients, the
    white point multiplied in."""
    co = np.empty((3, 3), np.int64)
    for i in range(3):
        r, g, b = _XYZ2RGB[i], _XYZ2RGB[i + 3], _XYZ2RGB[i + 6]
        co[blue_idx ^ 2, i] = _round((1 << LAB_SHIFT) * r * _D65[i])
        co[1, i] = _round((1 << LAB_SHIFT) * g * _D65[i])
        co[blue_idx, i] = _round((1 << LAB_SHIFT) * b * _D65[i])
    return co


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _check_u8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.shape[-1:] != (3,):
        raise ValueError(f"expected a uint8 [..., 3] image, got {img.dtype} {img.shape}")
    return img


def _blocked(fn, img: np.ndarray, blue_idx: int) -> np.ndarray:
    """``fn`` over the pixels of ``img`` in blocks of 2^20 (the int64
    intermediates of a whole 4096 x 4096 image would take gigabytes)."""
    img = _check_u8(img)
    flat = img.reshape(-1, 3)
    out = np.empty_like(flat)
    for lo in range(0, len(flat), 1 << 20):
        out[lo:lo + (1 << 20)] = fn(flat[lo:lo + (1 << 20)], blue_idx)
    return out.reshape(img.shape)


def _to_lab(px: np.ndarray, blue_idx: int) -> np.ndarray:
    gamma, _, cbrt, _, _ = _tables()
    co = _rgb2lab_coeffs(blue_idx)
    lin = gamma[px]                                    # [P, 3]
    fx, fy, fz = (cbrt[_descale(lin @ co[i], LAB_SHIFT)] for i in range(3))
    l_scale = (116 * 255 + 50) // 100
    l_shift = -((16 * 255 * (1 << LAB_SHIFT2) + 50) // 100)
    half = 128 * (1 << LAB_SHIFT2)
    lab = np.stack([_descale(l_scale * fy + l_shift, LAB_SHIFT2),
                    _descale(500 * (fx - fy) + half, LAB_SHIFT2),
                    _descale(200 * (fy - fz) + half, LAB_SHIFT2)], -1)
    return np.clip(lab, 0, 255).astype(np.uint8)


def _from_lab(px: np.ndarray, blue_idx: int) -> np.ndarray:
    _, inv_gamma, _, l_to_yf, ab_to_xz = _tables()
    co = _lab2rgb_coeffs(blue_idx)
    lab = px.astype(np.int64)
    L, a, b = lab[:, 0], lab[:, 1], lab[:, 2]
    base = 1 << BASE_SHIFT
    y, ify = l_to_yf[L, 0], l_to_yf[L, 1]
    # a * BASE / 500 and b * BASE / 200 in OpenCV's integer approximation
    adiv = ((5 * a * 53687 + (1 << 7)) >> 13) - 128 * base // 500
    bdiv = ((b * 41943 + (1 << 4)) >> 9) - 128 * base // 200 + 1
    xyz = np.stack([ab_to_xz[ify + adiv - MIN_AB], y,
                    ab_to_xz[ify - bdiv - MIN_AB]], -1)
    shift = LAB_SHIFT + BASE_SHIFT - 12
    out = np.clip(_descale(xyz @ co.T, shift), 0, INV_GAMMA_SIZE - 1)
    return inv_gamma[out].astype(np.uint8)


def bgr2lab_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_BGR2LAB)`` for a uint8 [..., 3] image."""
    return _blocked(_to_lab, img, 0)


def lab2rgb_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_LAB2RGB)`` for a uint8 [..., 3] image."""
    return _blocked(_from_lab, img, 2)


def lab2bgr_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_LAB2BGR)`` for a uint8 [..., 3] image."""
    return _blocked(_from_lab, img, 0)


# EXIF orientation -> the PIL transposition that undoes it
_ORIENT = {2: Image.Transpose.FLIP_LEFT_RIGHT, 3: Image.Transpose.ROTATE_180,
           4: Image.Transpose.FLIP_TOP_BOTTOM, 5: Image.Transpose.TRANSPOSE,
           6: Image.Transpose.ROTATE_270, 7: Image.Transpose.TRANSVERSE,
           8: Image.Transpose.ROTATE_90}


def imread_bgr(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path)``: a uint8 [H, W, 3] BGR array, or None when the
    file is not an image."""
    try:
        with Image.open(path) as im:
            orientation = im.getexif().get(0x0112, 1)
            if im.mode.startswith("I;16") or im.mode == "I":
                # 16-bit grey: the high byte, as OpenCV's 16 -> 8 bit read
                grey = (np.asarray(im).astype(np.uint32) >> 8).astype(np.uint8)
                rgb = Image.fromarray(np.repeat(grey[..., None], 3, axis=-1))
            else:
                rgb = None
        if rgb is None:
            rgb = open_rgb(path)
    except OSError:    # PIL's UnidentifiedImageError is an OSError
        return None
    if orientation in _ORIENT:
        rgb = rgb.transpose(_ORIENT[orientation])
    return np.ascontiguousarray(np.asarray(rgb)[:, :, ::-1])


def pad_constant(img: np.ndarray, top: int, bottom: int, left: int,
                 right: int, value: Sequence[int] = (0, 0, 0)) -> np.ndarray:
    """``cv2.copyMakeBorder(img, top, bottom, left, right,
    cv2.BORDER_CONSTANT, value=value)`` for an [H, W, C] image."""
    out = np.empty((img.shape[0] + top + bottom, img.shape[1] + left + right)
                   + img.shape[2:], img.dtype)
    out[...] = np.asarray(value, img.dtype)[: img.shape[2]]
    out[top:top + img.shape[0], left:left + img.shape[1]] = img
    return out


def imwrite(filename: str, img: np.ndarray) -> bool:
    """``cv2.imwrite(filename, img)`` for a uint8 BGR [H, W, 3] image; the
    format follows the extension, JPEG at quality 95."""
    rgb = Image.fromarray(np.ascontiguousarray(img[:, :, ::-1]))
    if filename.lower().endswith((".jpg", ".jpeg")):
        rgb.save(filename, quality=95)
    else:
        rgb.save(filename)
    return True
