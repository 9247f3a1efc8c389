"""ctypes binding of the native input pipeline (``native/pipeline.cc``).

Every function here is bit-exact against its plain version, the PIL /
numpy chain of ``data/transforms.py`` (``tests/test_torch_native_pipeline.py``):

- ``resize_u8`` (crop, then PIL BILINEAR / BICUBIC resize), ``normalize_u8``
  ((x / 255 - mean) / std), ``prep`` (the three fused), ``white_percentage``;
- ``color_jitter`` (PIL ImageEnhance brightness / contrast / saturation and
  the integer-HSV hue shift), ``warp_affine`` (cv2 INTER_LINEAR semantics
  under one float recipe), ``gaussian_blur`` (PIL GaussianBlur; plain
  version ``gaussian_blur_plain``, the numpy mirror of Pillow's box passes);
- ``decode_jpeg`` (libjpeg, PIL's defaults);
- ``PipelinePool.prep_batch``: ``prep`` over a whole batch on a pool of C++
  threads, with the GIL released for the whole call.

The library is built at the first call (``ops/_build.py``) with
``-pthread -ffp-contract=off -march=native -fno-math-errno``: bit-exactness
relies on no implicit fma and no fast-math, so these flags stay as they
are. libjpeg is linked when the compiler finds ``jpeglib.h`` and
``-ljpeg``, and the linked decoder is used only where it decodes a probe
image set exactly as PIL does (``decode_route``); otherwise JPEG files are
decoded by PIL, and ``build_info`` says so. A failed build raises.
"""

from __future__ import annotations

import ctypes
import io
import logging
import math
import os
import subprocess
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vit_ed_tpu_torch.ops._build import host_cpu, load_host

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "pipeline.cc")
FLAGS = ["-pthread", "-ffp-contract=off", "-march=native", "-fno-math-errno"]
BILINEAR = 0
BICUBIC = 1

_u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# how the library was built: seconds, jpeg (linked), decode_route ("libjpeg"
# or "PIL"), cpu, path; filled by the first call
build_info: Dict[str, object] = {}
_log = logging.getLogger(__name__)

_JPEG_PROBE = (b"#include <cstdio>\n#include <jpeglib.h>\n"
               b"int main() { jpeg_decompress_struct c; jpeg_error_mgr e;\n"
               b"  c.err = jpeg_std_error(&e); jpeg_create_decompress(&c);\n"
               b"  jpeg_destroy_decompress(&c); return 0; }\n")


def _has_libjpeg() -> bool:
    """Whether g++ finds jpeglib.h and links -ljpeg."""
    res = subprocess.run(["g++", "-x", "c++", "-", "-o", os.devnull, "-ljpeg"],
                         input=_JPEG_PROBE, capture_output=True)
    return res.returncode == 0


def _declare(lib: ctypes.CDLL) -> None:
    lib.vt_resize_u8.restype = ctypes.c_int
    lib.vt_resize_u8.argtypes = [_u8] + [ctypes.c_int] * 7 + [_u8] + \
        [ctypes.c_int] * 3
    lib.vt_normalize_u8.restype = None
    lib.vt_normalize_u8.argtypes = [_u8, ctypes.c_int64, ctypes.c_int,
                                    _f32, _f32, _f32]
    lib.vt_white_percentage.restype = ctypes.c_float
    lib.vt_white_percentage.argtypes = [_u8] + [ctypes.c_int] * 4
    lib.vt_prep_one.restype = ctypes.c_int
    lib.vt_prep_one.argtypes = [_u8] + [ctypes.c_int] * 10 + [_f32, _f32, _f32]
    lib.vt_color_jitter.restype = None
    lib.vt_color_jitter.argtypes = [_u8, ctypes.c_int64, _i32, _f32,
                                    ctypes.c_int]
    lib.vt_warp_affine_u8.restype = None
    lib.vt_warp_affine_u8.argtypes = [_u8] + [ctypes.c_int] * 3 + \
        [np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"), _u8,
         ctypes.c_int, _u8]
    lib.vt_gaussian_blur_u8.restype = None
    lib.vt_gaussian_blur_u8.argtypes = [_u8] + [ctypes.c_int] * 3 + \
        [ctypes.c_float, _u8]
    lib.vt_jpeg_dims.restype = ctypes.c_int
    lib.vt_jpeg_dims.argtypes = [_u8, ctypes.c_int64, _i32]
    lib.vt_jpeg_decode.restype = ctypes.c_int
    lib.vt_jpeg_decode.argtypes = [_u8, ctypes.c_int64, _u8, ctypes.c_int,
                                   ctypes.c_int]
    lib.vt_pool_create.restype = ctypes.c_void_p
    lib.vt_pool_create.argtypes = [ctypes.c_int]
    lib.vt_pool_destroy.restype = None
    lib.vt_pool_destroy.argtypes = [ctypes.c_void_p]
    lib.vt_pool_prep_batch.restype = ctypes.c_int
    lib.vt_pool_prep_batch.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        _i32, _i32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, _f32, _f32, _f32]


def _jpeg_probe_images():
    """JPEG byte strings of a few kinds (baseline 4:2:0 and 4:4:4,
    progressive, grayscale), made by PIL from a seed."""
    from PIL import Image

    rng = np.random.default_rng(0)
    rgb = Image.fromarray(rng.integers(0, 256, (37, 53, 3), np.uint8))
    gray = Image.fromarray(rng.integers(0, 256, (29, 31), np.uint8), "L")
    out = []
    for img, kw in ((rgb, {"quality": 90}), (rgb, {"quality": 75, "subsampling": 0}),
                    (rgb, {"quality": 85, "progressive": True}), (gray, {"quality": 85})):
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **kw)
        out.append(buf.getvalue())
    return out


def _decodes_like_pil(lib: ctypes.CDLL) -> bool:
    from PIL import Image

    for data in _jpeg_probe_images():
        got = _decode(lib, data)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        if got is None or not np.array_equal(got, want):
            return False
    return True


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:   # lock-free fast path for the per-item hot loop
        return _lib
    with _lock:
        if _lib is None:
            t0 = time.time()
            jpeg = _has_libjpeg()
            lib = load_host(SRC, FLAGS + (["-ljpeg"] if jpeg else ["-DVT_NO_JPEG"]))
            _declare(lib)
            route = "libjpeg" if jpeg and _decodes_like_pil(lib) else "PIL"
            build_info.update(seconds=time.time() - t0, jpeg=jpeg, decode_route=route,
                              cpu=host_cpu().split(" | ")[0], path=lib._name)
            if route == "PIL":
                _log.warning(
                    "native pipeline: JPEG files are decoded by PIL (%s)",
                    "libjpeg decodes the probe images unlike PIL" if jpeg
                    else "no jpeglib.h / -ljpeg for g++")
            _lib = lib
    return _lib


def decode_route() -> str:
    """``"libjpeg"`` when ``decode_jpeg`` decodes JPEG files, ``"PIL"``
    when the library has no decoder or its libjpeg differs from PIL's."""
    _load()
    return build_info["decode_route"]


def _as_u8(img) -> np.ndarray:
    arr = np.ascontiguousarray(np.asarray(img, np.uint8))
    if arr.ndim == 2:
        arr = arr[:, :, None]
    return arr


def _f32v(x, c: int) -> np.ndarray:
    v = np.asarray(x, np.float32)
    if v.ndim > 0 and v.shape[0] not in (1, c):
        # numpy would broadcast (h, w, 1) against (3,) into a DIFFERENT
        # output shape: reject rather than diverge
        raise ValueError(f"mean/std of length {v.shape[0]} does not match "
                         f"{c} channels")
    return np.ascontiguousarray(np.broadcast_to(v, (c,)))


def resize_u8(img, size: Tuple[int, int], filter: int = BILINEAR,
              crop: Optional[Tuple[int, int, int, int]] = None) -> np.ndarray:
    """Crop (y0, x0, h, w), then resize to (oh, ow): bit-exact against
    ``PIL.Image.crop(...).resize(..., BILINEAR | BICUBIC)`` on uint8."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    y0, x0, ch_, cw_ = crop if crop is not None else (0, 0, h, w)
    oh, ow = size
    out = np.empty((oh, ow, c), np.uint8)
    if lib.vt_resize_u8(arr, h, w, c, y0, x0, ch_, cw_, out, oh, ow, filter):
        raise ValueError(f"vt_resize_u8 failed (crop {crop} of {arr.shape})")
    return out


def normalize_u8(img, mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Fused (x / 255 - mean) / std, u8 HWC -> f32 HWC."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    out = np.empty((h, w, c), np.float32)
    lib.vt_normalize_u8(arr, h * w, c, _f32v(mean, c), _f32v(std, c), out)
    return out


def white_percentage(img, ref_size: int = 224) -> float:
    """PIL "L" convert, BICUBIC shrink to (ref, ref) when wider, the
    fraction of pixels > 250."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    return float(lib.vt_white_percentage(arr, h, w, c, ref_size))


def prep(img, size: Tuple[int, int],
         crop: Optional[Tuple[int, int, int, int]] = None,
         filter: int = BILINEAR, mean=(0.5, 0.5, 0.5),
         std=(0.5, 0.5, 0.5)) -> np.ndarray:
    """Fused crop -> resize -> normalize, u8 HWC -> f32 HWC."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    y0, x0, ch_, cw_ = crop if crop is not None else (0, 0, h, w)
    oh, ow = size
    out = np.empty((oh, ow, c), np.float32)
    if lib.vt_prep_one(arr, h, w, c, y0, x0, ch_, cw_, oh, ow, filter,
                       _f32v(mean, c), _f32v(std, c), out):
        raise ValueError(f"vt_prep_one failed (crop {crop} of {arr.shape})")
    return out


_JITTER_CODES = {"brightness": 0, "contrast": 1, "saturation": 2, "hue": 3}


def color_jitter(img, ops) -> np.ndarray:
    """The jitter op sequence on a copy of an RGB u8 image. ``ops`` is a
    sequence of (op, factor): "brightness", "contrast" or "saturation" with
    a PIL ImageEnhance factor, or ("hue", integer shift in [-255, 255])."""
    lib = _load()
    arr = _as_u8(img).copy()
    h, w, c = arr.shape
    if c != 3:
        raise ValueError("color_jitter requires RGB")
    op_arr = np.asarray([_JITTER_CODES[o] for o, _ in ops], np.int32)
    f_arr = np.asarray([f for _, f in ops], np.float32)
    lib.vt_color_jitter(arr.reshape(-1), h * w, op_arr, f_arr, len(ops))
    return arr


def warp_affine(img, m, border_value=None) -> np.ndarray:
    """Affine warp of a u8 HWC image with the forward 2x3 matrix ``m``;
    ``border_value`` None is BORDER_REFLECT_101, a scalar or tuple
    BORDER_CONSTANT (cv2 Scalar semantics: extra entries are ignored)."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    m = np.ascontiguousarray(np.asarray(m, np.float64).reshape(6))
    out = np.empty_like(arr)
    if border_value is None:
        border, mode = np.zeros(c, np.uint8), 0
    else:
        v = np.asarray(border_value, np.float64).reshape(-1)[:c]
        border = np.ascontiguousarray(
            np.clip(np.rint(np.broadcast_to(v, (c,))), 0, 255).astype(np.uint8))
        mode = 1
    lib.vt_warp_affine_u8(arr, h, w, c, m, out, mode, border)
    return out


def gaussian_blur(img, radius: float) -> np.ndarray:
    """PIL ImageFilter.GaussianBlur(radius) on a u8 HWC image, with the box
    passes SIMD-wide."""
    lib = _load()
    arr = _as_u8(img)
    h, w, c = arr.shape
    out = np.empty_like(arr)
    lib.vt_gaussian_blur_u8(arr, h, w, c, float(radius), out)
    return out


def _blur_params(radius: float, passes: int = 3):
    """Pillow BoxBlur.c's box radius and 24.8 fixed-point weights, with the
    C FLOAT (not double) rounding of ImagingGaussianBlur's locals: the box
    radius, ww and fw must round as Pillow's or outputs shift by one at
    some radii (the dense radius sweep of the tests)."""
    f32 = np.float32
    r = f32(radius)
    sigma2 = f32(f32(r * r) / f32(passes))
    L = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f32(math.floor((float(L) - 1.0) / 2.0))
    num = f32(f32(f32(2) * l + f32(1))
              * f32(f32(l * f32(l + f32(1))) - f32(3) * sigma2))
    den = f32(f32(6) * f32(sigma2 - f32(f32(l + f32(1)) * f32(l + f32(1)))))
    fr = f32(l + f32(num / den))
    ri = int(fr)
    ww = int(f32(f32(1 << 24) / f32(fr * f32(2) + f32(1))))
    fw = ((1 << 24) - (ri * 2 + 1) * ww) // 2
    return ri, ww, fw


def _box_pass_np(arr: np.ndarray, radius: int, ww: int, fw: int) -> np.ndarray:
    """One box-blur pass along axis 0 of [n, ...] u8 (Pillow's line blur:
    integer running window, fractional edge weights, per-pass rounding)."""
    n = arr.shape[0]
    last = n - 1
    edge_a = min(radius + 1, n)
    edge_b = max(n - radius - 1, 0)
    lin = arr.astype(np.int64)
    out = np.empty_like(arr)

    acc = lin[0] * (radius + 1)
    for y in range(edge_a - 1):
        acc = acc + lin[y]
    acc = acc + lin[last] * (radius - edge_a + 1)

    def emit(y, sub, add, far_a, far_b):
        nonlocal acc
        acc = acc + lin[add] - lin[sub]
        bulk = acc * ww + (lin[far_a] + lin[far_b]) * fw
        out[y] = ((bulk + (1 << 23)) >> 24).astype(np.uint8)

    if edge_a <= edge_b:
        for y in range(edge_a):
            emit(y, 0, y + radius, 0, y + radius + 1)
        for y in range(edge_a, edge_b):
            emit(y, y - radius - 1, y + radius, y - radius - 1, y + radius + 1)
        for y in range(edge_b, last + 1):
            emit(y, y - radius - 1, last, y - radius - 1, last)
    else:
        for y in range(last + 1):
            emit(y, max(y - radius - 1, 0), min(y + radius, last),
                 max(y - radius - 1, 0), min(y + radius + 1, last))
    return out


def gaussian_blur_plain(img, radius: float) -> np.ndarray:
    """The numpy mirror of ``gaussian_blur``: Pillow's three box passes
    horizontally, then three vertically."""
    ri, ww, fw = _blur_params(radius)
    out = _as_u8(img).transpose(1, 0, 2)       # [w, h, c]: axis 0 is W
    for _ in range(3):
        out = _box_pass_np(out, ri, ww, fw)
    out = np.ascontiguousarray(out.transpose(1, 0, 2))
    for _ in range(3):
        out = _box_pass_np(out, ri, ww, fw)
    return out


def white_percentage_plain(img, ref_size: int = 224) -> float:
    """``white_percentage`` through PIL: the JAX package's
    ``compute_white_percentage`` without its native branch."""
    from PIL import Image

    arr = _as_u8(img)
    gray = Image.fromarray(arr[..., :3] if arr.shape[2] >= 3 else arr[..., 0])
    gray = gray.convert("L")
    if gray.width > ref_size:
        gray = gray.resize((ref_size, ref_size), Image.BICUBIC)
    g = np.asarray(gray)
    return float(np.sum(g > 250)) / (g.shape[0] * g.shape[1])


def _decode(lib: ctypes.CDLL, data: bytes) -> Optional[np.ndarray]:
    buf = np.frombuffer(data, np.uint8)
    hw = np.zeros(3, np.int32)
    if lib.vt_jpeg_dims(buf, len(data), hw) != 0:
        return None
    out = np.empty((int(hw[0]), int(hw[1]), 3), np.uint8)
    if lib.vt_jpeg_decode(buf, len(data), out.reshape(-1), int(hw[0]),
                          int(hw[1])) != 0:
        return None
    return out


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """A JPEG byte string as an RGB u8 array, as ``PIL.Image.open(...)
    .convert("RGB")`` decodes it; None for a stream libjpeg rejects. Raises
    where ``decode_route()`` is "PIL"."""
    lib = _load()
    if build_info["decode_route"] != "libjpeg":
        raise RuntimeError("the native pipeline decodes no JPEG on this host "
                           f"(build_info: {build_info})")
    return _decode(lib, data)


class PipelinePool:
    """A persistent pool of C++ threads that prepares whole batches
    (``prep`` per image). One call releases the GIL for the whole batch, so
    Python threads decoding the next batch run meanwhile. The pool takes
    one batch at a time: a second thread entering it raises."""

    def __init__(self, num_threads: Optional[int] = None):
        self._lib = _load()
        self.num_threads = max(int(num_threads or os.cpu_count() or 1), 1)
        self._pool = self._lib.vt_pool_create(self.num_threads)
        self._busy = threading.Lock()

    def close(self):
        if getattr(self, "_pool", None):
            self._lib.vt_pool_destroy(self._pool)
            self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()

    def prep_batch(self, images: Sequence[np.ndarray], size: Tuple[int, int],
                   crops: Optional[Sequence[Tuple[int, int, int, int]]] = None,
                   filter: int = BILINEAR, mean=(0.5, 0.5, 0.5),
                   std=(0.5, 0.5, 0.5)) -> np.ndarray:
        """n images (u8 HWC, one channel count) cropped by ``crops``
        ((y0, x0, h, w) each; whole images when None), resized to ``size``
        and normalized, as one [n, oh, ow, c] float32 batch."""
        arrs = [_as_u8(im) for im in images]
        n = len(arrs)
        oh, ow = size
        if crops is not None and len(crops) != n:
            raise ValueError(f"{len(crops)} crop rects for {n} images")
        if n == 0:
            return np.empty((0, oh, ow, 3), np.float32)
        c = arrs[0].shape[2]
        dims = np.empty((n, 2), np.int32)
        cr = np.empty((n, 4), np.int32)
        ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)()
        for i, a in enumerate(arrs):
            if a.shape[2] != c:
                raise ValueError("mixed channel counts in batch")
            dims[i] = a.shape[:2]
            cr[i] = crops[i] if crops is not None else (0, 0, *a.shape[:2])
            ptrs[i] = a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        out = np.empty((n, oh, ow, c), np.float32)
        if not self._busy.acquire(blocking=False):
            raise RuntimeError("PipelinePool entered from two threads at once")
        try:
            rc = self._lib.vt_pool_prep_batch(
                self._pool, ptrs, dims.reshape(-1), cr.reshape(-1), n, c, oh, ow,
                filter, _f32v(mean, c), _f32v(std, c), out)
        finally:
            self._busy.release()
        if rc != 0:
            raise ValueError("vt_pool_prep_batch failed (bad crop rect?)")
        return out
