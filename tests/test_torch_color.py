"""The port's OpenCV-free image functions (vit_ed_tpu_torch/solver/color.py)
against OpenCV itself, which the JAX package's puzzle path calls: the 8-bit
LAB conversions on all 2^24 inputs, ``imread_bgr`` against ``cv2.imread``
on PNG and JPEG files of every colour layout the readers meet (RGB, RGBA,
palette, grey, 16-bit, EXIF-rotated), and the border padding and writing.
Every comparison is exact."""

import _torch_threads  # noqa: F401  (caps torch's CPU threads per worker)
import cv2
import numpy as np
import pytest
from PIL import Image

from vit_ed_tpu_torch.solver import color


@pytest.fixture(scope="module")
def all_colours():
    """Every uint8 triple once, as one 4096 x 4096 image."""
    c = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1) \
        .astype(np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("name,code", [("bgr2lab_u8", cv2.COLOR_BGR2LAB),
                                       ("lab2rgb_u8", cv2.COLOR_LAB2RGB),
                                       ("lab2bgr_u8", cv2.COLOR_LAB2BGR)])
def test_conversion_equals_opencv_on_every_input(all_colours, name, code):
    ours = getattr(color, name)(all_colours)
    ref = cv2.cvtColor(all_colours, code)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    differing = int(np.any(ours != ref, axis=-1).sum())
    assert differing == 0, f"{differing} of 2^24 inputs differ"


def _textbook_bgr2lab(bgr):
    """The float formula of OpenCV's documentation (sRGB D65, float64),
    rounded to uint8."""
    x = bgr[..., ::-1].astype(np.float64) / 255.0
    lin = np.where(x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4)
    m = np.array([[0.412453, 0.357580, 0.180423], [0.212671, 0.715160, 0.072169],
                  [0.019334, 0.119193, 0.950227]])
    xyz = lin @ m.T / np.array([0.950456, 1.0, 1.088754])
    f = np.where(xyz > 0.008856, np.cbrt(xyz), 7.787 * xyz + 16 / 116)
    lum = np.where(xyz[..., 1] > 0.008856, 116 * f[..., 1] - 16, 903.3 * xyz[..., 1])
    lab = np.stack([lum * 255 / 100, 500 * (f[..., 0] - f[..., 1]) + 128,
                    200 * (f[..., 1] - f[..., 2]) + 128], -1)
    return np.clip(np.rint(lab), 0, 255).astype(np.uint8)


def test_why_the_port_builds_opencvs_tables(all_colours, monkeypatch):
    """The figures ROADMAP C records: the textbook formula differs from
    OpenCV's 8-bit BGR2LAB on 4,293,421 colours (by up to 3), the uint8
    BGR -> LAB -> BGR round trip changes 14,815,084 colours (by up to 27),
    and a correctly rounded cube root in the tables (in place of OpenCV's,
    which cuts its result to float32) moves 17,645 colours."""
    ref = color.bgr2lab_u8(all_colours)
    textbook = np.concatenate([_textbook_bgr2lab(all_colours[r:r + 512])
                               for r in range(0, 4096, 512)])
    diff = np.abs(textbook.astype(np.int16) - ref.astype(np.int16)).max(-1)
    assert (int((diff > 0).sum()), int(diff.max())) == (4293421, 3)
    back = color.lab2bgr_u8(ref)
    diff = np.abs(back.astype(np.int16) - all_colours.astype(np.int16)).max(-1)
    assert (int((diff > 0).sum()), int(diff.max())) == (14815084, 27)
    monkeypatch.setattr(color, "_cbrt", lambda x: np.float32(np.cbrt(np.float64(x))))
    color._tables.cache_clear()
    try:
        rounded = color.bgr2lab_u8(all_colours)
    finally:
        color._tables.cache_clear()
    assert int(np.any(rounded != ref, axis=-1).sum()) == 17645


def test_conversions_take_any_leading_shape():
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3), dtype=np.uint8)
    np.testing.assert_array_equal(color.bgr2lab_u8(x)[1],
                                  cv2.cvtColor(x[1], cv2.COLOR_BGR2LAB))
    with pytest.raises(ValueError, match="uint8"):
        color.lab2rgb_u8(x.astype(np.float32))


def _smooth(rng, h, w, c):
    small = rng.integers(0, 256, size=(7, 9, c), dtype=np.uint8)
    return np.asarray(Image.fromarray(small.squeeze()).resize((w, h), Image.BICUBIC))


def _write(path, kind, rng):
    h, w = 37, 53
    if kind == "rgb.png":
        Image.fromarray(_smooth(rng, h, w, 3)).save(path)
    elif kind == "rgba.png":
        a = np.dstack([_smooth(rng, h, w, 3), rng.integers(0, 256, (h, w), dtype=np.uint8)])
        Image.fromarray(a, "RGBA").save(path)
    elif kind == "palette.png":
        Image.fromarray(_smooth(rng, h, w, 3)).convert("P", palette=Image.ADAPTIVE).save(path)
    elif kind == "grey.png":
        Image.fromarray(_smooth(rng, h, w, 1)).save(path)
    elif kind == "grey16.png":
        Image.fromarray(rng.integers(0, 65536, (h, w), dtype=np.uint16)).save(path)
    elif kind == "bgr16.png":
        cv2.imwrite(path, rng.integers(0, 65536, (h, w, 3), dtype=np.uint16))
    elif kind == "rgb.jpg":
        Image.fromarray(_smooth(rng, h, w, 3)).save(path, quality=90)
    elif kind == "grey.jpg":
        Image.fromarray(_smooth(rng, h, w, 1)).save(path, quality=90)
    else:       # exif<orientation>.jpg
        exif = Image.Exif()
        exif[0x0112] = int(kind[4])
        Image.fromarray(_smooth(rng, h, w, 3)).save(path, quality=90, exif=exif)


@pytest.mark.parametrize("kind", ["rgb.png", "rgba.png", "palette.png", "grey.png",
                                  "grey16.png", "bgr16.png", "rgb.jpg", "grey.jpg",
                                  "exif2.jpg", "exif3.jpg", "exif5.jpg",
                                  "exif6.jpg", "exif8.jpg"])
def test_imread_equals_opencv(tmp_path, kind):
    path = str(tmp_path / kind)
    _write(path, kind, np.random.default_rng(len(kind)))
    ref = cv2.imread(path)
    ours = color.imread_bgr(path)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)
    if kind.startswith("exif") and kind[4] in "5678":
        assert ours.shape[:2] == (53, 37)     # the orientation turned it


def test_imread_of_a_non_image_is_none(tmp_path):
    path = tmp_path / "notes.png"
    path.write_text("not an image")
    assert color.imread_bgr(str(path)) is None and cv2.imread(str(path)) is None


@pytest.mark.parametrize("pads,value", [((0, 0, 0, 0), (0, 0, 0)),
                                        ((1, 1, 1, 1), (0, 0, 255)),
                                        ((2, 3, 0, 4), (7, 8, 9))])
def test_pad_constant_equals_copy_make_border(pads, value):
    img = np.random.default_rng(1).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    ref = cv2.copyMakeBorder(img, *pads, cv2.BORDER_CONSTANT, value=list(value))
    np.testing.assert_array_equal(color.pad_constant(img, *pads, value=value), ref)


def test_imwrite_png_round_trips_through_opencv(tmp_path):
    img = np.random.default_rng(2).integers(0, 256, (9, 11, 3), dtype=np.uint8)
    path = str(tmp_path / "out.png")
    assert color.imwrite(path, img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    jpg = str(tmp_path / "out.jpg")
    color.imwrite(jpg, img)
    assert cv2.imread(jpg).shape == img.shape
