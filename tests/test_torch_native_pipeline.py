"""The port's native input pipeline (vit_ed_tpu_torch/native/pipeline.cc,
built with g++ at the first call) on the CPU, bit for bit:

- each native function against its plain version in the port (PIL / the
  numpy mirrors of data/transforms.py and native/pipeline.py);
- each native function and each transform that routes through it against
  the JAX package's (vit_ed_tpu.native.pipeline, vit_ed_tpu.data.transforms)
  on the same inputs and the same ``random`` seed, the whole hisfrag train
  chain and the DIV2K item included;
- the loader's whole-batch path against its per-item path, and the build
  (a corrupt cached library is rebuilt, a failed build raises).

Images are small (up to ~100 px) and made from numpy seeds.
"""

import io
import random
import types

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter

from vit_ed_tpu.data import transforms as JT
from vit_ed_tpu.native import pipeline as jnp_pipe
from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.native import pipeline as P
from vit_ed_tpu_torch.ops import _build


def _img(seed, h, w, c=3):
    rng = np.random.default_rng(seed)
    shape = (h, w) if c == 1 else (h, w, c)
    return rng.integers(0, 256, shape, np.uint8)


def _smooth(seed, h, w):
    """Smooth content (a bicubic upscale of noise), so that warps and
    resizes interpolate real gradients and JPEG keeps detail."""
    small = Image.fromarray(_img(seed, max(h // 4, 2), max(w // 4, 2)))
    return np.asarray(small.resize((w, h), Image.BICUBIC))


def _plain(monkeypatch):
    """Route the port's transforms through their plain versions."""
    monkeypatch.setattr(T, "_native_ok", lambda x: False)
    monkeypatch.setattr(T, "open_rgb", T.open_rgb_plain)


# ---------------------------------------------------------------------------
# native against plain, in the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("filt,pil_filt", [(P.BILINEAR, Image.BILINEAR),
                                           (P.BICUBIC, Image.BICUBIC)])
@pytest.mark.parametrize("shape,out", [((37, 53), (96, 80)),   # upscale
                                       ((96, 80), (37, 53)),   # downscale
                                       ((60, 90), (80, 48)),   # mixed
                                       ((64, 64), (64, 64))])  # identity
def test_resize_equals_pil(shape, out, filt, pil_filt):
    arr = _img(1, *shape)
    want = np.asarray(Image.fromarray(arr).resize((out[1], out[0]), pil_filt))
    assert np.array_equal(P.resize_u8(arr, out, filter=filt), want)


def test_crop_resize_equals_pil_and_rejects_out_of_bounds():
    arr = _img(2, 90, 100)
    # PIL's box is (left, top, right, bottom); the native crop (y0, x0, h, w)
    want = np.asarray(Image.fromarray(arr).crop((13, 21, 88, 80))
                      .resize((32, 40), Image.BILINEAR))
    assert np.array_equal(P.resize_u8(arr, (40, 32), crop=(21, 13, 59, 75)), want)
    with pytest.raises(ValueError):
        P.resize_u8(arr, (16, 16), crop=(50, 50, 60, 60))


def test_normalize_equals_plain():
    arr = _img(3, 57, 83)
    for mean, std in (((0.5,) * 3, (0.5,) * 3), ((0.48, 0.45, 0.41), (0.23, 0.22, 0.25))):
        got = P.normalize_u8(arr, mean, std)
        want = T.normalize_image_plain(Image.fromarray(arr), mean, std)
        assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(ValueError, match="channels"):
        P.normalize_u8(_img(3, 8, 8, c=1))    # (h, w, 1) against a 3-mean


@pytest.mark.parametrize("shape", [(50, 80), (60, 250), (96, 230)])
def test_white_percentage_equals_plain(shape):
    arr = np.random.default_rng(4).integers(180, 256, shape + (3,), np.uint8)
    assert np.float32(P.white_percentage_plain(arr)) == P.white_percentage(arr)
    rgba = np.concatenate([arr, np.full(shape + (1,), 7, np.uint8)], axis=-1)
    assert P.white_percentage(rgba) == P.white_percentage(arr)


def test_prep_equals_resize_then_normalize():
    arr = _img(5, 70, 90)
    img = Image.fromarray(arr)
    for crop, size in ((None, (48, 40)), ((5, 9, 60, 64), (32, 32))):
        got = P.prep(arr, size, crop=crop)
        src = img if crop is None else img.crop(
            (crop[1], crop[0], crop[1] + crop[3], crop[0] + crop[2]))
        want = T.normalize_image_plain(src.resize((size[1], size[0]), Image.BILINEAR))
        assert np.array_equal(got, want)


def test_pool_batch_equals_sequential_prep():
    images = [_img(10 + i, 50 + 7 * i, 45 + 5 * i) for i in range(7)]
    crops = [(i, i, 40 + i, 38 + i) for i in range(7)]
    with P.PipelinePool(num_threads=3) as pool:
        batch = pool.prep_batch(images, (24, 28), crops=crops)
        assert pool.prep_batch([], (16, 16)).shape == (0, 16, 16, 3)
        with pytest.raises(ValueError, match="crop rects"):
            pool.prep_batch(images[:2], (16, 16), crops=crops[:1])
    assert batch.shape == (7, 24, 28, 3)
    for b, im, cr in zip(batch, images, crops):
        assert np.array_equal(b, P.prep(im, (24, 28), crop=cr))


def test_pool_refuses_a_second_thread():
    pool = P.PipelinePool(num_threads=1)
    pool._busy.acquire()           # another thread inside prep_batch
    with pytest.raises(RuntimeError, match="two threads"):
        pool.prep_batch([_img(0, 8, 8)], (4, 4))
    pool._busy.release()
    assert pool.prep_batch([_img(0, 8, 8)], (4, 4)).shape == (1, 4, 4, 3)
    pool.close()


def test_color_jitter_equals_plain_and_pil():
    arr = _img(6, 61, 47)
    img = Image.fromarray(arr)
    for f in (0.55, 1.0, 1.6):
        for op, enhance in (("brightness", ImageEnhance.Brightness),
                            ("contrast", ImageEnhance.Contrast),
                            ("saturation", ImageEnhance.Color)):
            want = np.asarray(enhance(img).enhance(f))
            assert np.array_equal(T.jitter_plain(arr.copy(), [(op, f)]), want)
            assert np.array_equal(P.color_jitter(arr, [(op, f)]), want)
    rnd = random.Random(7)
    for _ in range(8):
        ops = [("brightness", rnd.uniform(0.7, 1.3)), ("contrast", rnd.uniform(0.7, 1.3)),
               ("saturation", rnd.uniform(0.7, 1.3)), ("hue", rnd.randint(-76, 76))]
        rnd.shuffle(ops)
        assert np.array_equal(P.color_jitter(arr, ops), T.jitter_plain(arr.copy(), ops))


def test_warp_affine_equals_plain():
    rng = np.random.default_rng(11)
    for t in range(16):
        h, w = (int(x) for x in rng.integers(3, 90, 2))
        img = _img(100 + t, h, w)
        m = T.rotation_matrix((w / 2, h / 2), float(rng.uniform(-180, 180)),
                              float(rng.uniform(0.4, 2.0)))
        m[0, 2] += float(rng.uniform(-1, 1)) * w
        m[1, 2] += float(rng.uniform(-1, 1)) * h
        bv = None if t % 2 else tuple(int(x) for x in rng.integers(0, 256, 3))
        assert np.array_equal(P.warp_affine(img, m, bv), T.warp_affine_plain(img, m, bv))
    img = _img(12, 33, 47)
    ident = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    assert np.array_equal(P.warp_affine(img, ident), img)


@pytest.mark.parametrize("h,w,s", [(32, 48, 1.15), (17, 33, 2.5), (64, 64, 1.02)])
def test_warp_upscale_bottom_right_corner(h, w, s):
    """Upscales put runs of taps on the bottom-right source corner, which
    the SIMD path must leave to the scalar one."""
    img = _img(13, h, w)
    m = T.rotation_matrix((w / 2, h / 2), 0.0, s)
    for bv in (None, (0, 0, 0)):
        assert np.array_equal(P.warp_affine(img, m, bv), T.warp_affine_plain(img, m, bv))


def test_gaussian_blur_radius_sweep():
    img = _img(14, 48, 61)
    pim = Image.fromarray(img)
    for r in np.linspace(0.0, 6.0, 31):
        want = np.asarray(pim.filter(ImageFilter.GaussianBlur(radius=float(r))))
        assert np.array_equal(P.gaussian_blur(img, float(r)), want), r
        assert np.array_equal(P.gaussian_blur_plain(img, float(r)), want), r


@pytest.mark.parametrize("h,w", [(1, 1), (1, 5), (2, 2), (3, 40), (40, 3)])
def test_gaussian_blur_edge_shapes(h, w):
    """A radius at or past the image size takes Pillow's clamped loop."""
    img = _img(15, h, w)
    for r in (0.3, 2.0, 10.0, 25.0):
        want = np.asarray(Image.fromarray(img).filter(ImageFilter.GaussianBlur(radius=r)))
        assert np.array_equal(P.gaussian_blur(img, r), want)
        assert np.array_equal(P.gaussian_blur_plain(img, r), want)


def _jpeg(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **kw)
    return buf.getvalue()


def test_jpeg_decode_equals_pil():
    assert P.decode_route() == "libjpeg" and P.build_info["jpeg"]
    cases = [(Image.fromarray(_smooth(16, 91, 67)), {"quality": q}) for q in (70, 95)]
    cases += [(Image.fromarray(_smooth(17, 64, 80)), {"quality": 85, "progressive": True}),
              (Image.fromarray(_smooth(18, 40, 44)), {"quality": 85, "subsampling": 0}),
              (Image.fromarray(_img(19, 37, 53, c=1), "L"), {"quality": 85})]
    for img, kw in cases:
        data = _jpeg(img, **kw)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(P.decode_jpeg(data), want), kw
    assert P.decode_jpeg(b"not a jpeg") is None


def test_open_rgb_equals_plain(tmp_path):
    arr = _smooth(20, 60, 45)
    for name in ("a.jpg", "b.JPEG", "c.png"):
        Image.fromarray(arr).save(tmp_path / name, quality=90)
        path = str(tmp_path / name)
        assert np.array_equal(np.asarray(T.open_rgb(path)),
                              np.asarray(T.open_rgb_plain(path)))
    # a PNG behind a .jpg name: libjpeg rejects it, PIL reads it
    Image.fromarray(arr).save(tmp_path / "d.jpg", format="PNG")
    assert np.array_equal(np.asarray(T.open_rgb(str(tmp_path / "d.jpg"))), arr)


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

def test_corrupt_cached_library_is_rebuilt(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "mini.cc"
    src.write_text('extern "C" int forty_two() { return 42; }\n')
    path = _build.host_lib_path(str(src), [])
    (tmp_path / "build").mkdir()
    with open(path, "wb") as f:
        f.write(b"not an ELF file")
    assert _build.load_host(str(src), []).forty_two() == 42


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "broken.cc"
    src.write_text("int broken( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken"):
        _build.load_host(str(src), [])
    assert not any((tmp_path / "build").iterdir())


def test_library_name_depends_on_source_flags_and_cpu(tmp_path, monkeypatch):
    src = tmp_path / "mini.cc"
    src.write_text("int x;\n")
    base = _build.host_lib_path(str(src), ["-O2"])
    assert _build.host_lib_path(str(src), ["-O3"]) != base
    src.write_text("int y;\n")
    assert _build.host_lib_path(str(src), ["-O2"]) != base
    src.write_text("int x;\n")
    monkeypatch.setattr(_build, "host_cpu", lambda: "another cpu")
    assert _build.host_lib_path(str(src), ["-O2"]) != base
    assert base.startswith(_build.BUILD_DIR)


# ---------------------------------------------------------------------------
# the port's transforms: native routes against plain and against JAX
# ---------------------------------------------------------------------------

def _stub(img_size):
    cfg = types.SimpleNamespace(DATA=types.SimpleNamespace(IMG_SIZE=img_size),
                                TPU=types.SimpleNamespace(DEVICE_NORMALIZE=False))
    return types.SimpleNamespace(config=cfg)


def test_hisfrag_train_chain_equals_plain_and_jax(tmp_path, monkeypatch):
    """The port's train transform (vit_ed_tpu_torch/hisfrag.py) on a decoded
    JPEG against its plain route and the root hisfrag.py transform of the
    JAX package, one ``random`` seed each."""
    from hisfrag import HisfragTrainer as JaxTrainer
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer

    path = str(tmp_path / "w1_0_0.jpg")
    Image.fromarray(_smooth(21, 90, 76)).save(path, quality=90)
    ours = HisfragTrainer.get_transforms(_stub(48))["train"]
    ref = JaxTrainer.get_transforms(_stub(48))["train"]
    native_out = []
    for seed in range(8):
        random.seed(seed)
        native_out.append(ours(T.open_rgb(path)))
        random.seed(seed)
        want = ref(JT.open_rgb(path))
        assert native_out[-1].dtype == np.float32
        assert np.array_equal(native_out[-1], want), seed
    _plain(monkeypatch)
    for seed in range(8):
        random.seed(seed)
        assert np.array_equal(ours(T.open_rgb(path)), native_out[seed]), seed


def test_div2k_item_equals_plain_and_jax(tmp_path, monkeypatch):
    from vit_ed_tpu.data.div2k import DIV2KPatch as JaxDIV2KPatch
    from vit_ed_tpu.data.div2k import Split as JaxSplit
    from vit_ed_tpu_torch.data.div2k import DIV2KPatch, Split

    sub = tmp_path / "DIV2K_train_HR"
    sub.mkdir()
    for i in range(2):
        Image.fromarray(_smooth(30 + i, 140 + 8 * i, 200)).save(sub / f"{i:04d}.png")
    kw = dict(image_size=32, erosion_ratio=0.07, with_negative=True)
    ds = DIV2KPatch(str(tmp_path), Split.TRAIN, transform=T.TwoImgSyncEval(32), **kw)
    ref = JaxDIV2KPatch(str(tmp_path), JaxSplit.TRAIN,
                        transform=JT.TwoImgSyncEval(32), **kw)
    items = []
    for seed in range(8):
        random.seed(seed)
        items.append(ds[seed % 2])
        random.seed(seed)
        want = ref[seed % 2]
        assert all(np.array_equal(a, b) for a, b in zip(items[-1], want)), seed
    _plain(monkeypatch)
    for seed in range(8):
        random.seed(seed)
        assert all(np.array_equal(a, b) for a, b in zip(ds[seed % 2], items[seed]))


@pytest.mark.parametrize("crop", [False, True])
def test_eval_transforms_equal_plain_and_jax(monkeypatch, crop):
    """OneImgEval (crop, or resize of the short side; an image smaller than
    the crop pads on the plain chain) and TwoImgSyncEval."""
    imgs = [Image.fromarray(_img(40 + i, *s))
            for i, s in enumerate(((90, 70), (48, 48), (60, 100), (30, 40)))]
    ours, ref = T.OneImgEval(48, crop=crop), JT.OneImgEval(48, crop=crop)
    pair, ref_pair = T.TwoImgSyncEval(40), JT.TwoImgSyncEval(40)
    got = [ours(im) for im in imgs] + [x for im in imgs for x in pair(im, im)]
    want = [ref(im) for im in imgs] + [x for im in imgs for x in ref_pair(im, im)]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert (ours.pool_crop((30, 40)) is None) == crop    # the padding case
    _plain(monkeypatch)
    plain = [ours(im) for im in imgs] + [x for im in imgs for x in pair(im, im)]
    assert all(np.array_equal(np.asarray(a, np.float32), b) for a, b in zip(plain, got))


def test_rgb_inputs_take_the_native_routes(tmp_path, monkeypatch):
    """On RGB input every routed step calls its native function (the
    equality tests above would also pass on the plain chain alone)."""
    calls = []
    for name in ("decode_jpeg", "warp_affine", "color_jitter", "gaussian_blur",
                 "normalize_u8", "prep"):
        real = getattr(P, name)
        monkeypatch.setattr(P, name, lambda *a, _n=name, _f=real, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    path = str(tmp_path / "w0_0_0.jpg")
    Image.fromarray(_smooth(52, 64, 60)).save(path, quality=90)
    img = T.open_rgb(path)
    random.seed(0)
    T.GaussianBlur(p=1.0)(T.color_jitter(T.random_affine(img), p=1.0))
    T.normalize_image(img)
    T.OneImgEval(32, crop=True)(img)
    T.TwoImgSyncEval(32)(img, img)
    assert calls == ["decode_jpeg", "warp_affine", "color_jitter", "gaussian_blur",
                     "normalize_u8", "prep", "prep", "prep"]


def test_non_rgb_images_take_the_plain_chain():
    gray = Image.fromarray(_img(50, 40, 40, c=1), "L")
    assert not T._native_ok(gray) and not T._native_ok(np.zeros((4, 4)))
    assert np.array_equal(T.OneImgEval(32)(gray), JT.OneImgEval(32)(gray))
    random.seed(0)
    assert T.color_jitter(gray, p=1.0) is gray     # the jitter takes RGB only


def test_native_transform_steps_equal_jax():
    """warp_affine, color_jitter, GaussianBlur and normalize_image of both
    packages on one image and seed."""
    img = Image.fromarray(_smooth(51, 70, 58))
    arr = np.asarray(img)
    m = T.rotation_matrix((29.0, 35.0), 13.0, 1.1)
    assert np.array_equal(T.warp_affine(arr, m, (0, 0, 0)), JT.warp_affine(arr, m, (0, 0, 0)))
    assert np.array_equal(T.warp_affine(arr, m), JT.warp_affine(arr, m))
    for seed in range(6):
        for make in (lambda M: M.color_jitter(img, p=1.0),
                     lambda M: M.GaussianBlur(p=1.0)(img),
                     lambda M: M.random_affine(img),
                     lambda M: M.shift_scale_rotate(img, p=1.0)):
            random.seed(seed)
            got = np.asarray(make(T))
            random.seed(seed)
            assert np.array_equal(got, np.asarray(make(JT)))
    assert np.array_equal(T.normalize_image(img), JT.normalize_image(img))


@pytest.mark.parametrize("name", ["resize_u8", "normalize_u8", "white_percentage",
                                  "prep", "color_jitter", "warp_affine",
                                  "gaussian_blur", "decode_jpeg", "prep_batch"])
def test_native_function_equals_jax(name):
    """Every native entry of the port against the JAX package's binding on
    the same inputs."""
    arr = _smooth(60, 66, 54)
    m = T.rotation_matrix((27.0, 33.0), -21.0, 0.9)
    calls = {
        "resize_u8": lambda M: M.resize_u8(arr, (40, 31), filter=M.BICUBIC, crop=(3, 4, 50, 40)),
        "normalize_u8": lambda M: M.normalize_u8(arr, (0.4, 0.5, 0.6), (0.2, 0.3, 0.25)),
        "white_percentage": lambda M: M.white_percentage(arr, ref_size=32),
        "prep": lambda M: M.prep(arr, (32, 24), crop=(1, 2, 60, 50)),
        "color_jitter": lambda M: M.color_jitter(arr, [("hue", 40), ("contrast", 1.2),
                                                       ("saturation", 0.7),
                                                       ("brightness", 1.1)]),
        "warp_affine": lambda M: M.warp_affine(arr, m, (9, 8, 7)),
        "gaussian_blur": lambda M: M.gaussian_blur(arr, 1.37),
        "decode_jpeg": lambda M: M.decode_jpeg(_jpeg(Image.fromarray(arr), quality=80)),
        "prep_batch": lambda M: M.PipelinePool(2).prep_batch(
            [arr, arr[::-1].copy(), arr[:, 5:].copy()], (24, 24)),
    }
    got, want = calls[name](P), calls[name](jnp_pipe)
    assert np.array_equal(np.asarray(got), np.asarray(want))


# ---------------------------------------------------------------------------
# whole batches: the loader and the scorer's load
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jpeg_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("hisfrag")
    (root / "test").mkdir()
    for w in range(3):
        for f in range(3):
            # one fragment smaller than the 48-px crop: the padding case
            h, wd = (40, 44) if (w, f) == (2, 2) else (60 + 9 * f, 70 + 5 * w)
            Image.fromarray(_smooth(70 + 3 * w + f, h, wd)).save(
                root / "test" / f"w{w}_0_{f}.jpg", quality=90)
    return str(root)


def test_loader_native_batches_equal_per_item_batches(jpeg_corpus):
    from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
    from vit_ed_tpu_torch.data.loader import DataLoader

    ds = HisFrag20Test(jpeg_corpus, Split.TEST, transform=T.OneImgEval(48, crop=True))
    native_loader = DataLoader(ds, batch_size=4, num_workers=2)
    per_item = DataLoader(ds, batch_size=4, num_workers=0)
    got, want = list(native_loader), list(per_item)
    assert native_loader._pool is not None and per_item._pool is None
    assert [b[0].shape[0] for b in got] == [4, 4, 1]
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == np.float32 and np.array_equal(gi, wi)
        assert np.array_equal(gm, wm)


def test_scorer_load_batches_equal_items(jpeg_corpus, monkeypatch):
    """The scan's loads through the pool give the images ``dataset[i]``
    gives (the last block holds the padding case: the per-item path)."""
    import torch

    from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    ds = HisFrag20Test(jpeg_corpus, Split.TEST, transform=T.OneImgEval(48, crop=True))
    seen = []

    class Model(torch.nn.Module):
        """Records the encoder's inputs; scores nothing."""
        dtype, num_patches, embed_dim, c_depth = torch.float32, 1, 4, 1

        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(1))

        def encode(self, x):
            seen.append(x.numpy().copy())
            return x

        def context_kv_cache(self, feats):
            return torch.zeros((1, feats.shape[0], 2, 8))

        def prepare_x2_scan(self, x):
            return torch.zeros((x.shape[0], 2, 4))

        def score_tokens_row(self, kv_row, tokens):
            return torch.zeros((tokens.shape[0], 1))

    PairwiseScorer(Model()).score_dataset(ds, batch_size=4, num_workers=2,
                                          token_cache=True)
    assert [s.shape[0] for s in seen] == [4, 4, 1]
    want = np.stack([ds[i][0] for i in range(len(ds))])
    assert np.array_equal(np.concatenate(seen), want)


def _count_decodes(monkeypatch):
    """Count the image decodes of the hisfrag datasets."""
    from vit_ed_tpu_torch.data import hisfrag as H

    paths = []

    def counted(path):
        paths.append(path)
        return T.open_rgb(path)

    monkeypatch.setattr(H, "open_rgb", counted)
    return paths


@pytest.mark.parametrize("emit_u8", [False, True])
def test_loader_decodes_each_image_once(jpeg_corpus, monkeypatch, emit_u8):
    """A batch the pool cannot express (the padding image shares the last
    batch of 3 with two others) and the u8 wire (no pooled form) go through
    the transform on the images already decoded: one decode per image,
    batches equal to the per-item path's."""
    from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
    from vit_ed_tpu_torch.data.loader import DataLoader, pools_batches

    ds = HisFrag20Test(jpeg_corpus, Split.TEST,
                       transform=T.OneImgEval(48, crop=True, emit_u8=emit_u8))
    assert pools_batches(ds) is not emit_u8
    want = list(DataLoader(ds, batch_size=3, num_workers=0))
    paths = _count_decodes(monkeypatch)
    got = list(DataLoader(ds, batch_size=3, num_workers=2))
    assert sorted(paths) == sorted(ds.samples)
    assert [b[0].shape[0] for b in got] == [3, 3, 3]
    for (gi, gm), (wi, wm) in zip(got, want):
        assert gi.dtype == wi.dtype == (np.uint8 if emit_u8 else np.float32)
        assert np.array_equal(gi, wi) and np.array_equal(gm, wm)


def test_scorer_load_decodes_each_image_once(jpeg_corpus, monkeypatch):
    """The scan's load of a block the pool cannot express (the padding
    image) transforms the images it decoded instead of decoding again."""
    from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
    from vit_ed_tpu_torch.data.loader import pool_batch
    from vit_ed_tpu_torch.native.pipeline import PipelinePool

    ds = HisFrag20Test(jpeg_corpus, Split.TEST, transform=T.OneImgEval(48, crop=True))
    want = np.stack([ds[i][0] for i in range(6, 9)])
    paths = _count_decodes(monkeypatch)
    raws = [ds.raw_image(i) for i in range(6, 9)]
    pool = PipelinePool(2)
    try:
        got = pool_batch(pool, ds.transform, raws)
    finally:
        pool.close()
    assert paths == ds.samples[6:9]
    assert got.dtype == np.float32 and np.array_equal(got, want)
