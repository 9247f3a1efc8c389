"""Cross-attention relevancy of a scored image pair (the JAX package's
``scripts/visualise_attentions.py``), with the port's Chefer rules.

    python -m vit_ed_tpu_torch.visualise_attentions \\
        --cfg configs/hisfrag/hisfrag20_patch16_512.yaml \\
        --pretrained <.ckpt or .pth> --images <first> <second> \\
        [--output_dir visualisation] [--threshold 0.6] [--device cpu]

Both images are centre-cropped to DATA.IMG_SIZE and normalized; the pair
goes through ``ops.explain.generate_relevance`` (float32 maps and their
gradients on the device, the rules on the host). Every decoder patch whose
relevance row passes ``--threshold`` somewhere gets a colour; the encoder
patches it points at get the same colour. ``attn_x1.png`` and
``attn_x2.png`` under the output directory overlay the colours on the two
crops, as the JAX script writes them; its OpenCV bilinear resize is
reproduced in numpy to 2 ulp (``resize_linear``), since the port imports
no OpenCV.
The colours are shuffled with Python's ``random``, unseeded, as there.
Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import colorsys
import os
import random
from typing import List, Optional

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.ops.explain import generate_relevance
from vit_ed_tpu_torch.train.checkpoint import load_pretrained
from vit_ed_tpu_torch.utils.logger import create_logger


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("Pajigsaw visualising script (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--pretrained", required=True)
    parser.add_argument("--images", type=str, required=True, nargs="+",
                        help="Path to the two testing images")
    parser.add_argument("--output_dir", type=str, default="visualisation")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--threshold", type=float, default=0.6)
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args, _ = parser.parse_known_args(argv)
    args.keep_attn = True
    return args, get_config(args)


def random_colors(n, bright=True):
    brightness = 1.0 if bright else 0.7
    colors = [colorsys.hsv_to_rgb(i / n, 1, brightness) for i in range(n)]
    random.shuffle(colors)
    return colors


def _linear_taps(n_in: int, n_out: int):
    """OpenCV's INTER_LINEAR source taps and float32 weights along one axis
    (half-pixel centres; a tap left of 0 or on the last pixel is clamped
    with weight 0 on its neighbour)."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    f[low], i0[low] = 0, 0
    f[high], i0[high] = 0, n_in - 1
    return i0, np.minimum(i0 + 1, n_in - 1), np.float32(1) - f, f


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.resize(img, (size, size))`` (bilinear) of a float32 or uint8
    [H, W, C] array, in float32: OpenCV's taps and weights, rows first, then
    columns, each a sum of two products. OpenCV's vectorised float path
    rounds in another order, so values agree to 2 ulp, not bit for bit
    (tests/test_torch_explain.py); the same size is a copy."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img.copy()
    x0, x1, ax0, ax1 = _linear_taps(w, size)
    y0, y1, by0, by1 = _linear_taps(h, size)
    src = img.astype(np.float32)
    rows = src[:, x0] * ax0[None, :, None] + src[:, x1] * ax1[None, :, None]
    return rows[y0] * by0[:, None, None] + rows[y1] * by1[:, None, None]


def show_cam_on_image(img, mask, target_size):
    heatmap = resize_linear(mask, target_size)
    img = resize_linear(img, target_size)
    img = np.float32(img) / 255
    cam = heatmap + img
    cam = cam / np.max(cam)
    return np.uint8(255 * cam)


def main(args, config, logger):
    """Write ``attn_x1.png`` and ``attn_x2.png``; returns the relevance
    [decoder patches, encoder patches]."""
    device = resolve_device(args.device)
    model = build_model(config)
    load_pretrained(model, config.MODEL.PRETRAINED, logger)
    s = config.DATA.IMG_SIZE

    def transform(img):
        img = T.center_crop(img, s)
        return T.normalize(T.to_tensor(img))

    assert len(args.images) == 2
    imgs = []
    for img_path in args.images:
        with Image.open(img_path) as f:
            imgs.append(f.convert("RGB"))
    first = transform(imgs[0])
    second = transform(imgs[1])
    x_pair = np.stack([first, second])[None]

    pjs = config.MODEL.PJS
    cam = generate_relevance(model, x_pair, patch=pjs.PATCH_SIZE, heads=pjs.NUM_HEADS,
                             depth=pjs.DEPTH, c_depth=pjs.C_DEPTH, target_index=0,
                             device=device)

    w_featmap = s // pjs.PATCH_SIZE
    h_featmap = s // pjs.PATCH_SIZE
    colours = random_colors(cam.shape[0])

    attn_x1_img = np.zeros([w_featmap, h_featmap, 3], dtype=np.float32)
    attn_x2_img = np.zeros([w_featmap, h_featmap, 3], dtype=np.float32)

    for h in range(w_featmap):
        for w in range(h_featmap):
            x2_feat_point = h * w_featmap + w
            attention_x1 = cam[x2_feat_point, :].reshape(w_featmap, h_featmap)
            if not np.all(attention_x1 <= args.threshold):
                colour = colours[x2_feat_point]
                attn_x2_img[h][w] = colour
                attn_x1_img[attention_x1 > args.threshold] = colour

    os.makedirs(args.output_dir, exist_ok=True)
    first_vis = show_cam_on_image(
        (T.unnormalize(first) * 255).astype(np.uint8), attn_x1_img, s)
    second_vis = show_cam_on_image(
        (T.unnormalize(second) * 255).astype(np.uint8), attn_x2_img, s)
    Image.fromarray(first_vis).save(os.path.join(args.output_dir, "attn_x1.png"))
    Image.fromarray(second_vis).save(os.path.join(args.output_dir, "attn_x2.png"))
    logger.info(f"Saved visualisations to {args.output_dir}")
    return cam


if __name__ == "__main__":
    args, config = parse_option()
    os.makedirs(config.OUTPUT, exist_ok=True)
    main(args, config, create_logger(output_dir=config.OUTPUT, dist_rank=0,
                                     name=f"{config.MODEL.NAME}", affix="_vis"))
