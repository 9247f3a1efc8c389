"""Michigan training augmentations dumped to disk (the JAX package's
``scripts/visualise_dataset.py``) on the port's ``data/michigan.py``.

    python -m vit_ed_tpu_torch.visualise_dataset --data-path <Michigan root> \\
        [--output-path dataset_preview] [--n-samples 20]

Each of the first ``--n-samples`` items of the training split goes through
the script's chain (a random-sized crop of at least 224 px, a random crop
to 512 padded with white, random flips, a resize to 512, colour jitter,
Gaussian blur, grey at 20%), drawn from Python's ``random`` unseeded as
there, and is written as ``sample_{i}_label{label}.png``. No device.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional

import numpy as np
from PIL import Image

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.michigan import MichiganDataset

parser = argparse.ArgumentParser("Dataset visualisation script (PyTorch port)")
parser.add_argument("--data-path", required=True, type=str)
parser.add_argument("--output-path", default="dataset_preview", type=str)
parser.add_argument("--n-samples", default=20, type=int)


def transform(img: Image.Image, patch_size: int = 512) -> np.ndarray:
    img = T.RandomSizedCrop(224, 224, pad_if_needed=True, fill=255)(img)
    img = T.random_crop(img, 512, pad_if_needed=True, fill=255)
    if random.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
    if random.random() < 0.5:
        img = img.transpose(Image.FLIP_TOP_BOTTOM)
    img = T.resize(img, patch_size)
    img = T.color_jitter(img, 0.2, 0.3, 0.3, 0.1, p=0.5)
    img = T.GaussianBlur(p=0.5, radius_max=2.0)(img)
    if random.random() < 0.2:
        img = img.convert("L").convert("RGB")
    return np.asarray(img)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Write the samples; returns their paths."""
    args = parser.parse_args(argv)
    dataset = MichiganDataset(args.data_path, MichiganDataset.Split.TRAIN,
                              transforms=transform)
    os.makedirs(args.output_path, exist_ok=True)
    paths = []
    for i in range(min(args.n_samples, len(dataset))):
        img, label = dataset[i]
        paths.append(os.path.join(args.output_path, f"sample_{i}_label{int(label)}.png"))
        Image.fromarray(np.asarray(img, np.uint8)).save(paths[-1])
    print(f"Saved {len(paths)} samples to {args.output_path}")
    return paths


if __name__ == "__main__":
    main()
