"""HisFrag20 writer retrieval with the port: the O(N^2) pairwise scan over
the test split, then the wi19 metrics.

    python -m vit_ed_tpu_torch.hisfrag --mode test \\
        --cfg configs/hisfrag/hisfrag20_patch16_512.yaml \\
        --data-path <root with test/*.jpg> --output <dir> --tag <tag> \\
        [--pretrained <reference .pth>] [--batch-size N] [--device cpu]

Prints ``mAP ... Top 1 ... Pr@k10 ... Pr@k100`` and writes
``distance_matrix_rank0.csv`` under ``<output>/<MODEL.NAME>/<tag>`` — the
same line and file as ``hisfrag.py --mode test`` of the JAX package. Runs
on the CUDA card unless ``--device cpu`` is given. Only ``--mode test``
is ported (training and ``eval`` come with the training slice).
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
from vit_ed_tpu_torch.data.transforms import OneImgEval
from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.models.convert import load_pretrained
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.utils import create_logger, list_to_idx


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("HisFrag evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--eval-n-items-per-category", type=int, default=5)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", type=str,
                        help="reference .pth checkpoint to score with")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str, choices=["test"], default="test")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def write_distance_csv(path: str, distance_matrix: np.ndarray,
                       names: List[str]) -> None:
    """The JAX CLI's pandas ``to_csv`` layout: a header row of names after
    an empty corner cell, then one ``name,values...`` row per sample."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow([""] + list(names))
        for name, row in zip(names, distance_matrix):
            w.writerow([name] + [str(v) for v in row])


def run_test(config, device: torch.device):
    """Score the test split (weights from MODEL.PRETRAINED when set, else
    random from SEED) and compute the wi19 metrics. Returns
    ``(metrics, distance_matrix, names, scorer)``."""
    logger = create_logger(output_dir=config.OUTPUT, dist_rank=0,
                           name=f"{config.MODEL.NAME}_torch")
    torch.manual_seed(config.SEED)
    model = build_model(config, device)
    if config.MODEL.PRETRAINED:
        load_pretrained(model, config.MODEL.PRETRAINED, logger)
    logger.info(f"ViT-ED {config.MODEL.NAME} on {device} "
                f"({model.dtype}, {sum(p.numel() for p in model.parameters())} "
                f"params)")

    transform = OneImgEval(config.DATA.IMG_SIZE, crop=True,
                           emit_u8=config.TPU.DEVICE_NORMALIZE)
    dataset = HisFrag20Test(
        config.DATA.DATA_PATH, Split.TEST, transform=transform,
        val_n_items_per_writer=config.DATA.EVAL_N_ITEMS_PER_CATEGORY)
    scorer = PairwiseScorer(model, num_outputs=1,
                            pair_chunk=config.DATA.TEST_BATCH_SIZE,
                            int8=config.TPU.INT8_SCORE)
    sim = scorer.score_dataset(dataset, batch_size=config.DATA.BATCH_SIZE,
                               logger=logger, out_dir=config.OUTPUT,
                               tag=Split.TEST.value,
                               num_workers=config.DATA.NUM_WORKERS)
    distance_matrix = (1.0 - sim.astype(np.float32)).astype(np.float16)
    names = [os.path.splitext(os.path.basename(s))[0] for s in dataset.samples]
    labels = list_to_idx(names, lambda x: x.split("_")[0])
    metrics = get_metrics(distance_matrix.astype(np.float32), np.asarray(labels))
    m_ap, top1, pr_k10, pr_k100 = metrics
    logger.info(f"mAP {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
    write_distance_csv(os.path.join(config.OUTPUT, "distance_matrix_rank0.csv"),
                       distance_matrix, names)
    return metrics, distance_matrix, names, scorer


def main(argv: Optional[List[str]] = None):
    args = parse_option(argv)
    device = resolve_device(args.device)
    config = get_config(args)
    return run_test(config, device)


if __name__ == "__main__":
    main()
