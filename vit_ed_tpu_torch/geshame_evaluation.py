"""Geshaem standard evaluation with the port (the root
``geshame_evaluation.py`` of the JAX package; its spelling kept).

    python -m vit_ed_tpu_torch.geshame_evaluation \\
        --cfg configs/michigan/michigan_patch16_384.yaml \\
        --data-path <Geshaem root: <fragment>_<r|v>_<column>/papyrus/<x>/*.jpg> \\
        --output <dir> --tag <tag> [--pretrained <ckpt>] [--device cpu]

Every upper-triangle pair of the Geshaem images goes through the model as a
stacked pair (center crop to DATA.IMG_SIZE, normalize); the logits fill a
symmetric float16 similarity matrix (the JAX entry's dtype, which moves
mAP ties), ``1 - similarity`` is the distance, and the wi19 metrics of the
images' fragment labels are logged as ``mAP ... Top 1 ... Pr@k10 ...
Pr@k100 ...``. Several processes (``torchrun``) split the pairs with a
strided ``DistributedEvalSampler`` and gather the predictions, padded to a
common length with -1 rows and cut back, as the JAX entry does; every rank
then holds the whole matrix. Runs on the CUDA card unless ``--device
cpu``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.geshaem import GeshaemPatch
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.samplers import DistributedEvalSampler
from vit_ed_tpu_torch.hisfrag import HisfragTrainer
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.parallel.mesh import check_world, process_allgather
from vit_ed_tpu_torch.utils import AverageMeter


def eval_standard(config, trainer, logger, world_size: int = 1, rank: int = 0):
    """(float32 distance matrix [n, n], image names, fragment labels) of
    the Geshaem images under DATA.DATA_PATH; ``rank`` of ``world_size``
    processes scores its share of the pairs, and every rank calls this
    together."""
    check_world(world_size)
    transform = T.OneImgEval(config.DATA.IMG_SIZE, crop=True)
    dataset = GeshaemPatch(config.DATA.DATA_PATH, GeshaemPatch.Split.VAL,
                           transform=transform)
    sampler = DistributedEvalSampler(len(dataset), num_replicas=world_size,
                                     rank=rank)
    dataloader = DataLoader(dataset, sampler=sampler,
                            batch_size=config.DATA.TEST_BATCH_SIZE,
                            num_workers=config.DATA.NUM_WORKERS)

    predicts = []
    my_indices = list(iter(sampler))
    batch_time = AverageMeter()
    end = time.time()
    pos = 0
    trainer.model.eval()
    with torch.inference_mode():
        for idx, (images, _pair_labels) in enumerate(dataloader):
            x = trainer._to_device({"samples": images})["samples"]
            output = trainer.model(x).float().cpu().numpy().reshape(-1)
            batch_indices = my_indices[pos: pos + len(output)]
            pos += len(output)
            pairs = dataset.pairs[batch_indices]
            predicts.append(np.column_stack([pairs.astype(np.float32), output]))
            batch_time.update(time.time() - end)
            end = time.time()
            if idx % config.PRINT_FREQ == 0:
                etas = batch_time.avg * (len(dataloader) - idx)
                logger.info(f"Testing: [{idx}/{len(dataloader)}]\t"
                            f"eta {datetime.timedelta(seconds=int(etas))}\t"
                            f"time {batch_time.val:.4f} ({batch_time.avg:.4f})")

    predicts = (np.concatenate(predicts, axis=0) if predicts
                else np.zeros((0, 3), np.float32))
    if world_size > 1:
        # a common length, then the -1 padding rows go
        max_n = int(len(dataset.pairs) * 1.2 / world_size) + 1
        padded = np.full((max_n, 3), -1, np.float32)
        padded[: len(predicts)] = predicts
        gathered = process_allgather(padded).reshape(-1, 3)
        predicts = gathered[gathered[:, 0] != -1]
    assert len(predicts) == len(dataset.pairs), \
        f"Incorrect size {predicts.shape} vs {dataset.pairs.shape}"
    size = len(dataset.data)

    similarity_matrix = np.zeros((size, size), np.float16)
    indices = predicts[:, :2].astype(np.int64)
    scores = predicts[:, 2].astype(np.float16)
    similarity_matrix[indices[:, 0], indices[:, 1]] = scores
    similarity_matrix[indices[:, 1], indices[:, 0]] = scores
    distance_matrix = 1 - similarity_matrix

    labels, fragment_idxs = [], []
    for i in range(size):
        labels.append(os.path.basename(os.path.dirname(os.path.dirname(dataset.data[i]))))
        fragment_idxs.append(dataset.data_labels[i])
    return distance_matrix.astype(np.float32), labels, np.asarray(fragment_idxs)


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("Geshaem testing script (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--mode", type=str, default="eval")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", type=str,
                        help="checkpoint to score with: a reference .pth or "
                             "a .ckpt of the port's trainers")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None):
    """Returns ``(metrics, distance_matrix, names, fragment labels)``."""
    args = parse_option(argv)
    trainer = HisfragTrainer(args)
    logger = trainer.logger
    start_time = time.time()
    distance_matrix, img_names, fragment_idxs = eval_standard(
        trainer.config, trainer, logger, trainer.world_size, trainer.rank)
    logger.info("Starting to calculate performance...")
    logger.info(f"Distance matrix shape: {distance_matrix.shape}")
    metrics = get_metrics(distance_matrix, fragment_idxs)
    m_ap2, top1, pr_a_k10, pr_a_k100 = metrics
    total_time_str = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f"mAP {m_ap2:.3f}\tTop 1 {top1:.3f}\tPr@k10 {pr_a_k10:.3f}\t"
                f"Pr@k100 {pr_a_k100:.3f} Time: {total_time_str}")
    return metrics, distance_matrix, img_names, fragment_idxs


if __name__ == "__main__":
    main()
