"""The embedding-ViT HisFrag20 baseline with the port (the root
``hisfrag_vit.py`` of the JAX package).

    python -m vit_ed_tpu_torch.hisfrag_vit --mode train|eval|test|throughput \\
        --cfg configs/hisfrag/hisfrag20_patch16_512.yaml \\
        --data-path <root with train/*.jpg and test/*.jpg> \\
        --output <dir> --tag <tag> [--batch-size N] [--pretrained <ckpt>] \\
        [--device cpu] --opts MODEL.TYPE vit MODEL.NUM_CLASSES 384 \\
        MODEL.VIT.EMBED_DIM 384 MODEL.VIT.NUM_HEADS 6 MODEL.VIT.PATCH_SIZE 16

The data plumbing of ``vit_ed_tpu_torch/hisfrag.py`` (the same transforms
and datasets) with a plain ViT embedding every fragment. ``--mode train``:
M-per-class batches (m = 3), the batch-hard cosine triplet loss (margin
0.5) on the f32 embeddings. ``--mode eval`` (the val split, held-out
writers inside ``train/``) and ``--mode test`` (``test/``) embed every
fragment, score the negative dot-product matrix and log ``Validation
results: mAP ...`` / ``Test results: ...``. ``--mode throughput`` times
forwards of one val batch (the JAX entry raises here: it asks its dataset
factory for a "validation" split that HisFrag20 does not have). Runs on
the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.samplers import MPerClassSampler
from vit_ed_tpu_torch.hisfrag import HisfragTrainer as PairHisfragTrainer
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.train.losses import batch_wise_triplet_loss
from vit_ed_tpu_torch.utils import AverageMeter

MARGIN = 0.5


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "HisFrag ViT-embedding training and evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--eval-n-items-per-category", type=int, default=5)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", type=str,
                        help="checkpoint to start from or to evaluate")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int)
    parser.add_argument("--use-checkpoint", action="store_true")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str,
                        choices=["train", "eval", "test", "throughput"], default="train")
    parser.add_argument("--optim", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def compute_distance_matrix_from_embeddings(embeddings: np.ndarray,
                                            batch_size: int = 512) -> np.ndarray:
    """The negative dot-product distance matrix [N, N] float32, in row
    blocks of ``batch_size``."""
    n = len(embeddings)
    out = np.empty((n, n), np.float32)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        out[lo:hi] = -(embeddings[lo:hi] @ embeddings.T)
    return out


class HisfragVitTrainer(PairHisfragTrainer):
    """The pairwise trainer's data plumbing with an embedding loss."""

    ONE_PROCESS_ONLY = ("hisfrag_vit: the batch-hard triplet loss mines "
                        "over the global batch's labels")

    def get_criterion(self):
        return None

    def make_loss_fn(self, criterion):
        def loss_fn(model, batch):
            emb = model(batch["samples"]).float()
            return batch_wise_triplet_loss(emb, batch["targets"], margin=MARGIN)

        return loss_fn

    def prepare_data(self, samples, targets):
        # uint8 stays uint8 (the u8 wire: the model normalizes on the
        # device); anything else goes float32
        return {"samples": (samples if samples.dtype == np.uint8
                            else samples.astype(np.float32)),
                "targets": np.asarray(targets, np.int32)}

    def get_dataloader(self, mode):
        """M-per-class, drop-last batches for ``train`` (seeded SEED + rank,
        rank 0 here); the eval splits in order, the last batch short."""
        if mode in self.data_loader_registers:
            return self.data_loader_registers[mode]
        dataset, repeat = build_dataset(mode=mode, config=self.config,
                                        transforms=self.get_transforms())
        if mode == "train":
            sampler = MPerClassSampler(dataset.data_labels, m=3,
                                       length_before_new_iter=len(dataset) * repeat,
                                       seed=self.config.SEED)
            drop_last = True
        else:
            sampler, drop_last = None, False
        loader = DataLoader(dataset, sampler=sampler,
                            batch_size=self.config.DATA.BATCH_SIZE,
                            num_workers=self.config.DATA.NUM_WORKERS,
                            drop_last=drop_last)
        self.data_loader_registers[mode] = loader
        return loader

    def validate_dataloader(self, data_loader):
        """((mAP, Top-1, Pr@k10, Pr@k100), distance matrix, labels) of the
        loader's split: every item embedded, f32."""
        self.model.eval()
        batch_time = AverageMeter()
        end = time.time()
        embeddings, labels = [], []
        with torch.inference_mode():
            for idx, (images, targets) in enumerate(data_loader):
                x = self._to_device({"x": images})["x"]
                embeddings.append(self.model(x).float().cpu().numpy())
                labels.append(np.asarray(targets))
                batch_time.update(time.time() - end)
                end = time.time()
                if idx % self.config.PRINT_FREQ == 0:
                    self.logger.info(f"Eval: [{idx}/{len(data_loader)}]\t"
                                     f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})")
        embeddings, labels = np.concatenate(embeddings), np.concatenate(labels)
        self.logger.info(f"N samples: {len(embeddings)}, "
                         f"N categories: {len(np.unique(labels))}")
        distance_matrix = compute_distance_matrix_from_embeddings(
            embeddings, batch_size=self.config.DATA.TEST_BATCH_SIZE)
        return get_metrics(distance_matrix, labels), distance_matrix, labels

    def test(self):
        """Score the test split; returns ``validate_dataloader``'s triple."""
        out = self.validate_dataloader(self.get_dataloader("test"))
        m_ap, top1, pr_k10, pr_k100 = out[0]
        self.logger.info(f"Test results: {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                         f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
        return out

    def validate(self) -> float:
        """1 - mAP of the val split."""
        (m_ap, top1, pr_k10, pr_k100), _, _ = self.validate_dataloader(
            self.get_dataloader("val"))
        self.logger.info(f"Validation results: mAP {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                         f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
        return 1 - m_ap

    def throughput_batch(self) -> np.ndarray:
        """The first batch of the val split."""
        images, _ = next(iter(self.get_dataloader("val")))
        return images


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, 1 - mAP after
    ``eval``, (metrics, distance matrix, labels) after ``test`` and images
    per second after ``throughput``."""
    args = parse_option(argv)
    trainer = HisfragVitTrainer(args)
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "test":
        return trainer.test()
    if args.mode == "throughput":
        return trainer.throughput()
    return trainer.train()


if __name__ == "__main__":
    main()
