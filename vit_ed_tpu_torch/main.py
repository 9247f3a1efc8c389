"""DIV2K puzzle-pair training and evaluation with the port (the root
``main.py`` of the JAX package).

    python -m vit_ed_tpu_torch.main --mode train|eval|throughput \\
        --cfg configs/puzzle/div2k_erosion7_4bin_patch8_64.yaml \\
        --data-path <root with DIV2K_train_HR/ and DIV2K_valid_HR/> \\
        --output <dir> --tag <tag> [--batch-size N] [--pretrained <ckpt>] \\
        [--accumulation-steps K] [--use-checkpoint] [--device cpu]

``--mode train``: every item is a pair of neighbouring (or, for 30 %,
unrelated) pieces cut from one DIV2K image, stacked [2, H, W, 3], with a
4-bin label (right / below / left / above, all zero for a negative); the
loss is the BCE of the 4 logits. Each epoch writes ``checkpoint.ckpt`` (and
``best_model.ckpt`` when the validation loss improves) under
``<output>/<MODEL.NAME>/<tag>``; a rerun resumes from the newest one.
``--mode eval`` runs the validation alone (give it the weights with
``--pretrained <ckpt>`` under a tag of its own: as in the JAX entry, a run
directory's own checkpoint is resumed by ``train`` only and takes
precedence over ``--pretrained``) and logs ``Overall: ... Loss ...
ACC ... F1 ... Precision ... Recall ...`` (per-batch macro scores averaged
over the 4 bins, as the JAX entry logs them); ``--mode throughput`` times
forwards of one validation batch. Runs on the CUDA card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import datetime
import time
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.metrics import classification as M
from vit_ed_tpu_torch.train.engine import Trainer
from vit_ed_tpu_torch.train.losses import bce_with_logits
from vit_ed_tpu_torch.utils import AverageMeter


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "Pajigsaw training and evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE",
                        help="path to config file")
    parser.add_argument("--opts", default=None, nargs="+",
                        help="Modify config options by adding 'KEY VALUE' pairs.")
    parser.add_argument("--batch-size", type=int, help="batch size")
    parser.add_argument("--data-path", type=str, help="path to dataset")
    parser.add_argument("--pretrained", help="pretrained weight from checkpoint")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int,
                        help="gradient accumulation steps")
    parser.add_argument("--use-checkpoint", action="store_true",
                        help="recompute the blocks in the backward pass to save memory")
    parser.add_argument("--disable_amp", action="store_true",
                        help="Disable bf16 compute")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str,
                        choices=["train", "eval", "throughput"], default="train")
    parser.add_argument("--optim", type=str, help="overwrite optimizer if provided")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


class DefaultTrainer(Trainer):
    """4-bin BCE trainer with the validation metrics of the JAX entry."""

    def get_criterion(self):
        return bce_with_logits

    def validate(self) -> float:
        data_loader = self.get_dataloader("validation")
        criterion = self.get_criterion()
        batch_time = AverageMeter()
        loss_meter = AverageMeter()
        acc_meter = AverageMeter()
        f1_meter = AverageMeter()
        precision_meter = AverageMeter()
        recall_meter = AverageMeter()

        self.model.eval()
        start = time.time()
        end = time.time()
        for idx, (images, target) in enumerate(data_loader):
            batch = self._to_device({"samples": images, "targets": target})
            with torch.inference_mode():
                logits = self.model(batch["samples"]).float()
                loss = criterion(logits, batch["targets"]).item()
            output = logits.cpu().numpy()

            accuracies, f1s, precisions, recalls = [], [], [], []
            for c in range(output.shape[1]):
                pred = (output[:, c] > 0).astype(np.float32)
                gt = target[:, c]
                accuracies.append(M.accuracy_score(gt, pred) * 100)
                f1s.append(M.f1_score(gt, pred))
                precisions.append(M.precision_score(gt, pred))
                recalls.append(M.recall_score(gt, pred))

            n = target.shape[0]
            loss_meter.update(loss, n)
            acc_meter.update(sum(accuracies) / len(accuracies), n)
            f1_meter.update(sum(f1s) / len(f1s), n)
            precision_meter.update(sum(precisions) / len(precisions), n)
            recall_meter.update(sum(recalls) / len(recalls), n)
            batch_time.update(time.time() - end)
            end = time.time()

            if idx % self.config.PRINT_FREQ == 0:
                self.logger.info(
                    f"Eval: [{idx}/{len(data_loader)}]\t"
                    f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                    f"Loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})\t"
                    f"ACC {acc_meter.val:.3f} ({acc_meter.avg:.3f})\t"
                    f"F1 {f1_meter.val:.3f} ({f1_meter.avg:.3f})\t"
                    f"Precision {precision_meter.val:.3f} ({precision_meter.avg:.3f})\t"
                    f"Recall {recall_meter.val:.3f} ({recall_meter.avg:.3f})")

        test_time = datetime.timedelta(seconds=int(time.time() - start))
        self.logger.info(
            f"Overall: Time {test_time}\tLoss {loss_meter.avg:.4f}\t"
            f"ACC {acc_meter.avg:.3f}\tF1 {f1_meter.avg:.3f}\t"
            f"Precision {precision_meter.avg:.3f}\tRecall {recall_meter.avg:.3f}")
        self.val_metrics = {"loss": loss_meter.avg, "acc": acc_meter.avg,
                            "f1": f1_meter.avg,
                            "precision": precision_meter.avg,
                            "recall": recall_meter.avg}
        return loss_meter.avg


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, the validation
    loss after ``eval`` and images per second after ``throughput``."""
    args = parse_option(argv)
    trainer = DefaultTrainer(args)
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "throughput":
        return trainer.throughput()
    return trainer.train()


if __name__ == "__main__":
    main()
