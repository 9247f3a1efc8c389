"""Learning-rate range test with the port (the root ``lr_finder.py`` of the
JAX package).

    python -m vit_ed_tpu_torch.lr_finder \\
        --cfg configs/puzzle/div2k_erosion7_4bin_patch8_64.yaml \\
        --data-path <DIV2K root> --output <dir> --tag <tag> [--batch-size N] \\
        [--numb-iter 100] [--start-lr 1e-7] [--end-lr 1e-2] [--device cpu]

Training batches of the config's dataset at a geometric sweep of learning
rates ``start * (end / start) ** (i / (n - 1))``, one update each, with the
JAX entry's arithmetic:

- the update is plain AdamW over every parameter, weight decay
  (``TRAIN.WEIGHT_DECAY``) on biases and norms too, not the trainer's
  masked optimizer: optax's ``adamw`` at ``start`` with its update scaled
  by ``lr / start`` is ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``,
  which is ``torch.optim.AdamW`` at ``lr`` (betas 0.9 / 0.999, eps 1e-8);
- the loss (BCE of the float32 logits) is smoothed,
  ``0.05 * loss + 0.95 * previous smoothed loss``;
- the sweep stops once the smoothed loss passes 5 x the best one, after
  appending it;
- the suggestion is the learning rate at ``argmin(np.gradient(losses))``
  when more than 3 losses exist (else the last rate).

The curve goes to ``OUTPUT/lr_finder_result.jpg`` where matplotlib imports;
without it the log says that the plot was skipped. The sweep trains the
trainer's model in place. Runs on the CUDA card unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.train.engine import Trainer
from vit_ed_tpu_torch.train.losses import bce_with_logits


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("LR finder script (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--numb-iter", type=int, default=100)
    parser.add_argument("--start-lr", type=float, default=1e-7)
    parser.add_argument("--end-lr", type=float, default=1e-2)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str, choices=["lr_finder"], default="lr_finder")
    parser.add_argument("--optim", type=str)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


class LrFinderTrainer(Trainer):

    ONE_PROCESS_ONLY = "lr_finder: its sweep steps without the all-reduce"

    def get_criterion(self):
        return bce_with_logits

    def find_lr(self, num_iter: int = 100, start_lr: float = 1e-7, end_lr: float = 1e-2,
                smooth_f: float = 0.05, diverge_th: float = 5.0) -> float:
        """Run the sweep; returns the suggested learning rate and keeps the
        smoothed losses and their rates in ``self.losses`` / ``self.lrs``."""
        data_loader = self.get_dataloader("train")
        criterion = self.get_criterion()
        lrs = start_lr * (end_lr / start_lr) ** (np.arange(num_iter) / max(num_iter - 1, 1))
        optimizer = torch.optim.AdamW(self.model.parameters(), lr=start_lr,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=self.config.TRAIN.WEIGHT_DECAY)
        self.model.train()

        losses, used_lrs = [], []
        best_loss = None
        it = 0
        while it < num_iter:
            for samples, targets in data_loader:
                if it >= num_iter:
                    break
                lr = float(lrs[it])
                batch = self._to_device({"samples": samples, "targets": targets})
                optimizer.zero_grad(set_to_none=True)
                loss = criterion(self.model(batch["samples"]).float(), batch["targets"])
                loss.backward()
                for group in optimizer.param_groups:
                    group["lr"] = lr
                optimizer.step()
                loss = float(loss.item())
                if losses:
                    loss = smooth_f * loss + (1 - smooth_f) * losses[-1]
                losses.append(loss)
                used_lrs.append(lr)
                best_loss = loss if best_loss is None else min(best_loss, loss)
                if loss > diverge_th * best_loss:
                    self.logger.info("Stopping early, the loss has diverged")
                    it = num_iter
                    break
                it += 1

        self.losses, self.lrs = np.asarray(losses), np.asarray(used_lrs)
        if len(self.losses) > 3:
            suggestion = float(self.lrs[int(np.argmin(np.gradient(self.losses)))])
        else:
            suggestion = float(self.lrs[-1]) if len(self.lrs) else start_lr
        self._plot()
        self.logger.info(f"Lr suggestion: {suggestion}")
        return suggestion

    def _plot(self) -> None:
        try:
            import matplotlib
        except ImportError:
            self.logger.info("matplotlib is not installed: the plot "
                             "lr_finder_result.jpg was skipped")
            return
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        ax.plot(self.lrs, self.losses)
        ax.set_xscale("log")
        ax.set_xlabel("learning rate")
        ax.set_ylabel("loss")
        fig.savefig(os.path.join(self.config.OUTPUT, "lr_finder_result.jpg"))
        plt.close(fig)


def main(argv: Optional[List[str]] = None):
    """Run the sweep; returns the trainer (``losses``, ``lrs`` and the
    suggestion in ``suggestion``)."""
    args = parse_option(argv)
    trainer = LrFinderTrainer(args)
    trainer.suggestion = trainer.find_lr(num_iter=args.numb_iter, start_lr=args.start_lr,
                                         end_lr=args.end_lr)
    return trainer


if __name__ == "__main__":
    main()
