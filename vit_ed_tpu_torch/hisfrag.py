"""HisFrag20 writer retrieval with the port: pairwise writer-ID training and
the O(N^2) pairwise scan with the wi19 metrics (the root ``hisfrag.py`` of
the JAX package).

    python -m vit_ed_tpu_torch.hisfrag --mode train|eval|test \\
        --cfg configs/hisfrag/hisfrag20_patch16_512.yaml \\
        --data-path <root with train/*.jpg and test/*.jpg> \\
        --output <dir> --tag <tag> [--batch-size N] [--pretrained <.pth>] \\
        [--accumulation-steps K] [--use-checkpoint] [--device cpu]

``--mode train``: M-per-class batches (m = 3); in-batch pair mining builds
positive and negative index pairs from the label-equality matrix with the
negatives capped at 2x the positives, into a fixed-size padded pair buffer
(subclasses set the cap, the loss reduction and whether an image's
negatives are mined over its whole row: ``vit_ed_tpu_torch/michigan.py``).
The encoder runs ONCE per batch; the pairs gather encoder features and
decoder tokens, and the loss is a masked BCE on the pair logits. Each epoch
writes ``checkpoint.ckpt`` (and ``best_model.ckpt`` when the val loss
improves) under ``<output>/<MODEL.NAME>/<tag>``; a rerun resumes from the
newest one. ``--mode eval`` scores the val split (held-out writers inside
``train/``), ``--mode test`` the test split: both print ``mAP ... Top 1 ...
Pr@k10 ... Pr@k100``, and test writes ``distance_matrix_rank0.csv`` — the
same lines and file as the JAX entry. With ``TPU.SHARDED_EVAL_METRICS``
test never assembles the N x N matrix: it scores complete rows
(``assemble=False``; on an ``np.memmap`` under the output directory with
``TPU.EVAL_SLAB_ON_DISK``, resumable by block markers), reduces them in
blocks of 2,048 rows to wi19 partial sums, logs the metrics and writes no
CSV, as the JAX entry's ``_test_sharded``. ``TPU.INT8_SCORE`` scores with
the blocks' GEMMs in int8. Runs on the CUDA card unless ``--device cpu``
is given.

Several processes (``torchrun --nproc_per_node N -m
vit_ed_tpu_torch.hisfrag ...``): training mines each rank's pairs inside its
own local batch (its pair indices read its own images) and the loss is the
global masked mean, the local masked sum over the global live-pair count
(with this rank's share of the expert banks' global aux terms);
the scans split the rows (``score_dataset(rank=, world_size=)``), the
assembled matrix is merged on every rank and the sharded metrics' partials
are gathered, and rank 0 alone logs the metrics and writes the CSV.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
from typing import List, Optional

import numpy as np

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.samplers import MPerClassSampler
from vit_ed_tpu_torch.metrics import get_metrics
from vit_ed_tpu_torch.metrics.wi19_sharded import merge_partials, row_partials
from vit_ed_tpu_torch.ops.gather import gather_rows
from vit_ed_tpu_torch.parallel.mesh import host_allreduce_sum, process_allgather
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.train.engine import Trainer, moe_aux_weights
from vit_ed_tpu_torch.train.losses import bce_with_logits, masked_bce_with_logits
from vit_ed_tpu_torch.utils import list_to_idx


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "HisFrag training and evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--eval-n-items-per-category", type=int, default=5)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", type=str,
                        help="checkpoint to start from or to score with: a "
                             "reference .pth or a .ckpt of this trainer")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int)
    parser.add_argument("--use-checkpoint", action="store_true")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str, choices=["train", "eval", "test"],
                        default="train")
    parser.add_argument("--optim", type=str)
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


class HisfragTrainer(Trainer):
    NEG_PAIR_RATIO = 2.0          # negatives per positive, at most
    LOSS_REDUCTION = "mean"
    NEG_FULL_ROW = False          # negatives of image i: j >= i, or every j

    def get_criterion(self):
        return bce_with_logits

    # ----------------------------------------------------------- transforms
    def get_transforms(self):
        patch_size = self.config.DATA.IMG_SIZE
        dev_norm = self.config.TPU.DEVICE_NORMALIZE

        def train_transform(img):
            img = T.random_affine(img, degrees=5, translate=(0.1, 0.1), fill=0)
            img = T.shift_scale_rotate(img, shift_limit=0.05, scale_limit=0.1,
                                       rotate_limit=10, p=0.5,
                                       border_value=(0, 0, 0))
            img = T.random_crop(img, patch_size, pad_if_needed=True)
            img = T.color_jitter(img, 0.3, 0.3, 0.3, 0.3, p=0.5)
            img = T.GaussianBlur(p=0.5, radius_min=1.0, radius_max=2.0)(img)
            if dev_norm:
                return np.asarray(img, np.uint8)
            return T.normalize_image(img)

        eval_transform = T.OneImgEval(patch_size, crop=True, emit_u8=dev_norm)
        return {"train": train_transform, "val": eval_transform,
                "test": eval_transform}

    def get_dataloader(self, mode):
        if mode in self.data_loader_registers:
            return self.data_loader_registers[mode]
        dataset, repeat = build_dataset(mode=mode, config=self.config,
                                        transforms=self.get_transforms())
        sampler = MPerClassSampler(dataset.data_labels, m=3,
                                   length_before_new_iter=len(dataset) * repeat,
                                   seed=self.config.SEED + self.data_index)
        loader = DataLoader(dataset, sampler=sampler,
                            batch_size=self.local_batch_size,
                            num_workers=self.config.DATA.NUM_WORKERS,
                            drop_last=True)
        self.data_loader_registers[mode] = loader
        return loader

    # ------------------------------------------------------------- training
    @property
    def max_pairs(self) -> int:
        if self.config.TPU.MAX_TRAIN_PAIRS:
            return self.config.TPU.MAX_TRAIN_PAIRS
        # + the global device count, as in the JAX entry: it moves the
        # miner's np.random.permutation cut
        return (int(1 + self.NEG_PAIR_RATIO) * self.local_batch_size
                + self.world_size)

    def rank_loss_weight(self) -> float:
        """1: a "mean" loss is already this rank's share of the global mean
        (``share_batches``), and a "sum" adds up over the ranks."""
        return 1.0

    def share_batches(self, micro_batches) -> None:
        """A "mean" loss divides by the global batch's live pairs: one
        all-reduce of the micro-batches' counts (``pair_count``)."""
        if self.LOSS_REDUCTION != "mean":
            return
        counts = host_allreduce_sum(np.asarray(
            [int(b["pair_mask"].sum()) for b in micro_batches], np.int64),
            group=self.mesh.group("data"))
        for b, c in zip(micro_batches, counts):
            b["pair_count"] = np.asarray([max(int(c), 1)], np.float32)

    def prepare_data(self, samples, targets):
        """Host-side in-batch pair mining into a fixed-size padded pair
        buffer; the ``np.random`` draws come in the JAX entry's order, so
        one seed mines the same pairs."""
        n = samples.shape[0]
        labels = np.asarray(targets)
        pos_mask = labels[:, None] == labels[None, :]
        np.fill_diagonal(pos_mask, False)
        neg_mask = ~(labels[:, None] == labels[None, :])

        pos_groups, neg_groups = [], []
        for i in range(n):
            pos_j = np.flatnonzero(pos_mask[i, i:]) + i
            if len(pos_j):
                pos_groups.append(np.stack([np.full(len(pos_j), i), pos_j], 1))
            if self.NEG_FULL_ROW:
                neg_j = np.flatnonzero(neg_mask[i, :])
            else:
                neg_j = np.flatnonzero(neg_mask[i, i:]) + i
            if len(neg_j):
                neg_groups.append(np.stack([np.full(len(neg_j), i), neg_j], 1))
        pos_groups = np.concatenate(pos_groups, 0) if pos_groups else np.zeros((0, 2), int)
        neg_groups = np.concatenate(neg_groups, 0) if neg_groups else np.zeros((0, 2), int)

        neg_length = min(len(neg_groups), int(self.NEG_PAIR_RATIO * len(pos_groups)))
        perm = np.random.permutation(len(neg_groups))[:neg_length]
        neg_groups = neg_groups[perm]

        groups = np.concatenate([pos_groups, neg_groups], 0)
        pair_targets = np.concatenate([np.ones(len(pos_groups), np.float32),
                                       np.zeros(len(neg_groups), np.float32)])

        m = self.max_pairs
        if len(groups) > m:
            keep = np.random.permutation(len(groups))[:m]
            groups, pair_targets = groups[keep], pair_targets[keep]
        pad = m - len(groups)
        mask = np.concatenate([np.ones(len(groups), np.float32),
                               np.zeros(pad, np.float32)])
        groups = np.concatenate([groups, np.zeros((pad, 2), groups.dtype)], 0)
        pair_targets = np.concatenate([pair_targets, np.zeros(pad, np.float32)])

        return {
            # uint8 stays uint8 (TPU.DEVICE_NORMALIZE: the model normalizes
            # on the device); anything else goes float32
            "samples": (samples if samples.dtype == np.uint8
                        else samples.astype(np.float32)),
            "gi": groups[:, 0].astype(np.int32),   # decoder-input image index
            "gj": groups[:, 1].astype(np.int32),   # encoder-context index
            "pair_targets": pair_targets[:, None],
            "pair_mask": mask,
            "targets": labels.astype(np.int32),
        }

    def make_loss_fn(self, criterion):
        reduction = self.LOSS_REDUCTION

        with_aux = moe_aux_weights(self.config)[0] > 0

        def loss_fn(model, batch):
            samples = batch["samples"]
            # the expert banks live in the encoder: their aux terms come
            # with its features
            feats, aux = model.encode(samples, with_aux=True)
            tokens = model.prepare_x2(samples)
            # gather_rows: the backward sums each image's pairs in a fixed
            # order (index_select's CUDA backward adds with atomics)
            f = gather_rows(feats, batch["gj"].long())
            t = gather_rows(tokens, batch["gi"].long())
            logits = model.score_tokens(f, t)
            if "pair_count" in batch:   # several processes: the global mean
                loss = masked_bce_with_logits(
                    logits.float(), batch["pair_targets"], batch["pair_mask"],
                    reduction="sum") / batch["pair_count"].reshape(())
            else:
                loss = masked_bce_with_logits(logits.float(), batch["pair_targets"],
                                              batch["pair_mask"], reduction=reduction)
            return self.add_moe_aux(loss, aux) if with_aux else loss

        return loss_fn

    # ----------------------------------------------------------------- eval
    def _eval_set(self, split: Split):
        """The eval dataset of ``split`` and a scorer for it."""
        config = self.config
        dataset = HisFrag20Test(
            config.DATA.DATA_PATH, split,
            transform=self.get_transforms()[split.value],
            val_n_items_per_writer=config.DATA.EVAL_N_ITEMS_PER_CATEGORY)
        scorer = PairwiseScorer(self.model, num_outputs=1,
                                pair_chunk=config.DATA.TEST_BATCH_SIZE,
                                int8=config.TPU.INT8_SCORE)
        return dataset, scorer

    def validate_dataloader(self, split: Split, remove_cache_file=False):
        """Scan ``split``: (float16 distance matrix, sample names, scorer)."""
        config = self.config
        dataset, scorer = self._eval_set(split)
        if remove_cache_file:
            for f in glob.glob(os.path.join(config.OUTPUT,
                                            f"{split.value}_rank{self.rank}_*.npz")):
                os.unlink(f)
        sim = scorer.score_dataset(dataset, batch_size=config.DATA.BATCH_SIZE,
                                   logger=self.logger, out_dir=config.OUTPUT,
                                   tag=split.value, rank=self.rank,
                                   world_size=self.world_size,
                                   num_workers=config.DATA.NUM_WORKERS)
        distance_matrix = (1.0 - sim.astype(np.float32)).astype(np.float16)
        names = [os.path.splitext(os.path.basename(s))[0]
                 for s in dataset.samples]
        self.logger.info("Distance matrix is generated!")
        return distance_matrix, names, scorer

    def _metrics(self, distance_matrix, names):
        labels = list_to_idx(names, lambda x: x.split("_")[0])
        metrics = get_metrics(distance_matrix.astype(np.float32),
                              np.asarray(labels))
        m_ap, top1, pr_k10, pr_k100 = metrics
        if self.rank == 0:
            self.logger.info(f"mAP {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                             f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
        return metrics

    def test(self):
        """Score the test split and write the distance matrix. Returns
        ``(metrics, distance_matrix, names, scorer)``; with
        ``TPU.SHARDED_EVAL_METRICS`` ``_test_sharded``'s."""
        if self.config.TPU.SHARDED_EVAL_METRICS:
            return self._test_sharded()
        if self.config.TPU.EVAL_SLAB_ON_DISK:
            self.logger.warning(
                "TPU.EVAL_SLAB_ON_DISK has no effect without "
                "TPU.SHARDED_EVAL_METRICS (the assembled test path "
                "builds the N x N matrix)")
        distance_matrix, names, scorer = self.validate_dataloader(Split.TEST)
        metrics = self._metrics(distance_matrix, names)
        if self.rank == 0:
            write_distance_csv(
                os.path.join(self.config.OUTPUT, "distance_matrix_rank0.csv"),
                distance_matrix, names)
        return metrics, distance_matrix, names, scorer

    def _test_sharded(self):
        """``TPU.SHARDED_EVAL_METRICS``: score complete rows without
        assembling the N x N matrix (on a memmap with
        ``TPU.EVAL_SLAB_ON_DISK``), reduce them in blocks of 2,048 rows to
        wi19 partial sums and merge them with every rank's (one
        ``process_allgather``); no CSV. Each block's distances go through
        the assembled path's chain, float32 then float16, element for
        element, so that ties rank the same. Returns ``(metrics, rows,
        names, scorer)``, ``rows`` this rank's complete rows of the float16
        scores (all N of them on one process; ``scorer.row_range`` says
        which)."""
        config = self.config
        dataset, scorer = self._eval_set(Split.TEST)
        rows, row_range = scorer.score_dataset(
            dataset, batch_size=config.DATA.BATCH_SIZE, logger=self.logger,
            out_dir=config.OUTPUT, tag=Split.TEST.value, rank=self.rank,
            world_size=self.world_size, num_workers=config.DATA.NUM_WORKERS,
            assemble=False, slab_on_disk=config.TPU.EVAL_SLAB_ON_DISK)
        names = [os.path.splitext(os.path.basename(s))[0] for s in dataset.samples]
        labels = np.asarray(list_to_idx(names, lambda x: x.split("_")[0]))
        parts = []
        for a in range(0, rows.shape[0], 2048):
            dist = (1.0 - rows[a:a + 2048].astype(np.float32)).astype(np.float16)
            lo = row_range.start + a
            parts.append(row_partials(dist.astype(np.float32), labels,
                                      row_labels=labels[lo:lo + dist.shape[0]]))
        part = {k: sum(p[k] for p in parts) for k in parts[0]}
        keys = sorted(part)
        gathered = process_allgather(np.asarray([part[k] for k in keys],
                                                np.float64))
        metrics = merge_partials([dict(zip(keys, row)) for row in gathered])
        m_ap, top1, pr_k10, pr_k100 = metrics
        if self.rank == 0:
            self.logger.info(f"mAP {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                             f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
        return metrics, rows, names, scorer

    def validate(self) -> float:
        """1 - mAP of a fresh scan of the val split."""
        distance_matrix, names, _ = self.validate_dataloader(
            Split.VAL, remove_cache_file=True)
        return 1 - self._metrics(distance_matrix, names)[0]


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, the val loss after
    ``eval`` and ``(metrics, distance_matrix, names, scorer)`` after
    ``test``."""
    args = parse_option(argv)
    trainer = HisfragTrainer(args)
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "test":
        return trainer.test()
    return trainer.train()


if __name__ == "__main__":
    main()
