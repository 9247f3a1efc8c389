"""The triplet-ViT puzzle baseline with the port (the root ``main_vit.py`` of
the JAX package).

    python -m vit_ed_tpu_torch.main_vit --mode train|eval|throughput|test \\
        --cfg configs/puzzle/vit_div2k_erosion7_4bin_patch8_64.yaml \\
        --data-path <root> --output <dir> --tag <tag> [--batch-size N] \\
        [--pretrained <ckpt>] [--accumulation-steps K] [--use-checkpoint] \\
        [--device cpu]

A plain ViT (``models/vit.py``) embeds puzzle pieces. ``--mode train``
(``--data-path``: ``DIV2K_train_HR/`` and ``DIV2K_valid_HR/``): every item
is 4 directional (anchor, positive, negative) triplets cut from one DIV2K
image with 90-degree rotations, [4, 3, H, W, 3]; one forward embeds all 12
images and the loss is the cosine-distance triplet loss (margin 0.2) of
the f32 embeddings. Each epoch writes ``checkpoint.ckpt`` (and
``best_model.ckpt`` when the validation loss improves) under
``<output>/<MODEL.NAME>/<tag>``. ``--mode eval`` logs the validation
triplet loss (``Overall: Time ... Loss ...``). ``--mode throughput`` times
forwards of the 12 images of every item of one validation batch (the JAX
entry raises here: its throughput feeds the 6-D batch to the model).
``--mode test`` (``--data-path``: ``Cho/``, ``McGill/``, ``BGU/`` of .jpg /
.png images): every ordered pair of a puzzle's shuffled pieces is embedded
in its 4 rotated pairings, the pairings' cosine distances x 1000 fill the
solver's [4, N, N] distance tensor in the order (right, bottom, left, top),
the Paikin-Tal solver places the pieces, the reconstruction is saved under
``output/reconstructed/<subset>/`` (relative to the working directory, as
the JAX entry does) and each subset logs ``Average_Results: ... Perfect:
N``. Runs on the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.pieces import PiecesDatasetTriplet
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
from vit_ed_tpu_torch.solver.distance import BOTTOM, LEFT, RIGHT, TOP
from vit_ed_tpu_torch.solver.driver import paikin_tal_driver
from vit_ed_tpu_torch.solver.importer import (
    Puzzle,
    PuzzleResultsCollection,
    PuzzleSolver,
    PuzzleType,
)
from vit_ed_tpu_torch.train.engine import Trainer
from vit_ed_tpu_torch.train.losses import triplet_cosine_loss
from vit_ed_tpu_torch.utils import AverageMeter

SUBSETS = ("Cho", "McGill", "BGU")
MARGIN = 0.2
# the pairings of PiecesDatasetTriplet, in order, as sides of the first piece
SIDE_ORDER = (RIGHT, BOTTOM, LEFT, TOP)


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "ViT-triplet training and evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", help="pretrained weight from checkpoint")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int)
    parser.add_argument("--use-checkpoint", action="store_true")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str,
                        choices=["train", "eval", "throughput", "test"], default="train")
    parser.add_argument("--optim", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def cosine_distance_np(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """1 - cos(x, y) over the last axis, in numpy (the testing distances)."""
    xn = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    yn = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-12)
    return 1.0 - np.sum(xn * yn, axis=-1)


def triplet_loss(model: torch.nn.Module, samples: torch.Tensor) -> torch.Tensor:
    """The triplet loss of a batch [B, 4, 3, H, W, C]: one forward of the
    B * 12 images, f32 embeddings, (anchor, positive, negative) per
    direction."""
    b, x_, s_ = samples.shape[:3]
    emb = model(samples.reshape((b * x_ * s_,) + samples.shape[3:]))
    emb = emb.reshape(b * x_, s_, -1).float()
    return triplet_cosine_loss(emb[:, 0], emb[:, 1], emb[:, 2], margin=MARGIN)


class VitTripletTrainer(Trainer):
    """Directional-triplet training of the plain ViT on DIV2K, and puzzle
    testing with its embedding distances."""

    def get_criterion(self):
        return None

    def make_loss_fn(self, criterion):
        def loss_fn(model, batch):
            return triplet_loss(model, batch["samples"])

        return loss_fn

    def validate(self) -> float:
        data_loader = self.get_dataloader("validation")
        batch_time = AverageMeter()
        loss_meter = AverageMeter()
        self.model.eval()
        start = time.time()
        end = time.time()
        for idx, (images, _targets) in enumerate(data_loader):
            samples = self._to_device({"samples": images})["samples"]
            with torch.inference_mode():
                loss = triplet_loss(self.model, samples).item()
            loss_meter.update(loss, images.shape[0])
            batch_time.update(time.time() - end)
            end = time.time()
            if idx % self.config.PRINT_FREQ == 0:
                self.logger.info(f"Eval: [{idx}/{len(data_loader)}]\t"
                                 f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})\t"
                                 f"Loss {loss_meter.val:.4f} ({loss_meter.avg:.4f})")
        test_time = datetime.timedelta(seconds=int(time.time() - start))
        self.logger.info(f"Overall: Time {test_time}\tLoss {loss_meter.avg:.4f}")
        return loss_meter.avg

    def throughput_batch(self) -> np.ndarray:
        """The 12 images of every item of the first validation batch,
        flattened to [B * 12, H, W, C] (the model embeds images)."""
        images, _ = next(iter(self.get_dataloader("validation")))
        return images.reshape((-1,) + images.shape[-3:])

    def embed_pairings(self, dataset: PiecesDatasetTriplet) -> np.ndarray:
        """Cosine distances [len(dataset), 4] of every item's 4 pairings: the
        8 images of a batch of items embedded in one forward."""
        config = self.config
        loader = DataLoader(dataset, batch_size=config.DATA.BATCH_SIZE,
                            num_workers=config.DATA.NUM_WORKERS)
        out = np.empty((len(dataset), 4), np.float32)
        with torch.inference_mode():
            for batch_images, targets in loader:
                b, s = batch_images.shape[:2]           # s = 8 (4 pairings x 2)
                x = self._to_device({"x": batch_images.reshape(
                    (b * s,) + batch_images.shape[2:])})["x"]
                emb = self.model(x).float().cpu().numpy()
                emb = emb.reshape(b, s // 2, 2, -1)
                out[np.asarray(targets)] = cosine_distance_np(emb[:, :, 0], emb[:, :, 1])
        return out

    def testing(self) -> List[Dict[str, object]]:
        """Reconstruct every puzzle of the three subsets from the
        embedding distances. Returns one record per puzzle: subset, image,
        the shuffled pieces, the distance tensor, the solved puzzle and
        host seconds by stage (``load`` = read + LAB + cut, ``embed`` = the
        pairings' images made and embedded, ``solve``, ``save``)."""
        config = self.config
        self.model.eval()
        transform = TwoImgSyncEval(config.DATA.IMG_SIZE)
        records = []
        for subset in SUBSETS:
            images = glob.glob(os.path.join(config.DATA.DATA_PATH, subset, "*.jpg"))
            images += glob.glob(os.path.join(config.DATA.DATA_PATH, subset, "*.png"))
            output_dir = os.path.join("output", "reconstructed", subset)

            puzzles = []
            for idx, img_path in enumerate(images):
                t0 = time.time()
                puzzle = Puzzle(idx, img_path, config.DATA.IMG_SIZE, starting_piece_id=0,
                                erosion=config.DATA.EROSION_RATIO)
                pieces = puzzle.pieces
                random.shuffle(pieces)
                t1 = time.time()
                dataset = PiecesDatasetTriplet(pieces, transform=transform)
                dists = self.embed_pairings(dataset)
                t2 = time.time()

                n = len(pieces)
                distances = np.full((4, n, n), np.inf)
                for (i, j), pred in zip(dataset.entries, dists):
                    for k, side in enumerate(SIDE_ORDER):
                        distances[side, i, j] = pred[k] * 1000.0
                new_puzzle = paikin_tal_driver(pieces, config.DATA.IMG_SIZE, None,
                                               puzzle.grid_size, distances=distances)
                puzzles.append(new_puzzle)
                t3 = time.time()

                if self.rank == 0:   # one writer of several processes
                    os.makedirs(output_dir, exist_ok=True)
                    new_puzzle.save_to_file(
                        os.path.join(output_dir, os.path.basename(img_path)))
                records.append({
                    "subset": subset, "image": img_path, "pieces": pieces,
                    "distances": distances, "puzzle": new_puzzle,
                    "seconds": {"load": t1 - t0, "embed": t2 - t1, "solve": t3 - t2,
                                "save": time.time() - t3}})

            if not puzzles:
                continue
            print(f"Subset: {subset} {len(puzzles[0].pieces)}")
            results = PuzzleResultsCollection(PuzzleSolver.PaikinTal, PuzzleType.type1,
                                              [x.pieces for x in puzzles], images)
            results.calculate_accuracies(puzzles)
            result, perfect_puzzles = results.collect_results()
            out = "Average_Results:\t"
            for key in result:
                out += f"{key}: {round(sum(result[key]) / len(result[key]), 4)}\t"
            out += f"Perfect: {sum(perfect_puzzles)}"
            self.logger.info(out)
        return records


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, the validation
    loss after ``eval``, images per second after ``throughput`` and
    ``testing``'s records after ``test``."""
    args = parse_option(argv)
    trainer = VitTripletTrainer(args)
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "throughput":
        return trainer.throughput()
    if args.mode == "test":
        return trainer.testing()
    return trainer.train()


if __name__ == "__main__":
    main()
