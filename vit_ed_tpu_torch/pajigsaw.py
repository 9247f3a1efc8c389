"""Pajigsaw fragment puzzles with the port (the root ``pajigsaw.py`` of the
JAX package).

    python -m vit_ed_tpu_torch.pajigsaw --mode train|eval|test|throughput \\
        --cfg configs/pajigsaw/pajigsaw_patch16_512.yaml \\
        --data-path <root with train.json, val.json, test.json and the
                     fragment images they name> \\
        --output <dir> --tag <tag> [--batch-size N] [--pretrained <ckpt>] \\
        [--device cpu]

``--mode train``: the 4-bin BCE on stacked fragment pairs
(``data/pajigsaw.py::Pajigsaw``: neighbours with their direction, or
negatives), a checkpoint per epoch under ``<output>/<MODEL.NAME>/<tag>``,
and a validate before the first epoch and after each. Validation solves
each held-out puzzle: ``random.shuffle`` of its pieces, every ordered piece
pair scored on the device (``PairwiseScorer.score_dense`` in chunks of
``DATA.BATCH_SIZE`` pairs), the sigmoid of the 4 bins routed into the
solver's distance tensor, the Paikin-Tal solver, and ``Average_Results:
... Perfect: N`` over the split; ``validate()`` returns 1 - the mean
neighbour accuracy. ``--mode eval`` runs the validation alone, ``--mode
test`` solves the test split and writes ``<OUTPUT>/reconstructed/<image>
.jpg``, ``--mode throughput`` times forwards of one batch of the test
split's pairs (the JAX entry raises there: it asks its dataset factory for a
"validation" split the manifest does not have). Runs on the CUDA card
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import List, Optional

import numpy as np

from vit_ed_tpu_torch.data.pajigsaw import PajigsawPieces, Split
from vit_ed_tpu_torch.data.pieces import PiecesImages
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.solver.distance import distance_matrix_from_predictions
from vit_ed_tpu_torch.solver.driver import paikin_tal_driver
from vit_ed_tpu_torch.solver.importer import (
    PuzzleResultsCollection,
    PuzzleSolver,
    PuzzleType,
)
from vit_ed_tpu_torch.train.engine import Trainer
from vit_ed_tpu_torch.train.losses import bce_with_logits
from vit_ed_tpu_torch.utils import AverageMeter


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "Pajigsaw training and evaluation script (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", help="weights to start from or to evaluate")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int)
    parser.add_argument("--use-checkpoint", action="store_true")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str,
                        choices=["train", "eval", "test", "throughput"], default="train")
    parser.add_argument("--optim", type=str)
    parser.add_argument("--device", type=str, default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class PajigsawTrainer(Trainer):
    """4-bin BCE trainer whose validation solves the held-out puzzles."""

    def get_criterion(self):
        return bce_with_logits

    def validate_dataloader(self, dataset: PajigsawPieces):
        """Solve every puzzle of ``dataset``; returns (mean neighbour
        accuracy, solved puzzles, image names). ``self.puzzle_seconds``
        keeps the host seconds of each puzzle by stage."""
        config = self.config
        scorer = PairwiseScorer(self.model, num_outputs=config.MODEL.NUM_CLASSES,
                                pair_chunk=config.DATA.BATCH_SIZE,
                                int8=config.TPU.INT8_SCORE)
        transform = TwoImgSyncEval(config.DATA.IMG_SIZE)

        puzzles, im_names = [], []
        self.puzzle_seconds = []
        batch_time = AverageMeter()
        end = time.time()
        for idx in range(len(dataset)):
            t0 = time.time()
            pieces, im_name, grid_size = dataset[idx]
            random.shuffle(pieces)
            im_names.append(im_name)
            t1 = time.time()
            piece_images = PiecesImages(pieces, transform=transform).all_images()
            t2 = time.time()
            logits = scorer.score_dense(piece_images, batch_size=config.DATA.BATCH_SIZE)
            t3 = time.time()
            distances = distance_matrix_from_predictions(sigmoid(logits))
            puzzles.append(paikin_tal_driver(pieces, config.DATA.IMG_SIZE, None,
                                             grid_size, distances=distances))
            self.puzzle_seconds.append({"load": t1 - t0, "transform": t2 - t1,
                                        **scorer.dense_seconds,
                                        "solve": time.time() - t3})

            batch_time.update(time.time() - end)
            end = time.time()
            if idx % config.PRINT_FREQ == 0:
                self.logger.info(f"Eval: [{idx}/{len(dataset)}]\t"
                                 f"Time {batch_time.val:.3f} ({batch_time.avg:.3f})")

        results_information = PuzzleResultsCollection(
            PuzzleSolver.PaikinTal, PuzzleType.type1,
            [x.pieces for x in puzzles], im_names)
        results_information.calculate_accuracies(puzzles)
        result, perfect_puzzles = results_information.collect_results()

        out = "Average_Results:\t"
        for key in result:
            out += f"{key}: {round(sum(result[key]) / len(result[key]), 4)}\t"
        out += f"Perfect: {sum(perfect_puzzles)}"
        self.logger.info(out)
        return sum(result["neighbor"]) / len(result["neighbor"]), puzzles, im_names

    def test(self):
        """Solve the test split and save each reconstruction; returns
        ``validate_dataloader``'s triple."""
        self.logger.info("Starting test...")
        dataset = PajigsawPieces(self.config.DATA.DATA_PATH, Split.TEST)
        out = self.validate_dataloader(dataset)
        for puzzle, im_name in zip(out[1], out[2]):
            output_file = os.path.join(self.config.OUTPUT, "reconstructed", f"{im_name}.jpg")
            os.makedirs(os.path.dirname(output_file), exist_ok=True)
            puzzle.save_to_file(output_file)
        return out

    def validate(self) -> float:
        self.logger.info("Starting validation...")
        dataset = PajigsawPieces(self.config.DATA.DATA_PATH, Split.VAL)
        neighbor_precision, _, _ = self.validate_dataloader(dataset)
        return 1 - neighbor_precision

    def throughput_batch(self) -> np.ndarray:
        """The first batch of pairs of the test split."""
        images, _ = next(iter(self.get_dataloader("test")))
        return images


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, 1 - the mean
    neighbour accuracy after ``eval``, ``validate_dataloader``'s triple
    after ``test`` and pairs per second after ``throughput``."""
    args = parse_option(argv)
    trainer = PajigsawTrainer(args)
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "test":
        return trainer.test()
    if args.mode == "throughput":
        return trainer.throughput()
    return trainer.train()


if __name__ == "__main__":
    main()
