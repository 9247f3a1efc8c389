"""Cho / McGill / BGU puzzle reconstruction with the port (the root
``evaluation.py`` of the JAX package).

    python -m vit_ed_tpu_torch.evaluation \\
        --cfg configs/puzzle/puzzle_eval_4bin_patch8_64.yaml \\
        --data-path <root with Cho/, McGill/ and BGU/ of .jpg / .png images> \\
        --pretrained <.ckpt of the port, or a reference .pth> \\
        [--output <dir>] [--tag <tag>] [--batch-size N] [--device cpu]

Per image: cut the puzzle into eroded LAB pieces (``solver.importer.Puzzle``,
no OpenCV) and shuffle them; score all ordered piece pairs on the device
(``PairwiseScorer.score_dense``: encoder, K/V and stream-2 preparation once
per piece, the decoder once per pair); route the sigmoid of the 4 bins into
the solver's distance tensor; place the pieces with the Paikin-Tal solver's
native core; save the reconstruction and, per subset, the accuracy images
under ``output/reconstructed/<subset>/`` (relative to the working directory,
as the JAX entry does) and log ``Average_Results: ... Perfect: N``. Runs on
the CUDA card unless ``--device cpu`` is given; ``--pretrained`` must exist.
"""

from __future__ import annotations

import argparse
import datetime
import glob
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from vit_ed_tpu_torch.config import get_config
from vit_ed_tpu_torch.data.pieces import PiecesImages
from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
from vit_ed_tpu_torch.device import resolve_device
from vit_ed_tpu_torch.models.build import build_model
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.solver.distance import distance_matrix_from_predictions
from vit_ed_tpu_torch.solver.driver import paikin_tal_driver
from vit_ed_tpu_torch.solver.importer import (
    Puzzle,
    PuzzleResultsCollection,
    PuzzleSolver,
    PuzzleType,
)
from vit_ed_tpu_torch.train.checkpoint import load_pretrained
from vit_ed_tpu_torch.utils import create_logger, set_seed

SUBSETS = ("Cho", "McGill", "BGU")


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser("Pajigsaw testing script (PyTorch port)",
                                     add_help=False)
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--pretrained", required=True)
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    args, _unparsed = parser.parse_known_args(argv)
    return args, get_config(args)


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def testing(config, model, logger) -> List[Dict[str, object]]:
    """Reconstruct every puzzle of the three subsets with ``model`` (on its
    device). Returns one record per puzzle: subset, image, pieces, pairs,
    the solved puzzle, and host seconds by stage (``load`` = read + LAB +
    cut, ``transform``, ``prepare`` = encoder + K/V + stream-2 preparation,
    ``score``, ``solve``, ``save``)."""
    scorer = PairwiseScorer(model, num_outputs=config.MODEL.NUM_CLASSES,
                            pair_chunk=config.DATA.BATCH_SIZE,
                            int8=config.TPU.INT8_SCORE)
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

            piece_images = PiecesImages(pieces, transform=transform).all_images()
            t2 = time.time()
            logits = scorer.score_dense(piece_images,
                                        batch_size=config.DATA.BATCH_SIZE)
            t3 = time.time()
            preds = sigmoid(logits)        # [N, N, 4]
            distances = distance_matrix_from_predictions(preds)

            new_puzzle = paikin_tal_driver(pieces, config.DATA.IMG_SIZE, None,
                                           puzzle.grid_size, distances=distances)
            puzzles.append(new_puzzle)
            t4 = time.time()

            os.makedirs(output_dir, exist_ok=True)
            new_puzzle.save_to_file(os.path.join(output_dir, os.path.basename(img_path)))
            n = len(pieces)
            records.append({
                "subset": subset, "image": img_path, "pieces": n,
                "pairs": n * (n - 1), "puzzle": new_puzzle,
                "distances": distances,
                "seconds": {"load": t1 - t0, "transform": t2 - t1,
                            **scorer.dense_seconds, "solve": t4 - t3,
                            "save": time.time() - t4}})

        if not puzzles:
            logger.info(f"Subset: {subset} — no images found, skipping")
            continue

        print(f"Subset: {subset} {len(puzzles[0].pieces)}")
        results_information = PuzzleResultsCollection(
            PuzzleSolver.PaikinTal, PuzzleType.type1,
            [x.pieces for x in puzzles], images)
        results_information.calculate_accuracies(puzzles)
        result, perfect_puzzles = results_information.collect_results()

        # per-piece result-coloured reconstructions
        t0 = time.time()
        for res, puzzle, img_path in zip(results_information.results, puzzles,
                                         images):
            if res.standard_direct_accuracy is not None:
                puzzle.build_direct_accuracy_image(
                    res.standard_direct_accuracy,
                    os.path.join(output_dir, "accuracy_" + os.path.basename(img_path)))
        for rec in records[-len(puzzles):]:
            rec["seconds"]["save"] += (time.time() - t0) / len(puzzles)

        out = "Average_Results:\t"
        for key in result:
            out += f"{key}: {round(sum(result[key]) / len(result[key]), 4)}\t"
        out += f"Perfect: {sum(perfect_puzzles)}"
        logger.info(out)
        for rec in records[-len(puzzles):]:
            rec["results"] = (result, sum(perfect_puzzles))
    return records


def main(argv: Optional[List[str]] = None):
    """Run the benchmark; returns ``testing``'s records."""
    args, config = parse_option(argv)
    device = resolve_device(args.device)
    set_seed(config.SEED)
    os.makedirs(config.OUTPUT, exist_ok=True)
    logger = create_logger(output_dir=config.OUTPUT, dist_rank=0,
                           name=f"{config.MODEL.NAME}_torch", affix="_test")
    logger.info(config.dump())
    logger.info(json.dumps(vars(args)))

    logger.info(f"Creating model:{config.MODEL.TYPE}/{config.MODEL.NAME}")
    model = build_model(config, device)
    logger.info(f"number of params: {sum(p.numel() for p in model.parameters())} "
                f"on {device} (compute {model.dtype})")
    if not (config.MODEL.PRETRAINED and os.path.exists(config.MODEL.PRETRAINED)):
        raise FileNotFoundError(
            f"Pretrained model does not exist {config.MODEL.PRETRAINED}")
    load_pretrained(model, config.MODEL.PRETRAINED, logger)

    logger.info("Start testing")
    start_time = time.time()
    with torch.inference_mode():
        records = testing(config, model.eval(), logger)
    total_time_str = str(datetime.timedelta(seconds=int(time.time() - start_time)))
    logger.info(f"Test time {total_time_str}")
    return records


if __name__ == "__main__":
    main()
