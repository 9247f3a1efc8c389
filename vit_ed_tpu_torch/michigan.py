"""Michigan papyrus writer retrieval with the port, and the Geshaem
cross-evaluation (the root ``michigan.py`` of the JAX package).

    python -m vit_ed_tpu_torch.michigan --mode train|eval|test|throughput \\
        --cfg configs/michigan/michigan_patch16_384.yaml \\
        --data-path <Michigan root> [--geshaem-data-path <Geshaem root>] \\
        --output <dir> --tag <tag> [--batch-size N] [--pretrained <ckpt>] \\
        [--accumulation-steps K] [--use-checkpoint] [--device cpu]

The Michigan tree holds ``<papyrus>/<side>/<detail|summary>/<folder>/
<medium>/<x>/<file>.jpg`` (data/michigan.py); the Geshaem tree
``<fragment>_<r|v>_<column>/papyrus/<x>/<file>.jpg`` (data/geshaem.py).

``--mode train`` is hisfrag's trainer with Michigan's choices: at most one
mined negative per positive, an image's negatives over its whole row, a
summed BCE, M-per-class batches (m = 3) over 20 x the train split per epoch
and the Michigan augmentations (crop, random resized crop, coarse dropout,
flips, jitter, blur, grayscale; Python's ``random`` in the JAX order).
Each validate scans the val split (``PairwiseScorer``) and logs ``Michigan
eval: mAP ...``; with ``--geshaem-data-path`` it first runs ``--mode
test``. ``--mode eval`` is one validate. ``--mode test`` scores every
upper-triangle pair of the Geshaem images (stacked-pair forwards), takes
``1 - logit`` as the distance, aggregates a fragment pair's distances by
mean and by min, and logs ``Geshaem test MEAN|MIN: mAP ... Top 1 ... Pr@k5
... Pr@k10`` (``metrics/map_prak.py``). ``--mode throughput`` times
forwards of stacked pairs of val images (the JAX entry's throughput asks
for a validation loader, which its Michigan trainer refuses). Runs on the
CUDA card unless ``--device cpu`` is given.

The distances are ``1 - logit`` as in the JAX entry (no sigmoid), and the
Geshaem matrix is built with numpy as the JAX entry's pandas frame is
(``fragment_distance_matrix``: the same order of rows and columns, NaN
where a fragment pair was never scored, which ``np.argsort`` sorts last,
and the same dtype).
"""

from __future__ import annotations

import argparse
import datetime
import os
import random
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from PIL import Image

from vit_ed_tpu_torch.data import transforms as T
from vit_ed_tpu_torch.data.build import build_dataset
from vit_ed_tpu_torch.data.geshaem import GeshaemPatch
from vit_ed_tpu_torch.data.loader import DataLoader
from vit_ed_tpu_torch.data.michigan import MichiganTest
from vit_ed_tpu_torch.data.samplers import MPerClassSampler
from vit_ed_tpu_torch.hisfrag import HisfragTrainer
from vit_ed_tpu_torch.metrics import calc_map_prak, get_metrics
from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
from vit_ed_tpu_torch.utils import AverageMeter


def parse_option(argv: Optional[List[str]] = None):
    parser = argparse.ArgumentParser(
        "Michigan/Geshaem training and evaluation (PyTorch port)")
    parser.add_argument("--cfg", type=str, required=True, metavar="FILE")
    parser.add_argument("--opts", default=None, nargs="+")
    parser.add_argument("--batch-size", type=int)
    parser.add_argument("--eval-n-items-per-category", type=int, default=5)
    parser.add_argument("--data-path", type=str)
    parser.add_argument("--geshaem-data-path", type=str)
    parser.add_argument("--pretrained", type=str,
                        help="checkpoint to start from or to score with: a "
                             "reference .pth or a .ckpt of this trainer")
    parser.add_argument("--resume", help="resume from checkpoint")
    parser.add_argument("--accumulation-steps", type=int)
    parser.add_argument("--use-checkpoint", action="store_true")
    parser.add_argument("--disable_amp", action="store_true")
    parser.add_argument("--output", default="output", type=str, metavar="PATH")
    parser.add_argument("--tag", help="tag of experiment")
    parser.add_argument("--mode", type=str,
                        choices=["train", "eval", "test", "throughput"],
                        default="train")
    parser.add_argument("--optim", type=str)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu")
    return parser.parse_args(argv)


def _coarse_dropout(img, max_holes=16, min_holes=3, min_size=16, max_size=64,
                    fill_value=255, p=0.9):
    """albumentations CoarseDropout as the JAX entry draws it."""
    if random.random() >= p:
        return img
    arr = np.asarray(img).copy()
    h, w = arr.shape[:2]
    for _ in range(random.randint(min_holes, max_holes)):
        hh = random.randint(min_size, max_size)
        ww = random.randint(min_size, max_size)
        y = random.randint(0, max(h - hh, 1))
        x = random.randint(0, max(w - ww, 1))
        arr[y:y + hh, x:x + ww] = fill_value
    return Image.fromarray(arr)


def fragment_distance_matrix(distance_map: Dict[str, Dict[str, float]]):
    """([n, n] matrix, names) of a {source: {dest: distance}} map as the
    JAX entry's ``pd.DataFrame.from_dict(distance_map, orient="index")
    .reindex(columns=<its index>)`` gives it, without pandas. pandas builds
    that frame column by column (a column per dest, in the order the dests
    first appear), so its rows are the union of the columns' sources taken
    column by column; the columns follow the rows. A missing (source,
    dest) is NaN; the values keep their dtype (float32 scores stay
    float32) unless a NaN is needed, which makes the matrix float64."""
    col_sources: Dict[str, List[str]] = {}
    for source, row in distance_map.items():
        for dest in row:
            col_sources.setdefault(dest, []).append(source)
    names, placed = [], set()
    for sources in col_sources.values():
        for source in sources:
            if source not in placed:
                placed.add(source)
                names.append(source)
    index = {name: i for i, name in enumerate(names)}
    cells = [(index[s], index[d], v) for s in names
             for d, v in distance_map[s].items() if d in index]
    dtype = np.result_type(*(np.asarray(v).dtype for _, _, v in cells))
    if len(cells) < len(names) ** 2:
        dtype = np.promote_types(dtype, np.float64)
    m = np.full((len(names), len(names)), np.nan, dtype)
    for i, j, v in cells:
        m[i, j] = v
    return m, names


class MichiganTrainer(HisfragTrainer):
    NEG_PAIR_RATIO = 1.0       # at most one negative per positive
    LOSS_REDUCTION = "sum"
    NEG_FULL_ROW = True        # negatives over the image's whole row
    geshaem_data_path = None

    def get_transforms(self):
        img_size = self.config.DATA.IMG_SIZE
        dev_norm = self.config.TPU.DEVICE_NORMALIZE

        def train_transform(img):
            img = T.random_crop(img, img_size, pad_if_needed=True, fill=255)
            # RandomResizedCrop(scale 0.6-1.0)
            scale = random.uniform(0.6, 1.0)
            side = max(int(img_size * scale ** 0.5), 8)
            img = T.random_crop(img, side)
            img = img.resize((img_size, img_size))
            img = _coarse_dropout(img, p=0.9)
            if random.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if random.random() < 0.5:
                img = img.transpose(Image.FLIP_TOP_BOTTOM)
            img = T.color_jitter(img, 0.2, 0.3, 0.3, 0.1, p=0.5)
            img = T.GaussianBlur(p=0.5, radius_max=1)(img)
            if random.random() < 0.2:
                img = img.convert("L").convert("RGB")
            if dev_norm:
                return np.asarray(img, np.uint8)
            return T.normalize_image(img)

        # center-crop -> 1.15x resize -> center-crop -> normalize, pooled
        # whole-batch in the scan's and the Geshaem loader's native pool
        val_transform = T.OneImgEvalZoom(img_size, emit_u8=dev_norm)
        return {"train": train_transform, "validation": val_transform,
                "val": val_transform, "test": val_transform}

    def get_dataloader(self, mode):
        if mode in self.data_loader_registers:
            return self.data_loader_registers[mode]
        if mode != "train":
            raise Exception("Only Train mode should be executed")
        dataset, _repeat = build_dataset(mode=mode, config=self.config,
                                         transforms=self.get_transforms())
        max_len = len(dataset) * 20
        self.logger.info(f"[{mode}] Dataset length: {max_len}")
        sampler = MPerClassSampler(dataset.data_labels, m=3,
                                   length_before_new_iter=max_len,
                                   seed=self.config.SEED + self.data_index)
        loader = DataLoader(dataset, sampler=sampler,
                            batch_size=self.local_batch_size,
                            num_workers=self.config.DATA.NUM_WORKERS,
                            drop_last=True)
        self.data_loader_registers[mode] = loader
        return loader

    # ---------------------------------------------------------- Geshaem test
    def geshaem_scores(self, dataset) -> Dict[str, Dict[str, List[float]]]:
        """Every pair of ``dataset`` (a GeshaemPatch) through the model:
        {fragment: {fragment: [1 - logit, ...]}}, both directions."""
        loader = DataLoader(dataset, batch_size=self.config.DATA.TEST_BATCH_SIZE,
                            num_workers=self.config.DATA.NUM_WORKERS)
        batch_time = AverageMeter()
        end = time.time()
        distance_map: Dict[str, Dict[str, List[float]]] = {}
        self.model.eval()
        with torch.inference_mode():
            for idx, (images, pairs) in enumerate(loader):
                x = self._to_device({"samples": images})["samples"]
                output = self.model(x).float().cpu().numpy().reshape(-1)
                for pair, score in zip(np.asarray(pairs), output):
                    frag_i = dataset.fragments[int(pair[0])]
                    frag_j = dataset.fragments[int(pair[1])]
                    distance_map.setdefault(frag_i, {}).setdefault(frag_j, []).append(1 - score)
                    distance_map.setdefault(frag_j, {}).setdefault(frag_i, []).append(1 - score)
                batch_time.update(time.time() - end)
                end = time.time()
                if idx % self.config.PRINT_FREQ == 0:
                    etas = batch_time.avg * (len(loader) - idx)
                    self.logger.info(
                        f"Testing: [{idx}/{len(loader)}]\t"
                        f"eta {datetime.timedelta(seconds=int(etas))}\t"
                        f"time {batch_time.val:.4f} ({batch_time.avg:.4f})")
        return distance_map

    def geshaem_metrics(self, distance_map, pos_pairs):
        """The mean- and the min-aggregated fragment distances' metrics:
        {"MEAN": (mAP, (top 1, Pr@k5, Pr@k10)), "MIN": ...}."""
        stds = []
        mean_map, min_map = {}, {}
        for source in distance_map:
            for dest in distance_map[source]:
                vals = distance_map[source][dest]
                avg_dis = sum(vals) / len(vals)
                if len(vals) > 1:
                    stds.append(statistics.stdev(vals))
                mean_map.setdefault(source, {})[dest] = avg_dis
                min_map.setdefault(source, {})[dest] = min(vals)
        if stds:
            avg_std = sum(stds) / len(stds)
            std_std = statistics.stdev(stds) if len(stds) > 1 else 0.0
            self.logger.info(f"N categories: {len(distance_map)}\t"
                             f"Avg_Std {avg_std:.3f}\t Std_Std {std_std:.3f}")
        results = {}
        for tag, agg in (("MEAN", mean_map), ("MIN", min_map)):
            matrix, names = fragment_distance_matrix(agg)
            m_ap, (top_1, prk5, prk10) = calc_map_prak(matrix, names, pos_pairs,
                                                       prak=(1, 5, 10))
            self.logger.info(f"Geshaem test {tag}: mAP {m_ap:.3f}\tTop 1 {top_1:.3f}\t"
                             f"Pr@k5 {prk5:.3f}\tPr@k10 {prk10:.3f}")
            results[tag] = (m_ap, (top_1, prk5, prk10))
        return results

    def geshaem_test(self, key: str = "geshaem_test") -> float:
        """Score all Geshaem pairs and report the mean- and min-aggregated
        mAPs; returns 1 - the better one."""
        if key in self.data_loader_registers:
            dataset = self.data_loader_registers[key]
        else:
            dataset = GeshaemPatch(self.geshaem_data_path, GeshaemPatch.Split.VAL,
                                   transform=self.get_transforms()["validation"])
            self.data_loader_registers[key] = dataset
        results = self.geshaem_metrics(self.geshaem_scores(dataset),
                                       dataset.fragment_to_group)
        return 1 - max(results["MEAN"][0], results["MIN"][0])

    # ---------------------------------------------------------- Michigan eval
    def validate_dataloader(self, split, remove_cache_file=False):
        """Scan ``split`` of the Michigan tree: (float16 distance matrix,
        the images' group labels, the scorer)."""
        config = self.config
        if "michigan_test" in self.data_loader_registers:
            dataset = self.data_loader_registers["michigan_test"]
        else:
            dataset = MichiganTest(
                config.DATA.DATA_PATH, split,
                transforms=self.get_transforms()[split.value],
                val_n_items_per_writer=config.DATA.EVAL_N_ITEMS_PER_CATEGORY)
            self.data_loader_registers["michigan_test"] = dataset
        if remove_cache_file:
            import glob

            for f in glob.glob(os.path.join(config.OUTPUT,
                                            f"{split.value}_rank{self.rank}_*.npz")):
                os.unlink(f)
        scorer = PairwiseScorer(self.model, num_outputs=1,
                                pair_chunk=config.DATA.TEST_BATCH_SIZE,
                                int8=config.TPU.INT8_SCORE)
        sim = scorer.score_dataset(dataset, batch_size=config.DATA.BATCH_SIZE,
                                   logger=self.logger, out_dir=config.OUTPUT,
                                   tag=split.value, rank=self.rank,
                                   world_size=self.world_size,
                                   num_workers=config.DATA.NUM_WORKERS)
        distance_matrix = (1.0 - sim.astype(np.float32)).astype(np.float16)
        self.logger.info("Distance matrix is generated!")
        return distance_matrix, dataset.data_labels, scorer

    def validate(self) -> float:
        if self.geshaem_data_path:
            self.geshaem_test()
        dm, labels, _ = self.validate_dataloader(MichiganTest.Split.VAL,
                                                 remove_cache_file=True)
        m_ap, top1, pr_k10, pr_k100 = get_metrics(dm.astype(np.float32),
                                                  np.asarray(labels))
        self.logger.info(f"Michigan eval: mAP {m_ap:.3f}\tTop 1 {top1:.3f}\t"
                         f"Pr@k10 {pr_k10:.3f}\tPr@k100 {pr_k100:.3f}")
        return 1 - m_ap

    def throughput_batch(self) -> np.ndarray:
        """TEST_BATCH_SIZE stacked pairs (i, i + 1) of the val images, the
        indices taken modulo their count."""
        ds = MichiganTest(self.config.DATA.DATA_PATH, MichiganTest.Split.VAL,
                          transforms=self.get_transforms()["validation"],
                          val_n_items_per_writer=self.config.DATA.EVAL_N_ITEMS_PER_CATEGORY)
        b = self.config.DATA.TEST_BATCH_SIZE
        images = np.stack([ds[i][0] for i in range(min(len(ds), b))])
        first = np.arange(b) % len(images)
        return np.stack([images[first], images[(first + 1) % len(images)]], axis=1)


def main(argv: Optional[List[str]] = None):
    """Run one mode; returns the trainer after ``train``, the val loss after
    ``eval``, ``1 - mAP`` of the Geshaem test after ``test`` and pairs/s
    after ``throughput``."""
    args = parse_option(argv)
    trainer = MichiganTrainer(args)
    trainer.geshaem_data_path = args.geshaem_data_path
    if args.mode == "eval":
        return trainer.validate()
    if args.mode == "test":
        return trainer.geshaem_test()
    if args.mode == "throughput":
        return trainer.throughput()
    return trainer.train()


if __name__ == "__main__":
    main()
