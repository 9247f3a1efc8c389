#!/usr/bin/env python3
"""Kernel times of two trees of this repository on one CUDA card, in turns.

    python3 chip_ab.py <other> [--phases 3,4,7,11,9,5,9w,13w,15d]

<other> is another root of the repository, for example a ``git archive``
of the parent commit unpacked into a git-ignored directory, or a copy of
this checkout with one change. It and this checkout ("tree") are timed
twice each, in the order other, tree, tree, other, each time in a process
of its own that builds that tree's kernels and runs its own
``chip_smoke.py`` phases:

- 3, 7, 11: the kernel rows of phases 3 (pair forward), 7 (backward at
  d = 64) and 11 (the 4-D kernels at d = 32), device ms behind the same
  device hold in every tree;
- 4: the device time of one 64-pair ``score_tokens_row`` chunk of the scan
  (pjs-S patch16_512, bf16, random weights and images from seed 0) under
  torch.profiler, in all and for each attention kernel, as phase 4's
  ``chunk_breakdown`` takes it;
- 9: the device time of one hisfrag training step (bf16, 16 images -> 49
  pairs, a synthetic corpus from a seed) under torch.profiler, in all and
  for each attention kernel, as phase 9's ``step_breakdown`` takes it;
- 15d (host clock): ``score_dense`` alone, as phase 15's score stage runs
  it (pjs patch8_64, bf16, random weights from seed 0, 150 random pieces:
  22,350 ordered pairs), the median pairs/s of runs 2-6 of six;
- 5, 9w, 13w (host clock, end to end): the scan's pairs/s (phase 5:
  ``hisfrag --mode test`` on its 64 JPEGs), and for the two training paths
  (phase 9: hisfrag, 16 images -> 49 pairs; phase 13: DIV2K, 128 pairs)
  the median step with the loader running, trained pairs/s and the host
  milliseconds to make one training item on one thread (16 items).

Prints the card, then every row's four times and other / tree over the
means of the two runs of each; each process's whole output goes to
``chiprun_out/ab_<i>.txt``. Needs one card.
"""

import json
import os
import subprocess
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
# chip_smoke.hold_device's 8192^3 bf16 products (~13 ms); set in every tree
# timed, so that two commits with different holds are timed alike
HOLD_PRODUCTS = 8


def step_profile(c):
    """{row: ms} of one hisfrag train step under the profiler: the device's
    busy time and each attention kernel's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vit_ed_tpu_torch.hisfrag import HisfragTrainer, parse_option

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        c.write_corpus(data, sub="train", seed=1)
        trainer = HisfragTrainer(parse_option(c.train_argv(
            data, os.path.join(tmp, "out"), "ab", "--batch-size", str(c.TRAIN_BATCH),
            "--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0")))
        trainer.setup_training(10)
        samples, targets = next(iter(trainer.get_dataloader("train")))
        host = trainer.prepare_data(samples, targets)
        for _ in range(3):
            trainer.train_step([host])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                trainer.train_step([host])
            torch.cuda.synchronize()
    rows = c.device_rows(prof, 2)
    out = {"device step": sum(r[1] for r in rows)}
    out.update({f"{key[:48]} x{cnt}": t for key, t, cnt in rows
                if "heads_" in key or "pair_attention" in key})
    return out


def chunk_profile(c):
    """{row: ms} of one 64-pair score_tokens_row chunk under the profiler:
    the device's busy time and each attention kernel's."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    config = c.get_config(types.SimpleNamespace(cfg=c.FLAGSHIP_CFG, opts=None))
    torch.manual_seed(0)
    model = c.build_model(config, torch.device("cuda")).eval()
    model.dtype = torch.bfloat16
    imgs = np.random.default_rng(0).normal(size=(3, 512, 512, 3)).astype(np.float32)
    with torch.inference_mode():
        x = torch.from_numpy(imgs).cuda()
        kv_row = model.context_kv_cache(model.encode(x[:1]))
        adv = model.prepare_x2_scan(x[1:]).index_select(
            0, torch.arange(64, device="cuda") % 2)
        for _ in range(3):
            model.score_tokens_row(kv_row, adv)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.score_tokens_row(kv_row, adv)
            torch.cuda.synchronize()
    rows = c.device_rows(prof, 3)
    out = {"chunk device": sum(r[1] for r in rows)}
    out.update({f"{key[:48]} x{cnt}": t for key, t, cnt in rows
                if "heads_" in key or "pair_attention" in key})
    return out


def scan_rate(c):
    """{row: value} of phase 5's scan: pairs/s and its seconds."""
    from vit_ed_tpu_torch.hisfrag import main

    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        c.write_corpus(data)
        scorer = main(["--cfg", c.FLAGSHIP_CFG, "--data-path", data, "--mode", "test",
                       "--output", os.path.join(tmp, "out"), "--tag", "ab"])[3]
    return {"scan pairs/s": scorer.pairs_done / scorer.scan_seconds,
            "scan s": scorer.scan_seconds}


def dense_rate(c):
    """{row: value} of ``score_dense`` at phase 15's shapes: the median
    pairs/s of runs 2-6 of six over 150 random pieces."""
    import numpy as np
    import torch

    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    config = c.get_config(types.SimpleNamespace(cfg=c.EVAL_CFG, opts=None))
    torch.manual_seed(0)
    model = c.build_model(config, torch.device("cuda")).eval()
    imgs = np.random.default_rng(0).normal(size=(150, 64, 64, 3)).astype(np.float32)
    scorer = PairwiseScorer(model, num_outputs=4, pair_chunk=c.PUZZLE_BATCH)
    rates = []
    for _ in range(6):
        scorer.score_dense(imgs, batch_size=c.PUZZLE_BATCH)
        rates.append(150 * 149 / scorer.dense_seconds["score"])
    return {"score_dense pairs/s": float(np.median(rates[1:]))}


def train_wall(c, puzzle):
    """{row: value} of phase 9's (hisfrag) or phase 13's (DIV2K) train
    epoch with the loader: the median step (host clock, ending in a
    synchronize), trained pairs/s over the steps after the first, and the
    host ms to make one training item on one thread."""
    import time

    import numpy as np
    import torch

    if puzzle:
        from vit_ed_tpu_torch import main as entry

        trainer_cls = entry.DefaultTrainer
    else:
        from vit_ed_tpu_torch import hisfrag as entry

        trainer_cls = entry.HisfragTrainer
    steps = []
    inner = trainer_cls.train_step

    def recorded(self, micro_batches):
        torch.cuda.synchronize()
        t0 = time.time()
        out = inner(self, micro_batches)
        torch.cuda.synchronize()
        pairs = (c.PUZZLE_BATCH if puzzle else
                 int(sum(b["pair_mask"].sum() for b in micro_batches)))
        steps.append((time.time() - t0, pairs))
        return out

    opts = ("--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0")
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        if puzzle:
            c.write_div2k(data)
            argv = c.puzzle_argv(data, out, "ab", "train", *opts)
        else:
            c.write_corpus(data, sub="train", seed=1)
            argv = c.train_argv(data, out, "ab", "--batch-size", str(c.TRAIN_BATCH), *opts)
        trainer_cls.train_step = recorded
        try:
            trainer = entry.main(argv)
        finally:
            trainer_cls.train_step = inner
        ds = trainer.get_dataloader("train").dataset
        t0 = time.perf_counter()
        for i in range(16):
            ds[i]
        host = (time.perf_counter() - t0) / 16
    ms = [t * 1e3 for t, _ in steps[1:]]
    return {"step ms median": float(np.median(ms)),
            "pairs/s": sum(p for _, p in steps[1:]) / (sum(ms) / 1e3),
            "host ms/item": host * 1e3}


def child(phases):
    """Run in the root of the tree to time: one JSON line of its rows."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as c

    def hold_device():
        if not c._HOLD:
            c._HOLD.append(torch.zeros(8192, 8192, device="cuda", dtype=torch.bfloat16))
        for _ in range(HOLD_PRODUCTS):
            torch.mm(c._HOLD[0], c._HOLD[0])

    c.hold_device = hold_device
    c._build.build_all()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    times = {"3": c.phase_times, "7": c.phase_backward_times, "11": c.phase_heads_times}
    rows = {}
    for phase in phases:
        if phase in ("4", "9"):
            profiled = chunk_profile(c) if phase == "4" else step_profile(c)
            rows.update({f"{phase}:{k}": v for k, v in profiled.items()})
        elif phase in ("5", "9w", "13w", "15d"):
            wall = (scan_rate(c) if phase == "5" else dense_rate(c) if phase == "15d"
                    else train_wall(c, phase == "13w"))
            rows.update({f"{phase}:{k}": v for k, v in wall.items()})
        else:
            rows.update({f"{phase}:{k}": v["ms"] for k, v in times[phase](gen).items()})
    print("AB " + json.dumps(rows))


def main(argv):
    if argv[:1] == ["--child"]:
        return child(argv[1].split(","))
    phases = "3,4,7,11,9"
    if "--phases" in argv:
        i = argv.index("--phases")
        phases = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    other, tree = os.path.abspath(argv[0]), ROOT
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, cwd in enumerate((other, tree, tree, other)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", phases],
                             cwd=cwd, capture_output=True, text=True)
        with open(os.path.join(out_dir, f"ab_{i}.txt"), "w") as f:
            f.write(res.stdout + res.stderr)
        if res.returncode:
            print(res.stdout[-2000:], res.stderr[-4000:])
            raise RuntimeError(f"timing run {i} in {cwd} failed")
        runs.append(json.loads([x for x in res.stdout.splitlines()
                                if x.startswith("AB ")][-1][3:]))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"other = {other}, tree = {tree}; ms unless named")
    print(f"  {'phase:row':40s} {'other':>8s} {'tree':>8s} {'tree':>8s} {'other':>8s}"
          f"  other/tree")
    for key in dict.fromkeys([*runs[1], *runs[0]]):
        t = [r.get(key) for r in runs]
        if None in t:
            print(f"  {key:40s} " + " ".join("       -" if x is None else f"{x:8.4f}"
                                             for x in t))
            continue
        print(f"  {key:40s} " + " ".join(f"{x:8.4f}" for x in t)
              + f"  {(t[0] + t[3]) / (t[1] + t[2]):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
