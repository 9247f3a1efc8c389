#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit_ed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, nvcc, g++, and
nothing from the JAX package. Phases, each printing its own lines:

1. the card, its power limit, torch/CUDA versions; the kernels are built
   from vit_ed_tpu_torch/csrc with nvcc (one process per source);
2. kernel against plain: every pair-attention wrapper on the card at the
   flagship shapes (B=8, C=384, 6 heads, S=1024/1025, CLS Sq=1), bf16 and
   f32, against its plain PyTorch version, max |kernel - plain| / max
   |plain| within 1e-4 (f32) and 2e-2 (bf16) on inputs whose last key
   dominates every row (a dropped last key reads O(1)), each launch
   writing into an output filled with NaN (an unstored row reads NaN);
   kv_shared must equal the materialised broadcast and CLS the full
   output's row 0 bit for bit;
3. kernel times at the main path's shapes (B=64 pairs, bf16): the kernel,
   the plain version, torch's scaled_dot_product_attention as a yardstick
   (never called by the port) and the card's bound;
4. the full-width, full-depth pjs-S patch16_512 model from a seed: f32 on
   the card against f32 on the CPU, bf16 against f32 on the card, and the
   launches of one 64-pair score_tokens_row chunk;
5. the scoring main path end to end: ``python -m vit_ed_tpu_torch.hisfrag
   --mode test`` (in process, bf16,
   configs/hisfrag/hisfrag20_patch16_512.yaml) on a synthetic corpus made
   from a seed, with every wrapper's launch count reset before and read
   after;
6. backward kernel against plain: every attention VJP on the card (B=8,
   S=1024/1025, CLS Sq=1; f32 within 1e-4 and bf16 within 2e-2 of each
   gradient's max) against ``pair_attention_backward_plain``, and two launches
   bit-equal (the kernels use no atomics);
7. backward kernel times at the training shapes (49 pairs, bf16): the
   kernel, the plain version, the backward of
   scaled_dot_product_attention through autograd as a yardstick, and the
   card's bound;
8. one full-width, full-depth f32 loss + backward of the hisfrag trainer on
   3 images and their mined pairs: the card's gradients against the CPU's
   (plain versions), per parameter;
9. the training main path end to end: ``python -m vit_ed_tpu_torch.hisfrag
   --mode train`` (in process, bf16, DROP_PATH_RATE 0.1, 16 images -> 49
   pairs per step, one epoch, validate before and after) on a synthetic
   corpus, launch counts reset before and read after; then the checkpoint
   is reloaded, two steps from one state must give equal parameters and
   AdamW moments bit for bit, one step is broken down with torch.profiler,
   and the host ms per training item is timed by stage, through the native
   pipeline and through the plain chain on the same items (equal bit for
   bit);
10. the 4-D kernels against plain: forward and dq / dk / dv through every
    route (``fused_attention``, ``fused_attention_heads``,
    ``fused_attention_flat`` and the five packed wrappers) at 12 heads of
    head_dim 32, at the shapes the puzzle path launches them (B=128: the
    decoder's S=65 with Sk 65 and 64 and CLS Sq=1 in both attentions, the
    encoder's S=64) and
    at B=8, S=1025 (Sk 1025 and 1024), and head_dim 16, 64, 128 at one
    shape, the forward held as in phase 2 (inputs whose last key dominates,
    outputs filled with NaN);
    bit-equal reruns; CLS == row 0 and shared kv == broadcast exactly;
11. 4-D kernel times (forward, dq, dkv) at the puzzle path's shapes (B=128,
    12 heads, head_dim 32, bf16: S=65, the encoder's S=64, Sq=1), at B=64,
    S=1025 and at the head_dim 32 scan's chunk (shared kv, B=16, S=1025),
    beside the plain versions, SDPA forward / backward and the card's bounds;
12. the full-width, full-depth pjs patch8_64 model (12 heads of 32, 8 + 8
    blocks) from a seed: f32 card against f32 CPU, bf16 against f32, and
    one f32 loss + backward of the DIV2K trainer, card against CPU;
13. the DIV2K main path end to end: ``python -m vit_ed_tpu_torch.main
    --mode train`` (in process, bf16, 128 pairs per step, one epoch with
    both validates) on a synthetic DIV2K made from a seed, launch counts (by
    wrapper and by shape) reset before and read after; then ``--mode eval``
    and ``--mode throughput``, each with counts of its own; then the O(N^2)
    scan at head_dim 32 (``vit_ed_tpu_torch.hisfrag --mode test`` with 12
    heads); the host ms per training item by stage, native and plain, as
    in phase 9;
14. the native input pipeline (``vit_ed_tpu_torch/native/pipeline.cc``),
    run before phase 5, the first phase that reads images: its g++ build
    (seconds, libjpeg linked or not, the decoder used, the CPU it was built
    for), then native against plain bit for bit on 16 JPEGs of ~600 x 700
    px: decode, the hisfrag train chain at 512, the eval crop and the
    PipelinePool batch;
15. puzzle evaluation end to end: ``python -m vit_ed_tpu_torch.evaluation``
    (in process, bf16, configs/puzzle/puzzle_eval_4bin_patch8_64.yaml,
    phase 13's checkpoint) on synthetic Cho / McGill / BGU puzzles of
    980 x 644 px made from a seed (two PNG and one JPEG each; 150 pieces,
    22,350 ordered pairs), launch counts (by shape, against the expected
    schedule) reset before and read after; pairs/s of ``score_dense`` and
    the ms per puzzle by stage, the accuracies; then score_dense against
    256 direct pair forwards (1e-2), the mixed-chunk schedule against the
    row-shared one (1e-2; the per-pair kv layout), the card in bf16 against
    the CPU in f32 on a 3 x 3 puzzle (5e-2), the native solver against the
    Python one (equal placements and best buddies), the scan's mixed-chunk
    fallback at patch16_512 (N = 16) against its row-sharded slab (1e-2;
    the pair kv kernel), one score_dense under the profiler, and the 4-D
    forward at the evaluation's shapes against plain (2e-2), timed;
16. Michigan / Geshaem writer retrieval at pjs-S patch16_384
    (configs/michigan/michigan_patch16_384.yaml: 576 patches + CLS, so
    S = 577 on every pair kernel): synthetic trees from a seed (8 and 80
    papyri x 4 JPEGs of ~700 x 900 px; 30 Geshaem JPEGs in 5 groups); every
    pair kernel of the path against plain at S = 577 / Sk = 576 (B = 33, the
    training pair buffer, and 64; the encoder's S = 576 at B = 16), forward
    as in phase 2 and dq / dkv as in phase 6, then timed with plain, SDPA
    and the bound; ``python -m vit_ed_tpu_torch.michigan --mode train``
    (batch 16, one epoch: the median step with the loader, trained pairs/s,
    the MFU line as logged, the device-only step, host ms per item of the
    Michigan chain native and plain); SIGTERM to a ``--mode train``
    subprocess after its first ``Train:`` line (exit 0, a mid-epoch
    checkpoint) and a rerun that continues the epoch to the uninterrupted
    update count; ``--mode eval`` (the val scan, N = 48: pairs/s, the slab
    against direct forwards, 1e-2, one chunk under the profiler) and
    ``--mode throughput``; ``--mode
    test`` (geshaem_test) and ``python -m
    vit_ed_tpu_torch.geshame_evaluation`` (pairs/s, the metrics, every batch
    of stacked pairs through the loader's whole-batch pool, the loader
    alone); every run with
    launch counts of its own, reset before and read after;
17. the ViT embedding baselines: (a) the ViT of
    configs/puzzle/vit_div2k_erosion7_4bin_patch8_64.yaml (embed 384, 12
    blocks, 12 heads x 32, S = 65) from a seed, f32 card against f32 CPU
    (embeddings and the triplet loss's gradients, 1e-3 of each max) and
    bf16 against f32 (5e-2); (b) the 4-D qkv forward, dq and dkv at
    main_vit's batch (B = 1,536 = 128 items x 4 directions x 3 images) and
    the testing forward (B = 1,024) against plain as in phase 10, timed
    with plain, SDPA and the bound, and a batch of 65,536 refused before
    any launch; (c) ``python -m vit_ed_tpu_torch.main_vit --mode train`` on
    phase 13's DIV2K (10 updates of 128 items: the step with the loader,
    the device-only step, launches by shape, the MFU line of the ViT
    count, peak memory, host ms per item by stage), then ``--mode eval``
    and ``--mode throughput``; (d) ``--mode test`` on one 384 x 384 px
    puzzle per subset (36 pieces, 10,080 embeddings each: ms per puzzle by
    stage, embeddings/s, the distances against direct forwards, 1e-2);
    (e) ``python -m vit_ed_tpu_torch.hisfrag_vit`` with ViT-S/16 at 512 px
    (S = 1025, 6 heads of 64: the pair route): the pair qkv kernels at
    B = 16 against plain and timed, ``--mode train`` on phase 9's train
    split (10 updates of 16 images), then ``eval``, ``test`` on phase 5's
    test split (metrics finite in [0, 1], the matrix against -(E E^T) of
    direct forwards, 1e-2) and ``throughput``; every run with launch counts
    of its own, reset before and read after.

18. the Pajigsaw entry, lr_finder, solver_driver and the BatchNorm
    baselines: (a) the pair kernels at the Pajigsaw shapes (C = 384, H = 6:
    the training batch of 64 stacked pairs at S = 1025 and the encoder's
    1024, with dq / dkv; score_dense's chunk of 12 at kv_shared, qkv and
    qkv_cls) against plain as in phases 2 and 6, then timed with plain,
    SDPA and the bound; (b) ``python -m vit_ed_tpu_torch.pajigsaw --mode
    train`` at pjs-S patch16_512 (configs/pajigsaw/pajigsaw_patch16_512.yaml)
    on a synthetic manifest from a seed (54 train images, 2 val, 2 test,
    each a 3 x 4 grid of 512 px JPEG fragments): 10 updates of 64 pairs and
    two validates that solve every val puzzle, the step with the loader, the
    device-only step, launches by shape, peak memory and the MFU line;
    score_dense against direct pair forwards (1e-2); then ``--mode eval``,
    ``test`` (the reconstructions decode) and ``throughput``, each with
    launch counts of its own; (c) the BatchNorm baselines at 512 px from
    seed 0 (resnet on resnet34; mixconv on resnet18 with 4 MetaFormer
    blocks of 512; ss, ss2, ss2ce on resnet34 with 2048 / 512): forwards in
    train mode (batch 16 for the SimSiam types, 4 for the others) and eval
    mode (batch 4), f32 card against f32 CPU (1e-3), bf16 against f32 in
    eval mode (5e-2; train mode's reading is printed), the running
    statistics card against CPU; one ss2 step at batch 16 card against CPU
    (1e-3: in f32 the loss and every running statistic, in f64 also every
    gradient; the f32 gradients' readings against the CPU and against f64
    are printed); ss2
    training through a trainer on phase 9's train split (>= 10 updates of
    16), two steps from one state bit for bit; (d) ``python -m
    vit_ed_tpu_torch.lr_finder`` on phase 13's DIV2K at B = 128, 30
    iterations, its 4-D launches added to phase 13's rows; (e) ``python -m
    vit_ed_tpu_torch.solver_driver`` on two synthetic JPEGs; (f)
    ``TPU.FAST_GELU`` f32 card against CPU (1e-3) and ``MODEL.DROP_RATE``
    0.1 reproducible from one generator seed and absent in eval.
19. the sharded test path, int8 scoring and explainability: (a) ``python -m
    vit_ed_tpu_torch.hisfrag --mode test --opts TPU.SHARDED_EVAL_METRICS
    True TPU.EVAL_SLAB_ON_DISK True`` on phase 5's corpus: its rows equal
    phase 5's scores bit for bit, its metrics phase 5's, no CSV; (b) the
    same at N = 256 in a subprocess (pairs/s, the token cache, the
    process's VmHWM); (c) at N = 128 in row blocks of 16: SIGKILL once two
    blocks are marked done, a rerun resumes, and its slab equals an
    uninterrupted scan's bit for bit; (d) the int8 GEMM (``ops/quant.py``,
    ``torch._int_mm``) at a 64-pair chunk's shapes and the CLS rows (M =
    64, 12), card against CPU bit for bit in f32 and bf16, timed against the
    bf16 product and Linear with its bound at the int8 peak, and the
    profiler's name of its kernel; (e) ``--mode test --opts
    TPU.INT8_SCORE True`` at N = 64: pairs/s and mAP next to phase 5's, the
    scores within 0.25 of bf16's, the pair kernels and int8 GEMMs launched;
    (f) ``python -m vit_ed_tpu_torch.evaluation`` with TPU.INT8_SCORE on
    one of phase 15's puzzles: the 4-D kernels and int8 GEMMs launched;
    (g) ``ops/explain.py``'s ``generate_relevance`` at full width on one
    pair, f32 card against CPU (1e-3 of the max), and ``keep_attn``
    forwards against fused ones (f32 1e-3, bf16 5e-2 of the max).
20. the serving tier at pjs-S patch16_512 bf16 (weights from seed 0): the
    host cost per launch of the pair forward through its registered operator
    (``torch.ops.vit_ed.pair_forward``) against the direct launch; (a) the six
    stages exported on the card with a symbolic batch (``serve.export_scorer``:
    seconds, the bundle's bytes, the weights stored once); (b) the ``pair``
    stage replayed at B = 1, 7 and 64 against the live model (bit equality,
    max |diff| within 2e-3, the replay's launches equal to the live
    forward's: 23 qkv, 1 qkv_cls, 12 kv); (c) ``serve.scan_pairs`` over phase
    5's corpus against phase 5's matrix (1e-2), pairs/s beside phase 5's;
    (d) ``serve.BundleServer`` on localhost, 8 client threads x 16 requests of
    1-4 pairs, on the float32 wire (``pair``) and the uint8 one
    (``pair_u8``): requests/s, pairs/s, device calls against requests, p50 /
    p99 latency, responses against a direct replay (1e-2); (e) ``python -m
    vit_ed_tpu_torch.export_serving --batch-sizes 8,64 --verify``; (f)
    ``python -m vit_ed_tpu_torch.serve --bundle <(a)'s bundle>`` in a child
    process started with (e): one ``/v1/score`` against the live model;
21. MoE on one card: ``configs/scale/hisfrag20_pjsL_moe_hybrid.yaml``
    without its mesh and its TP / SP / EP / FSDP switches (pjs-L: embed 1,024,
    16 heads x 64, 24 + 24 blocks, 8 experts on every second encoder block,
    top-2, jitter 0.1; 1.41 B parameters), bf16: (a) 5 updates of 8 images
    (phase 9's corpus) through the hisfrag trainer's step at full depth
    (step and device ms, peak memory, the MFU line, the aux terms, every
    pair kernel forward and backward launched, one step broken down as in
    phase 9), then ``python -m
    vit_ed_tpu_torch.hisfrag --mode train`` at 2 + 2 blocks (one epoch, both
    validates, the checkpoints); (b) a dense checkpoint from a seed loaded
    with ``--pretrained`` into the MoE configuration: every expert equal to
    its block's fc1 / fc2, the routers at their init; (c) its ``pair`` stage
    exported and replayed as in 20(b). The entry, the upcycling and the
    export run at 2 + 2 blocks: at full depth each checkpoint of the entry
    would write ~17 GB.
22. several processes: two ranks (``WORLD_SIZE`` 2, ``LOCAL_RANK`` 0, gloo)
    that share the card, each a child ``python chip_smoke.py --rank-child
    <spec>`` driving the entry's own ``main(argv)`` at full width, random
    weights from seed 0: (a) ``hisfrag --mode test`` on phase 5's 64 images
    in row blocks of 16, assembled (the merged matrix against phase 5's)
    and with ``TPU.SHARDED_EVAL_METRICS`` on disk (each rank's rows, the
    metrics against phase 19a's), each rank's range, pairs/s and launches;
    (b) the same sharded scan with rank 1 killed at its second row block,
    rank 0 failing within the group's timeout, and a rerun that scores no
    block with a ``.done`` marker, bit-equal to (a); (c) ``hisfrag --mode
    train`` (2 x 8 images, 3 updates, bf16, DropPath 0.1): the ranks'
    parameters bit-equal after every update, the pair kernels forward and
    backward launched on every rank, and one f32 update (SGD) against one
    process's on the concatenated batch with offset pair indices within
    1e-4 of each parameter's max; (d) ``main`` at pjs patch8_64 (2 x 64
    pairs, 3 updates) with the same checks and the 4-D kernels; (e) SIGTERM
    to rank 1 alone during a DIV2K epoch: both ranks save at the same update
    and exit 0, and the rerun's update count is an uninterrupted run's; (f)
    one rank with the default ``cpu:gloo,cuda:nccl`` backend: one DIV2K
    update through the same all-reduce, equal to the plain update bit for
    bit. NCCL across two cards needs a host with two.

``chip_ab.py`` times phases 3, 7 and 11, phase 4's scan chunk and phase 9's
device step of two trees in turns on one card.

Any failure raises (exit code != 0). The second-to-last lines are the
card (``nvidia-smi`` name, power limit) and one JSON object with the
kernels' numbers; the last line is the result JSON.
"""

import contextlib
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from vit_ed_tpu_torch.config import get_config  # noqa: E402
from vit_ed_tpu_torch.data.hisfrag import HisFrag20Test, Split  # noqa: E402
from vit_ed_tpu_torch.data.transforms import OneImgEval  # noqa: E402
from vit_ed_tpu_torch.device import resolve_device  # noqa: E402
from vit_ed_tpu_torch.models.build import build_model  # noqa: E402
from vit_ed_tpu_torch.ops import _build  # noqa: E402
from vit_ed_tpu_torch.ops import attention as A  # noqa: E402
from vit_ed_tpu_torch.ops import quant as Q  # noqa: E402

FLAGSHIP_CFG = os.path.join(ROOT, "configs", "hisfrag", "hisfrag20_patch16_512.yaml")
C, H, D = 384, 6, 64
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# a kernel's output or gradient against its plain version: max |x - plain|
# over max |plain|; the forward's on inputs whose last key dominates
# (dominant_last_key), so that a kernel that drops the last key or the last
# query row reads O(1). PERF.md has the sound and the fault readings.
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SOURCE = "vit_ed_tpu_torch/csrc/pair_attention.cu"
BWD_REPLACES = "vit_ed_tpu/ops/attention.py:613"   # _pair_backward
# wrapper -> the JAX function that reaches pl.pallas_call for it
REPLACES = {
    "qkv": "vit_ed_tpu/ops/attention.py:687",        # _pair_forward_qkv
    "kv_shared": "vit_ed_tpu/ops/attention.py:887",  # _pair_forward_q_kv_shared
    "qkv_cls": "vit_ed_tpu/ops/attention.py:794",    # _pair_forward_qkv_cls
    "kv": "vit_ed_tpu/ops/attention.py:740",         # _pair_forward_q_kv
    "packed": "vit_ed_tpu/ops/attention.py:500",     # _pair_forward
}
MAIN_PATH = ("qkv", "kv_shared", "qkv_cls")        # the scan (phase 5)
TRAIN_PATH_FWD = ("qkv", "qkv_cls", "kv")            # training (phase 9)
TRAIN_PATH_BWD = tuple(f"{name}_{kernel}" for name in ("qkv", "qkv_cls", "kv")
                       for kernel in ("dq", "dkv"))
# launches of one optimizer step at depth 12 + 12 with the CLS short-circuit:
# 12 encoder self-attentions, 11 + 1 (CLS) decoder self-attentions and 12
# per-pair cross-attentions, each one forward, one dq and one dkv launch
STEP_LAUNCHES = {f"{name}{kernel}": n
                 for name, n in (("qkv", 23), ("qkv_cls", 1), ("kv", 12))
                 for kernel in ("", "_dq", "_dkv")}
TRAIN_BATCH, TRAIN_PAIRS = 16, 49
# launches of one score_tokens_row chunk with 12 decoder blocks: self-attn
# in blocks 1..10 (block 0's is hoisted, block 11's is CLS-only), one
# shared-kv cross-attention per block; phase 4 measures and checks it
CHUNK_LAUNCHES = {"qkv": 10, "kv_shared": 12, "qkv_cls": 1, "kv": 0, "packed": 0}

# the 4-D route: pjs patch8_64 has 12 heads of head_dim 32
PUZZLE_CFG = os.path.join(ROOT, "configs", "puzzle", "div2k_erosion7_4bin_patch8_64.yaml")
HH, HD = 12, 32
HEADS_SOURCE = "vit_ed_tpu_torch/csrc/heads_attention.cu"
HEADS_BWD_SOURCE = "vit_ed_tpu_torch/csrc/heads_attention_bwd.cu"
HEADS_REPLACES = {"forward": "vit_ed_tpu/ops/attention.py:245",   # _pallas_fwd_heads
                  "flat": "vit_ed_tpu/ops/attention.py:294",      # _pallas_fwd
                  "dq": "vit_ed_tpu/ops/attention.py:318",        # _pallas_dq
                  "dkv": "vit_ed_tpu/ops/attention.py:338"}       # _pallas_dkv
PUZZLE_PATH = ("qkv", "qkv_cls", "kv")     # the layouts a puzzle train step runs
PUZZLE_BATCH = 128
SCAN32_IMAGES = 16      # N of the head_dim 32 scan: its chunks hold <= N pairs
# launches of one optimizer step at depth 8 + 8 with the CLS short-circuit:
# 8 encoder self-attentions, 7 + 1 (CLS) decoder self-attentions and 8
# cross-attentions, each one forward, one dq and one dkv launch
PUZZLE_STEP_LAUNCHES = {f"heads_{name}{kernel}": n
                        for name, n in (("qkv", 15), ("qkv_cls", 1), ("kv", 8))
                        for kernel in ("", "_dq", "_dkv")}
# the same by shape, (counter, Sq, Sk) -> launches per step at B = PUZZLE_BATCH:
# the encoder adds no CLS token, so its 8 self-attentions run at S = 64; the
# last decoder block computes its CLS row only, in both attentions
PUZZLE_STEP_SHAPES = {(f"heads_{name}{kernel}", n_q, n_k): n
                      for name, n_q, n_k, n in (("qkv", 64, 64, 8), ("qkv", 65, 65, 7),
                                                ("qkv_cls", 1, 65, 1), ("kv", 65, 64, 7),
                                                ("kv", 1, 64, 1))
                      for kernel in ("", "_dq", "_dkv")}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def ptxas_lines(logs):
    """nvcc's -Xptxas -v lines on registers, shared memory and spills, each
    after the (mangled) name of its kernel."""
    name = ""
    for line in "".join(logs.values()).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "registers" in line or "spill" in line:
            yield f"{name}: {line.strip()}"


def rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def dominant_last_key(q, k, v):
    """In place on f32 [..., Sq, D] / [..., Sk, D] views: every q row gets the
    component 2 along u = (1, ..., 1) / sqrt(D) and the last key is
    (ln(Sk) + 1) * sqrt(D) / 2 * u, so that its logit q.k / sqrt(D) is
    ln(Sk) + 1 in every row (a softmax weight of ~0.6 against Sk - 1
    unit-normal keys, in both routes' chains); the last value row is
    (3, -3, 3, ...)."""
    d, n_k = q.shape[-1], k.shape[-2]
    u = torch.full((d,), d ** -0.5, device=q.device)
    q -= (q @ u)[..., None] * u
    q += 2 * u
    k[..., -1, :] = (math.log(n_k) + 1) * d ** 0.5 / 2 * u
    v[..., -1, :] = 3.0 - 6.0 * (torch.arange(d, device=q.device) % 2)


def probe_packed(q, kv, h):
    """dominant_last_key on the heads of q [B, Sq, C] and a fused kv [., Sk, 2C]."""
    c = q.shape[-1]
    dominant_last_key(A._heads(q, h), A._heads(kv[..., :c], h), A._heads(kv[..., c:], h))


def forward_reading(out, ref):
    """(max |out - ref|, that over max |ref|)."""
    e = (out.float() - ref.float()).abs().max().item()
    return e, e / max(ref.float().abs().max().item(), 1e-12)


def poison(like):
    """A NaN-filled tensor of ``like``'s shape and type, handed to the kernel
    as its output, so that rows it never writes read NaN, whatever the
    allocator held there before."""
    return torch.full(tuple(like.shape), float("nan"), dtype=like.dtype, device="cuda")


def launch(layout, *tensors, h=H):
    """A wrapper's call through ``A._attend`` (the dispatch every wrapper
    makes): ``call()`` allocates the output, ``call(out)`` writes into
    ``out``."""
    return lambda out=None: A._attend(layout, tensors, h, None, out=out)


def heads(x):
    return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()


def cases(gen, dtype, b, s, sk, probe=False):
    """wrapper -> (kernel call, plain call, SDPA call) on fresh inputs; with
    ``probe`` the last key of every (batch, head) dominates."""
    qkv = rand(gen, b, s, 3 * C, dtype=torch.float32)
    q = rand(gen, b, s, C, dtype=torch.float32)
    kv1 = rand(gen, 1, sk, 2 * C, dtype=torch.float32)
    kv = rand(gen, b, sk, 2 * C, dtype=torch.float32)
    if probe:
        probe_packed(qkv[..., :C], qkv[..., C:], H)
        probe_packed(q, kv, H)
        probe_packed(q, kv1, H)
    qkv, q, kv1, kv = (t.to(dtype) for t in (qkv, q, kv1, kv))
    q1 = q[:, :1].contiguous()
    k, v = kv.split(C, -1)
    k, v = k.contiguous(), v.contiguous()
    sc = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (heads(t) for t in qkv.split(C, -1))
    k1h, v1h = (heads(t.expand(b, -1, -1)) for t in kv1.split(C, -1))
    return {
        "qkv": (launch("qkv", qkv),
                lambda: A.pair_attention_plain(*qkv.split(C, -1), H, sc),
                lambda: sdpa(qh, kh, vh),
                {"qkv": qkv}),
        "kv_shared": (launch("kv_shared", q, kv1),
                      lambda: A.pair_attention_plain(q, *kv1.split(C, -1), H, sc),
                      lambda: sdpa(heads(q), k1h, v1h),
                      {"q": q, "kv1": kv1}),
        "kv_shared_cls": (launch("kv_shared", q1, kv1),
                          lambda: A.pair_attention_plain(q1, *kv1.split(C, -1), H, sc),
                          None, {}),
        "qkv_cls": (launch("qkv_cls", qkv),
                    lambda: A.pair_attention_plain(
                        *(t[:, :1] if i == 0 else t
                          for i, t in enumerate(qkv.split(C, -1))), H, sc),
                    lambda: sdpa(qh[:, :, :1], kh, vh),
                    {}),
        "kv": (launch("kv", q, kv),
               lambda: A.pair_attention_plain(q, k, v, H, sc),
               lambda: sdpa(heads(q), heads(k), heads(v)),
               {}),
        "packed": (launch("packed", q, k, v),
                   lambda: A.pair_attention_plain(q, k, v, H, sc),
                   lambda: sdpa(heads(q), heads(k), heads(v)),
                   {}),
    }


def phase_kernels_vs_plain(gen):
    print("== phase 2: kernel against plain (B=8, C=384, H=6; the last key of every "
          "(batch, head) dominant)", flush=True)
    err = {name: 0.0 for name in REPLACES}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1024, 1025):
            cs = cases(gen, dtype, 8, s, 1024, probe=True)
            outs = {}
            for name, (kern, plain, _lib, _inp) in cs.items():
                ref = plain()
                out = kern(poison(ref))
                torch.cuda.synchronize()
                e, rel = forward_reading(out, ref)
                ok = rel <= TOL[dtype]
                print(f"  {name:14s} {str(dtype)[6:]:8s} S={s} max|kernel-plain|={e:.3e}, "
                      f"/max|plain|={rel:.3e} tol={TOL[dtype]:g} "
                      f"{'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} {dtype} S={s}: kernel != plain")
                key = "kv_shared" if name == "kv_shared_cls" else name
                err[key] = max(err[key], e)
                outs[name] = out
            inp = cs["kv_shared"][3]
            bcast = A.fused_attention_packed_kv(
                inp["q"], inp["kv1"].expand(8, -1, -1).contiguous(), H)
            torch.cuda.synchronize()
            if not torch.equal(outs["kv_shared"], bcast):
                raise AssertionError("kv_shared != kv on the broadcast")
            if not torch.equal(outs["qkv_cls"], outs["qkv"][:, :1]):
                raise AssertionError("qkv_cls != row 0 of qkv")
            print(f"  {str(dtype)[6:]} S={s}: kv_shared == broadcast kv and "
                  f"cls == full row 0, bit for bit", flush=True)
    return err


_HOLD = []


def hold_device():
    """Keep the card busy for ~13 ms (eight 8192^3 bf16 products) so that
    the calls timed next are all enqueued before the first of them starts:
    the events then bracket the device's time, not the host's time to issue
    small launches (five CLS backwards through autograd took up to 4.4 ms of
    host time on a slow host, more than the ~5 ms of three products). It
    also leaves the L2 cache cold, as a caller inside a model finds it."""
    if not _HOLD:
        _HOLD.append(torch.zeros(8192, 8192, device="cuda", dtype=torch.bfloat16))
    for _ in range(8):
        torch.mm(_HOLD[0], _HOLD[0])


def timed(fn, n=20, inner=5, warmup=3):
    """Median device milliseconds per call of ``fn``: n timed runs (CUDA
    events) of ``inner`` back-to-back calls each, enqueued behind
    ``hold_device``, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        hold_device()
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def bound(name, b, s, sk):
    """(bound_ms, bound_by): the larger of FLOPs over the bf16 peak and
    bytes (each input read once, each output written once) over HBM."""
    sq = 1 if name == "qkv_cls" else s
    flops = 4 * b * H * sq * sk * D
    el = {
        "qkv": b * s * 3 * C + b * s * C,
        "qkv_cls": b * (C + 2 * sk * C) + b * C,   # q row 0 + K/V + out
        "kv_shared": b * s * C + sk * 2 * C + b * s * C,
        "kv": b * s * C + b * sk * 2 * C + b * s * C,
        "packed": b * s * C + 2 * b * sk * C + b * s * C,
    }[name]
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * el / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_times(gen):
    print("== phase 3: kernel times at the main path's shapes (B=64, bf16)",
          flush=True)
    b, s, sk = 64, 1025, 1024
    cs = cases(gen, torch.bfloat16, b, s, sk)
    res = {}
    for name in REPLACES:
        kern, plain, lib, _ = cs[name]
        kv_len = s if name in ("qkv", "qkv_cls") else sk
        r = {"ms": timed(kern), "plain_ms": timed(plain, inner=1),
             "library_ms": timed(lib)}
        r["bound_ms"], r["bound_by"] = bound(name, b, s, kv_len)
        res[name] = r
        print(f"  {name:10s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
              f"  sdpa {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it); "
              f"{CHUNK_LAUNCHES[name]} launches per 64-pair chunk", flush=True)
    del cs
    torch.cuda.empty_cache()
    return res


def phase_model(gen):
    print("== phase 4: pjs-S patch16_512, full width and depth, seed 0",
          flush=True)

    class Args:
        cfg = FLAGSHIP_CFG
        opts = None

    config = get_config(Args())
    torch.manual_seed(0)
    cpu_model = build_model(config, torch.device("cpu")).eval()
    model = build_model(config, torch.device("cuda")).eval()
    model.load_state_dict(cpu_model.state_dict())
    print(f"  {sum(p.numel() for p in model.parameters())} params, "
          f"depth {len(model.blocks)}+{len(model.cross_blocks)}, "
          f"{model.num_patches} patches, compute {model.dtype}", flush=True)
    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.normal(size=(3, 512, 512, 3)).astype(np.float32))

    def logits(m, dev, dtype):
        m.dtype = dtype
        with torch.inference_mode():
            x = imgs.to(dev)
            kv_row = m.context_kv_cache(m.encode(x[:1]))
            return m.score_tokens_row(kv_row, m.prepare_x2_scan(x[1:])).float().cpu()

    t0 = time.time()
    ref = logits(cpu_model, "cpu", torch.float32)
    print(f"  f32 CPU (plain attention) logits {ref.flatten().tolist()} "
          f"in {time.time() - t0:.1f}s", flush=True)
    f32 = logits(model, "cuda", torch.float32)
    bf16 = logits(model, "cuda", torch.bfloat16)
    e32 = (f32 - ref).abs().max().item()
    e16 = (bf16 - f32).abs().max().item()
    print(f"  f32 card {f32.flatten().tolist()}  max|card-CPU| {e32:.3e} (tol 1e-3)")
    print(f"  bf16 card {bf16.flatten().tolist()}  max|bf16-f32| {e16:.3e} "
          f"(tol 5e-2)", flush=True)
    if not (e32 <= 1e-3 and e16 <= 5e-2 and torch.isfinite(bf16).all()):
        raise AssertionError("full-width model disagrees")

    # launches of one 64-pair chunk of the scan's inner op
    model.dtype = torch.bfloat16
    with torch.inference_mode():
        x = imgs.cuda()
        kv_row = model.context_kv_cache(model.encode(x[:1]))
        adv = model.prepare_x2_scan(x[1:]).index_select(
            0, torch.arange(64, device="cuda") % 2)
        A.reset_launch_counts()
        model.score_tokens_row(kv_row, adv)
        torch.cuda.synchronize()
    per_chunk = {name: A.launches[name] for name in CHUNK_LAUNCHES}
    print(f"  launches per 64-pair score_tokens_row chunk: {per_chunk}", flush=True)
    chunk_breakdown(model, kv_row, adv)
    if per_chunk != CHUNK_LAUNCHES:
        raise AssertionError("unexpected launch schedule of a scan chunk")
    del model, cpu_model
    torch.cuda.empty_cache()
    return per_chunk


def device_rows(prof, runs):
    """(name, ms per run, launches per run) of every kernel and copy the
    profiler saw on the card, largest first. Kernel events only: aten ops
    carry their kernels' time again, and so do the device-side spans of
    user annotations (``Optimizer.step#AdamW.step``)."""
    rows = [(e.key, e.self_device_time_total / (runs * 1e3), e.count // runs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def chunk_breakdown(model, kv_row, adv):
    """Where the time of one 64-pair score_tokens_row chunk goes: its wall
    time (CUDA events) and torch.profiler's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        ms = timed(lambda: model.score_tokens_row(kv_row, adv), n=5, inner=2)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                model.score_tokens_row(kv_row, adv)
            torch.cuda.synchronize()
    rows = device_rows(prof, 3)
    busy = sum(r[1] for r in rows)
    print(f"  one {adv.shape[0]}-pair chunk: {ms:.2f} ms wall (CUDA events); profiler "
          f"device time {busy:.2f} ms/chunk" + ("" if rows else " (not measured:"
                                               " the profiler saw no device time)"))
    for key, t, cnt in rows[:12]:
        print(f"    {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}%  x{cnt:<4d} {key[:90]}")
    return rows


def write_corpus(root, writers=16, pages=2, frags=2, seed=0, sub="test"):
    """Synthetic HisFrag split: writer-correlated noise textures as
    ``<sub>/w{W}_{P}_{F}.jpg``, ~600 x 700 px."""
    from PIL import Image

    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)

    # the draws in order; the encodes on threads (PIL releases the GIL)
    with ThreadPoolExecutor(8) as pool:
        futs = []
        for w in range(writers):
            base = rng.integers(0, 256, size=(600 + 8 * w, 700, 3))
            for p in range(pages):
                for f in range(frags):
                    arr = np.clip(base + rng.integers(-40, 40, base.shape), 0, 255)
                    futs.append(pool.submit(
                        Image.fromarray(arr.astype(np.uint8)).save,
                        os.path.join(d, f"w{w:03d}_{p}_{f}.jpg"), quality=90))
        for fut in futs:
            fut.result()
    return writers * pages * frags


def scan_vs_direct(data, dm, pairs, opts=None):
    """The scan's scores (1 - distance) against direct pair forwards of the
    same seeded model at ``pairs`` of the test split."""
    config = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=opts))
    torch.manual_seed(config.SEED)
    model = build_model(config, torch.device("cuda")).eval()
    ds = HisFrag20Test(data, Split.TEST, transform=OneImgEval(512, crop=True))
    x = torch.from_numpy(np.stack([np.stack([ds[i][0], ds[j][0]])
                                   for i, j in pairs])).cuda()
    with torch.inference_mode():
        direct = model(x).float().cpu().numpy()[:, 0]
    scan = np.asarray([1.0 - float(dm[i, j]) for i, j in pairs])
    gap = float(np.abs(direct - scan).max())
    # bf16 logits of two schedules (different GEMM batch shapes), then the
    # float16 score and distance roundings of the scan
    print(f"  scan vs direct pair forward at {pairs}: max gap {gap:.3e} "
          f"(tol 1e-2)", flush=True)
    if gap > 1e-2:
        raise AssertionError("scan scores differ from direct forwards")


def phase_main_path(tmp):
    from vit_ed_tpu_torch.hisfrag import main

    print("== phase 5: main path, python -m vit_ed_tpu_torch.hisfrag --mode test",
          flush=True)
    data = os.path.join(tmp, "data")
    n = write_corpus(data)
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    t0 = time.time()
    metrics, dm, names, scorer = main([
        "--cfg", FLAGSHIP_CFG, "--data-path", data, "--mode", "test",
        "--output", os.path.join(tmp, "out"), "--tag", "smoke"])
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = {name: A.launches[name] for name in REPLACES}
    print(f"  mAP {metrics[0]:.3f}\tTop 1 {metrics[1]:.3f}\t"
          f"Pr@k10 {metrics[2]:.3f}\tPr@k100 {metrics[3]:.3f}")
    print(f"  {n} images, {scorer.pairs_done} pairs scored in "
          f"{scorer.scan_seconds:.3f}s: {scorer.pairs_done / scorer.scan_seconds:.1f} "
          f"pairs/s (scan incl. encode + token cache; {wall:.1f}s with model "
          f"build and decode); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  launches on the main path: {counts}", flush=True)
    if dm.shape != (n, n) or not np.isfinite(dm.astype(np.float32)).all():
        raise AssertionError("distance matrix is not finite [N, N]")
    if not np.array_equal(dm, dm.T) or scorer.pairs_done != n * (n + 1) // 2:
        raise AssertionError("scan did not cover the symmetric pair space")
    if not all(0.0 <= float(m) <= 1.0 for m in metrics):
        raise AssertionError(f"metrics out of range: {metrics}")
    for name in MAIN_PATH:
        if counts[name] <= 0:
            raise AssertionError(f"the main path never launched {name}")

    # upper triangle only: the lower one mirrors (j, i), and the model is
    # not symmetric in its two images
    scan_vs_direct(data, dm, [(0, 0), (0, 5), (3, 17), (9, 20), (40, 63)])
    return counts, {"metrics": metrics, "dm": dm,
                    "rate": scorer.pairs_done / scorer.scan_seconds}


# ---------------------------------------------------------------------------
# the training slice: backward kernels, gradients, the train main path
# ---------------------------------------------------------------------------

VJP_WRAPPERS = {
    "qkv": (A.fused_attention_packed_qkv, ("qkv",)),
    "qkv_cls": (A.fused_attention_packed_qkv_cls, ("qkv",)),
    "kv": (A.fused_attention_packed_kv, ("q", "kv")),
    "packed": (A.fused_attention_packed, ("q", "k", "v")),
}


def vjp_inputs(gen, dtype, b, s, sk):
    return {"qkv": rand(gen, b, s, 3 * C, dtype=dtype),
            "q": rand(gen, b, s, C, dtype=dtype),
            "kv": rand(gen, b, sk, 2 * C, dtype=dtype),
            "k": rand(gen, b, sk, C, dtype=dtype),
            "v": rand(gen, b, sk, C, dtype=dtype),
            "do": rand(gen, b, s, C, dtype=dtype)}


def vjp_graph(name, t):
    """(differentiable inputs, output, cotangent) of one wrapper call."""
    fn, names = VJP_WRAPPERS[name]
    args = [t[n].detach().requires_grad_() for n in names]
    out = fn(*args, H)
    return args, out, t["do"][:, :out.shape[1]].contiguous()


def plain_grads(name, t, do):
    """``pair_attention_backward_plain`` on the wrapper's q, k, v, put into
    the wrapper's gradient layout."""
    _fn, names = VJP_WRAPPERS[name]
    qkv, cols, c, rows = A._operands(name, [t[n] for n in names])
    dq, dk, dv = A.pair_attention_backward_plain(
        *A._slices(qkv, cols, c, rows), do, H, D ** -0.5)
    if len(names) == 1:
        pad = torch.zeros_like(dk)
        pad[:, :dq.shape[1]] = dq
        return [torch.cat([pad, dk, dv], -1)]
    if len(names) == 2:
        return [dq, torch.cat([dk, dv], -1)]
    return [dq, dk, dv]


def phase_backward_vs_plain(gen):
    print("== phase 6: backward kernel against plain (B=8, C=384, H=6); "
          "design: two launches, fixed summation order, no atomics", flush=True)
    err = {name: 0.0 for name in VJP_WRAPPERS}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1024, 1025):
            t = vjp_inputs(gen, dtype, 8, s, 1024)
            for name in VJP_WRAPPERS:
                args, out, do = vjp_graph(name, t)
                got = torch.autograd.grad(out, args, do, retain_graph=True)
                again = torch.autograd.grad(out, args, do)
                ref = plain_grads(name, t, do)
                torch.cuda.synchronize()
                worst = 0.0
                for g, g2, r in zip(got, again, ref):
                    if not torch.equal(g, g2):
                        raise AssertionError(f"{name}_bwd: two launches differ")
                    e = (g.float() - r.float()).abs().max().item()
                    worst = max(worst, e / r.float().abs().max().item())
                    err[name] = max(err[name], e)
                ok = worst <= TOL[dtype] and all(torch.isfinite(g).all() for g in got)
                print(f"  {name + '_bwd':12s} {str(dtype)[6:]:8s} S={s} "
                      f"max|kernel-plain|/max|grad|={worst:.3e} tol={TOL[dtype]:g} "
                      f"bit-equal twice {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name}_bwd {dtype} S={s}: kernel != plain")
                if name == "qkv_cls" and torch.count_nonzero(got[0][:, 1:, :C]):
                    raise AssertionError("CLS backward: dq rows past 0 not zero")
    return err


def bwd_bound(name, b, s, sk):
    """(bound_ms, bound_by) of one backward: 10 * B * H * Sq * Sk * 64 useful
    FLOPs (five products) over the bf16 peak, against the bytes of q, k, v,
    do read once and the whole gradient written once over HBM."""
    sq = 1 if name == "qkv_cls" else s
    flops = 10 * b * H * sq * sk * D
    if name in ("qkv", "qkv_cls"):
        el_in = (b * s * 3 * C if name == "qkv" else b * (C + 2 * sk * C)) + b * sq * C
        el_out = b * s * 3 * C
    else:
        el_in = b * s * C + b * sk * 2 * C + b * sq * C
        el_out = el_in - b * sq * C
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * (el_in + el_out) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bwd_flops(kind, b, h, sq, sk, d):
    """(useful, executed) FLOPs of a backward launch: ``useful`` counts the
    products the function needs (dq: S, dP, dQ; dkv: S, dP, dV, dK; both: 5,
    as the bounds do), ``executed`` the products the kernels run (dq
    recomputes S and dP in its second pass: 5 + 4 = 9)."""
    useful, executed = {"dq": (3, 5), "dkv": (4, 4), "both": (5, 9)}[kind]
    one = 2 * b * h * sq * sk * d
    return useful * one, executed * one


def rate(kind, b, h, sq, sk, d, ms, bound_ms):
    """The achieved rates of one backward row and its share of the bound."""
    useful, executed = bwd_flops(kind, b, h, sq, sk, d)
    return (f"{useful / ms / 1e9:.1f} TFLOP/s useful, {executed / ms / 1e9:.1f} "
            f"executed, {100 * bound_ms / ms:.1f}% of bound")


def backward_rows(name, t, b, s, sk, note):
    """Times of one wrapper's VJP on the inputs ``t`` (bf16): dq + dkv
    through autograd beside the plain backward and SDPA's backward, then
    each of the two kernels alone on the views the wrapper hands them, with
    their bounds; prints one line (ending in ``note``) and returns the rows
    ``<name>_bwd``, ``<name>_dq`` and ``<name>_dkv``."""
    _fn, names = VJP_WRAPPERS[name]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kv_len = s if name in ("qkv", "qkv_cls") else sk
    args, out, do = vjp_graph(name, t)
    qkv, cols, c, rows = A._operands(name, [t[n] for n in names])
    q, k, v = (heads(x).requires_grad_() for x in A._slices(qkv, cols, c, rows))
    lib_out = sdpa(q, k, v)
    lib_do = heads(do)
    r = {"ms": timed(lambda: torch.autograd.grad(out, args, do, retain_graph=True)),
         "plain_ms": timed(lambda: plain_grads(name, t, do), n=5, inner=1),
         "library_ms": timed(lambda: torch.autograd.grad(
             lib_out, (q, k, v), lib_do, retain_graph=True))}
    r["bound_ms"], r["bound_by"] = bwd_bound(name, b, s, kv_len)
    res = {name + "_bwd": r}
    sq = 1 if name == "qkv_cls" else s
    line = (f"  {name + '_bwd':12s} dq + dkv {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} "
            f"ms  sdpa backward {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; {rate('both', b, H, sq, kv_len, D, r['ms'], r['bound_ms'])})")
    # each of the two kernels alone, on the views the wrapper hands them
    tensors = [t[n] for n in names]
    qv, kv_, vv = A._heads_views(name, tensors, H)
    dq, dk, dv = A._heads_views(name, [torch.empty_like(x) for x in tensors], H)
    doh = A._to_heads(name, do, H)
    stats = A._launch_heads_dq(name, qv, kv_, vv, doh, dq, D ** -0.5, "")
    for kind, fn in (
            ("dq", lambda: A._launch_heads_dq(name, qv, kv_, vv, doh, dq, D ** -0.5, "")),
            ("dkv", lambda: A._launch_heads_dkv(name, qv, kv_, vv, doh, dk, dv, stats,
                                                D ** -0.5, ""))):
        rk = {"ms": timed(fn), "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
              "library": "sdpa backward: dq, dk and dv together",
              "plain": "pair_attention_backward_plain: dq, dk and dv together",
              "shape": f"B={b} H={H} Sq={qv.shape[2]} Sk={kv_len} d={D} bf16"}
        rk["bound_ms"], rk["bound_by"] = heads_bound(kind, b, qv.shape[2], kv_len, h=H, d=D)
        res[f"{name}_{kind}"] = rk
        line += (f"; {kind} {rk['ms']:.4f} ms (bound {rk['bound_ms']:.4f} {rk['bound_by']}; "
                 f"{rate(kind, b, H, sq, kv_len, D, rk['ms'], rk['bound_ms'])})")
    print(line + f"; {note}", flush=True)
    return res


def phase_backward_times(gen):
    print(f"== phase 7: backward kernel times at the training shapes "
          f"(B={TRAIN_PAIRS} pairs, bf16)", flush=True)
    b, s, sk = TRAIN_PAIRS, 1025, 1024
    t = vjp_inputs(gen, torch.bfloat16, b, s, sk)
    res = {}
    for name in VJP_WRAPPERS:
        res.update(backward_rows(
            name, t, b, s, sk,
            f"{STEP_LAUNCHES.get(name + '_dq', 0)} backwards per train step"))
    # the encoder's backward runs at the image batch, not the pair batch
    te = vjp_inputs(gen, torch.bfloat16, TRAIN_BATCH, 1024, 1024)
    args, out, do = vjp_graph("qkv", te)
    enc = timed(lambda: torch.autograd.grad(out, args, do, retain_graph=True))
    bound_ms, by = bwd_bound("qkv", TRAIN_BATCH, 1024, 1024)
    print(f"  qkv_bwd at the encoder's shape (B={TRAIN_BATCH}, S=1024): "
          f"{enc:.4f} ms, bound {bound_ms:.4f} ms ({by})")
    # the per-pair cross-attention forward, first on a main path here
    kern, plain, lib, _ = cases(gen, torch.bfloat16, b, s, sk)["kv"]
    r = {"ms": timed(kern), "plain_ms": timed(plain, inner=1), "library_ms": timed(lib)}
    r["bound_ms"], r["bound_by"] = bound("kv", b, s, sk)
    res["kv"] = r
    print(f"  kv (forward)  kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  "
          f"sdpa {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}); {STEP_LAUNCHES['kv']} launches per train step", flush=True)
    del t, te, out
    torch.cuda.empty_cache()
    return res


def train_argv(data, out, tag, *extra):
    return ["--cfg", FLAGSHIP_CFG, "--data-path", data, "--mode", "train",
            "--output", out, "--tag", tag, *extra]


def phase_gradients(tmp):
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer, parse_option

    print("== phase 8: one full-width f32 loss + backward, card against CPU "
          "(3 images, their mined pairs, depth 12 + 12, drop path 0)", flush=True)
    rng = np.random.default_rng(1)
    samples = rng.normal(size=(3, 512, 512, 3)).astype(np.float32)
    targets = np.asarray([0, 0, 1], np.int32)
    grads, losses = {}, {}
    for device in ("cpu", "cuda"):
        # no data path: the batch below is made here, no loader is built
        trainer = HisfragTrainer(parse_option(train_argv(
            os.path.join(tmp, "none"), os.path.join(tmp, "out"), f"grad_{device}",
            "--device", device, "--disable_amp", "--batch-size", "3", "--opts",
            "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.AUTO_RESUME", "False",
            "TPU.MAX_TRAIN_PAIRS", "3")))
        trainer.setup_training(1)
        np.random.seed(0)
        batch = trainer.prepare_data(samples, targets)
        t0 = time.time()
        trainer.model.train()
        A.reset_launch_counts()
        loss = trainer.loss_fn(trainer.model, trainer._to_device(batch))
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {n: p.grad.detach().cpu() for n, p in
                         trainer.model.named_parameters() if p.grad is not None}
        missing = [n for n, p in trainer.model.named_parameters() if p.grad is None]
        print(f"  {device}: {int(batch['pair_mask'].sum())} live pairs, loss "
              f"{losses[device]:.6f}, {len(grads[device])} gradients in "
              f"{time.time() - t0:.1f}s; launches {nonzero(A.launches)}", flush=True)
        if missing:
            raise AssertionError(f"parameters without a gradient: {missing[:5]}")
        del trainer
    torch.cuda.empty_cache()
    worst, worst_name = 0.0, ""
    for name, ref in grads["cpu"].items():
        rel = ((grads["cuda"][name] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"  loss gap {abs(losses['cuda'] - losses['cpu']):.3e}; worst gradient "
          f"max|card-CPU|/max|grad| = {worst:.3e} at {worst_name} (tol 1e-3)", flush=True)
    if not (worst <= 1e-3 and abs(losses["cuda"] - losses["cpu"]) <= 1e-4):
        raise AssertionError("card gradients differ from the CPU's")


def nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def phase_train_path(tmp):
    from vit_ed_tpu_torch import hisfrag
    from vit_ed_tpu_torch.models.build import build_model as build
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    print(f"== phase 9: training main path, python -m vit_ed_tpu_torch.hisfrag "
          f"--mode train (bf16, drop path 0.1, {TRAIN_BATCH} images -> "
          f"{TRAIN_PAIRS} pairs per step)", flush=True)
    data = os.path.join(tmp, "train_data")
    n = write_corpus(data, sub="train", seed=1)
    steps = []
    inner = hisfrag.HisfragTrainer.train_step

    def recorded(self, micro_batches):
        before = dict(A.launches)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "grad_norm": norm.item(),
                      "pairs": int(sum(b["pair_mask"].sum() for b in micro_batches)),
                      "launches": {k: A.launches[k] - before[k] for k in STEP_LAUNCHES}})
        return loss, norm

    argv = train_argv(data, os.path.join(tmp, "out"), "train",
                      "--batch-size", str(TRAIN_BATCH), "--opts",
                      "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0",
                      "PRINT_FREQ", "2")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    hisfrag.HisfragTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = hisfrag.main(argv)
    finally:
        hisfrag.HisfragTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = dict(A.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    ms = [s["ms"] for s in steps[1:]]      # the first step warms cuBLAS up
    pairs = sum(s["pairs"] for s in steps[1:])
    print(f"  {n} train-dir images, {len(steps)} optimizer steps; step "
          f"{np.median(ms):.1f} ms median ({min(ms):.1f}-{max(ms):.1f}, first "
          f"{steps[0]['ms']:.1f}); {pairs / (sum(ms) / 1e3):.1f} trained pairs/s "
          f"(live pairs over step time, host copy included; the loader's "
          f"threads decode and augment the next batches meanwhile); "
          f"{wall:.1f}s with model build, two validates and the checkpoint; "
          f"peak device memory {peak:.2f} GiB")
    print(f"  step ms in order {[round(s['ms'], 1) for s in steps]}")
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  grad_norm {[round(s['grad_norm'], 3) for s in steps]}")
    print(f"  launches per step {steps[-1]['launches']}; on the whole path "
          f"{nonzero(counts)}", flush=True)
    if len(steps) < 8 or trainer.step != len(steps):
        raise AssertionError(f"expected >= 8 optimizer steps, ran {len(steps)}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and s["loss"] > 0
                and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0):
            raise AssertionError(f"loss / grad_norm not finite and non-zero: {s}")
        if s["launches"] != STEP_LAUNCHES:
            raise AssertionError(f"unexpected launches in a step: {s['launches']}")
    for name in TRAIN_PATH_FWD + TRAIN_PATH_BWD:
        if counts[name] <= 0:
            raise AssertionError(f"the training path never launched {name}")
    if not 0.0 <= trainer.min_loss <= 1.0:
        raise AssertionError(f"validate gave {trainer.min_loss}")

    # parameters changed, and the checkpoint holds them
    torch.manual_seed(trainer.config.SEED)
    init = build(trainer.config, torch.device("cpu")).state_dict()
    now = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    moved = sum(not torch.equal(init[k], now[k]) for k in init)
    tree = load_checkpoint(os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt"))
    same = all(torch.equal(tree["model"][k], now[k]) for k in now)
    print(f"  {moved} of {len(init)} parameter tensors changed; checkpoint "
          f"reloaded: step {tree['step']}, epoch {tree['epoch']}, model equal "
          f"{same}", flush=True)
    if moved < len(init) - 2 or not same or tree["step"] != len(steps):
        raise AssertionError("parameters did not move or the checkpoint differs")
    reproducible_step(trainer)
    step_breakdown(trainer)
    host_input_cost(trainer, hisfrag_stages())
    del trainer
    torch.cuda.empty_cache()
    return counts


def reproducible_step(trainer):
    """Two train steps from one state (weights, AdamW moments, the DropPath
    generator, the step count) on one prepared batch: every parameter and
    moment must come out equal bit for bit. Beside it, for the record, the
    pair gather's old backward (index_select's, atomic adds) run twice on
    one gradient at the step's shapes."""
    import copy

    samples, targets = next(iter(trainer.get_dataloader("train")))
    np.random.seed(0)
    host = trainer.prepare_data(samples, targets)
    model, opt, gen = trainer.model, trainer.optimizer, trainer.drop_path_generator
    start = (copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict()),
             gen.get_state(), trainer.step)

    def step():
        model.load_state_dict(start[0])
        opt.load_state_dict(copy.deepcopy(start[1]))
        gen.set_state(start[2])
        trainer.step = start[3]
        trainer.train_step([host])
        torch.cuda.synchronize()
        out = {f"param {n}": p.detach().clone() for n, p in model.named_parameters()}
        for i, st in opt.state_dict()["state"].items():
            out.update({f"moment {i} {k}": v.clone() for k, v in st.items()
                        if torch.is_tensor(v)})
        return out

    a, b = step(), step()
    differ = [n for n in a if not torch.equal(a[n], b[n])]
    batch = trainer._to_device(host)
    gj = batch["gj"].long()
    feats = torch.randn((TRAIN_BATCH, 1025, C), device="cuda").to(model.dtype)
    grad = torch.randn((len(gj), 1025, C), device="cuda").to(model.dtype)
    atomic = []
    for _ in range(2):
        x = feats.clone().requires_grad_()
        x.index_select(0, gj).backward(grad)
        atomic.append(x.grad)
    torch.cuda.synchronize()
    print(f"  reproducible step: two steps from one state, {len(a)} parameter and "
          f"moment tensors, {len(a) - len(differ)} equal bit for bit; "
          f"index_select's backward run twice on one gradient ({len(gj)} pairs "
          f"into {TRAIN_BATCH} images): "
          f"{int((atomic[0] != atomic[1]).sum())} elements differ", flush=True)
    if differ:
        raise AssertionError(f"a train step is not reproducible: {differ[:8]}")


# the train items' host stages, as (label, owner module or class, attribute);
# the decode stage is the dataset module's own open_rgb
def hisfrag_stages():
    from vit_ed_tpu_torch.data import hisfrag as hisfrag_data
    from vit_ed_tpu_torch.data import transforms as T

    return [("decode", hisfrag_data, "open_rgb"), ("random_affine", T, "random_affine"),
            ("shift_scale_rotate", T, "shift_scale_rotate"),
            ("random_crop", T, "random_crop"), ("color_jitter", T, "color_jitter"),
            ("blur", T.GaussianBlur, "__call__"), ("normalize", T, "normalize_image")]


def div2k_stages():
    from vit_ed_tpu_torch.data import transforms as T

    return [("decode", T, "open_rgb"), ("shift_scale_rotate", T, "shift_scale_rotate"),
            ("rgb_shift", T, "rgb_shift"), ("random_crop", T, "random_crop"),
            ("grid + center crops", T, "crop"), ("center_crop", T, "center_crop"),
            ("resize + normalize", T.TwoImgSyncEval, "_one")]


@contextlib.contextmanager
def plain_route():
    """The port's transforms through their plain versions (PIL / numpy)
    instead of the native pipeline, for as long as the block runs."""
    from vit_ed_tpu_torch.data import hisfrag as hisfrag_data
    from vit_ed_tpu_torch.data import transforms as T

    saved = T._native_ok, T.open_rgb, hisfrag_data.open_rgb
    T._native_ok = lambda x: False
    T.open_rgb = hisfrag_data.open_rgb = T.open_rgb_plain
    try:
        yield
    finally:
        T._native_ok, T.open_rgb, hisfrag_data.open_rgb = saved


def run_items(ds, n, stages):
    """ds[i] for i < n, each after random.seed(i), with every stage timed
    (host seconds per stage)."""
    import random

    spent = {label: 0.0 for label, _, _ in stages}
    saved = []
    for label, owner, attr in stages:
        def timed_stage(*a, _fn=getattr(owner, attr), _label=label, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            spent[_label] += time.perf_counter() - t0
            return out
        saved.append((owner, attr, owner.__dict__[attr]))
        setattr(owner, attr, timed_stage)
    try:
        items = []
        t0 = time.perf_counter()
        for i in range(n):
            random.seed(i)
            items.append(ds[i])
        total = time.perf_counter() - t0
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
    return items, total, spent


def host_input_cost(trainer, stages, what="JPEG decode + train augmentation"):
    """Host milliseconds to make one training item, one thread, nothing else
    running, by stage: through the native pipeline (the path) and through
    the plain PIL / numpy chain, on the same items and seeds, which must
    come out equal bit for bit. This is what the loader's threads spend per
    batch while the step's Python thread competes with them for the
    interpreter."""
    ds = trainer.get_dataloader("train").dataset
    batch = trainer.config.DATA.BATCH_SIZE
    n = min(16, len(ds))
    runs = {"native": run_items(ds, n, stages)}
    with plain_route():
        runs["plain"] = run_items(ds, n, stages)
    for route, (_, total, spent) in runs.items():
        rest = total - sum(spent.values())
        print(f"  host input, {route}: {total / n * 1e3:.2f} ms per item ({what}, one "
              f"thread): " + ", ".join(f"{k} {v / n * 1e3:.2f}" for k, v in spent.items())
              + f", rest {rest / n * 1e3:.2f} ms", flush=True)
    per = runs["native"][1] / n
    print(f"  host input: {per * 1e3:.1f} ms per item = {per * batch:.2f} s of host "
          f"work per {batch}-item batch over {trainer.config.DATA.NUM_WORKERS} loader "
          f"threads; plain / native {runs['plain'][1] / runs['native'][1]:.2f}x",
          flush=True)
    for i, (a, b) in enumerate(zip(runs["native"][0], runs["plain"][0])):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"item {i}: the native pipeline differs from plain")


def march_native():
    """What g++ resolves -march=native to on this host."""
    res = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True)
    return next((line.split()[-1] for line in res.stdout.splitlines()
                 if line.strip().startswith("-march=")), "unknown")


def phase_native(tmp):
    """The native input pipeline on this host: its build, then native
    against plain bit for bit on the hisfrag train chain, the eval prep and
    the pool batch, on JPEGs of the scan's size."""
    import random

    from vit_ed_tpu_torch.data import transforms as T
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer
    from vit_ed_tpu_torch.native import pipeline as P

    print("== phase 14: the native input pipeline (vit_ed_tpu_torch/native/pipeline.cc)",
          flush=True)
    t0 = time.time()
    P.decode_route()
    info = P.build_info
    print(f"  built in {info['seconds']:.1f}s ({time.time() - t0:.1f}s with the JPEG "
          f"probe): libjpeg linked {info['jpeg']}, JPEG decode by {info['decode_route']}; "
          f"for {info['cpu'] or 'an unnamed CPU'} (-march=native = {march_native()}); "
          f"{os.path.relpath(info['path'], ROOT)}", flush=True)
    data = os.path.join(tmp, "native")
    n = write_corpus(data, writers=4, seed=3)
    paths = sorted(os.path.join(data, "test", f) for f in os.listdir(os.path.join(data, "test")))
    stub = types.SimpleNamespace(config=types.SimpleNamespace(
        DATA=types.SimpleNamespace(IMG_SIZE=512),
        TPU=types.SimpleNamespace(DEVICE_NORMALIZE=False)))
    train = HisfragTrainer.get_transforms(stub)["train"]
    evaluate = OneImgEval(512, crop=True)

    def chain(seed, path):
        random.seed(seed)
        img = T.open_rgb(path)
        return np.asarray(img), train(img), evaluate(img)

    native = [chain(i, p) for i, p in enumerate(paths)]
    with plain_route():
        plain = [chain(i, p) for i, p in enumerate(paths)]
    with P.PipelinePool(8) as pool:
        raws = [x[0] for x in native]
        rects = [evaluate.pool_crop(a.shape[:2]) for a in raws]
        batch = pool.prep_batch(raws, rects[0][1], [r[0] for r in rects])
    checks = {
        "decode": all(np.array_equal(a[0], b[0]) for a, b in zip(native, plain)),
        "train chain": all(np.array_equal(a[1], b[1]) for a, b in zip(native, plain)),
        "eval prep": all(np.array_equal(a[2], b[2]) for a, b in zip(native, plain)),
        "pool batch": np.array_equal(batch, np.stack([b[2] for b in plain])),
    }
    print(f"  {n} JPEGs of ~600 x 700 px, seeds 0-{n - 1}, 512 x 512 crops: native "
          f"against plain bit for bit: {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"the native pipeline differs from plain: {checks}")


def step_breakdown(trainer):
    """Where one train step goes: forward / backward / optimizer by CUDA
    events, and torch.profiler's device time by kernel over two steps."""
    from torch.profiler import ProfilerActivity, profile

    from vit_ed_tpu_torch.train.optim import clip_grad_norm, set_lr

    samples, targets = next(iter(trainer.get_dataloader("train")))
    host = trainer.prepare_data(samples, targets)
    batch = trainer._to_device(host)
    model, opt = trainer.model.train(), trainer.optimizer
    parts = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        loss = trainer.loss_fn(model, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        clip_grad_norm(model.parameters(), trainer.config.TRAIN.CLIP_GRAD)
        set_lr(opt, trainer.schedule(trainer.step))
        opt.step()
        ev[3].record()
        torch.cuda.synchronize()
        parts.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    fwd, bwd, upd = np.median(np.asarray(parts), axis=0)
    print(f"  one step by CUDA events: forward {fwd:.1f} ms, backward {bwd:.1f} ms, "
          f"clip + optimizer {upd:.1f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(2):
            trainer.train_step([host])
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / 2
    rows = device_rows(prof, 2)
    busy = sum(r[1] for r in rows)
    print(f"  profiler: device time {busy:.1f} ms/step of {wall:.1f} ms wall under "
          f"the profiler ({len(rows)} kernels, {sum(r[2] for r in rows)} launches/step)"
          + ("" if rows else " (not measured: the profiler saw no device time)"))
    for key, t, cnt in rows[:14]:
        print(f"    {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}%  x{cnt:<4d} {key[:90]}")
    return {"forward_ms": fwd, "backward_ms": bwd, "update_ms": upd, "device_ms": busy,
            "wall_ms": wall, "launches": sum(r[2] for r in rows)}


# ---------------------------------------------------------------------------
# the 4-D kernels (head_dim != 64) and the DIV2K puzzle-pair path
# ---------------------------------------------------------------------------

# layout -> the names of its inputs (heads_inputs)
HEADS_INPUTS = {
    "qkv": ("qkv",), "qkv_cls": ("qkv",), "kv": ("q", "kv"), "kv_shared": ("q", "kv1"),
    "packed": ("q", "k", "v"), "bhsd": ("q4", "k4", "v4"), "bhsd_eval": ("q4", "k4", "v4"),
    "flat": ("q3", "k3", "v3"),
}


def heads_inputs(gen, dtype, b, s, sk, h=HH, d=HD, probe=False):
    """Every 4-D wrapper's inputs; with ``probe`` the last key of every
    (batch, head) dominates."""
    c = h * d
    shapes = {"qkv": (b, s, 3 * c), "q": (b, s, c), "kv": (b, sk, 2 * c),
              "kv1": (1, sk, 2 * c), "k": (b, sk, c), "v": (b, sk, c),
              "q4": (b, h, s, d), "k4": (b, h, sk, d), "v4": (b, h, sk, d),
              "q3": (b * h, s, d), "k3": (b * h, sk, d), "v3": (b * h, sk, d)}
    t = {n: rand(gen, *sh, dtype=torch.float32) for n, sh in shapes.items()}
    if probe:
        probe_packed(t["qkv"][..., :c], t["qkv"][..., c:], h)
        probe_packed(t["q"], t["kv"], h)
        probe_packed(t["q"], t["kv1"], h)
        dominant_last_key(A._heads(t["q"], h), A._heads(t["k"], h), A._heads(t["v"], h))
        dominant_last_key(t["q4"], t["k4"], t["v4"])
        dominant_last_key(t["q3"], t["k3"], t["v3"])
    return {n: x.to(dtype) for n, x in t.items()}


def heads_call(layout, tensors, h=HH, out=None):
    return launch(layout, *tensors, h=h)(out)


def heads_plain(layout, tensors, h=HH):
    """The plain forward on the views the wrapper's kernel reads."""
    q, k, v = A._heads_views(layout, tensors, h)
    return A._from_heads(layout, A.heads_attention_plain(q, k, v, q.shape[-1] ** -0.5))


def heads_plain_grads(layout, tensors, do, h=HH):
    """``attention_backward_plain`` on the wrapper's q, k, v views, put into
    the wrapper's gradient layout."""
    q, k, v = A._heads_views(layout, tensors, h)
    out = [torch.zeros_like(t) for t in tensors]
    grads = A.attention_backward_plain(
        q, k, v, A._to_heads(layout, do.contiguous(), h), q.shape[-1] ** -0.5)
    for buf, g in zip(A._heads_views(layout, out, h), grads):
        buf.copy_(g)
    return out


def check_heads_layout(layout, t, dtype, tag, err, h=HH):
    """One wrapper of the 4-D route against plain on the card: forward, and
    where it has a VJP the gradients, two runs bit-equal. Returns the
    forward output."""
    tensors = [t[n] for n in HEADS_INPUTS[layout]]
    with torch.no_grad():
        ref = heads_plain(layout, tensors, h)
        out = heads_call(layout, tensors, h, poison(ref))
    torch.cuda.synchronize()
    e, rel = forward_reading(out, ref)
    ok = rel <= TOL[dtype]
    err[layout] = max(err.get(layout, 0.0), e)
    line = (f"  {layout:10s} {str(dtype)[6:]:8s} {tag} forward max|kernel-plain|={e:.3e}, "
            f"/max|plain|={rel:.3e}")
    if layout not in A.EVAL_ONLY_LAYOUTS:
        args = [x.detach().requires_grad_() for x in tensors]
        o = heads_call(layout, args, h)
        do = torch.randn(o.shape, device="cuda").to(dtype)
        got = torch.autograd.grad(o, args, do, retain_graph=True)
        again = torch.autograd.grad(o, args, do)
        want = heads_plain_grads(layout, tensors, do, h)
        torch.cuda.synchronize()
        worst = 0.0
        for g, g2, r in zip(got, again, want):
            if not torch.equal(g, g2):
                raise AssertionError(f"heads_{layout} backward: two launches differ")
            ge = (g.float() - r.float()).abs().max().item()
            worst = max(worst, ge / r.float().abs().max().item())
            err[layout + "_bwd"] = max(err.get(layout + "_bwd", 0.0), ge)
        ok = ok and worst <= TOL[dtype] and all(torch.isfinite(g).all() for g in got)
        if layout == "qkv_cls" and torch.count_nonzero(got[0][:, 1:, :ref.shape[-1]]):
            raise AssertionError("CLS backward: dq rows past 0 not zero")
        line += f" backward /max|grad|={worst:.3e} bit-equal twice"
    print(f"{line} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"heads_{layout} {dtype} {tag}: kernel != plain")
    return out


def phase_heads_vs_plain(gen):
    print(f"== phase 10: 4-D kernels against plain (H={HH}, d={HD}: forward, dq, "
          f"dk/dv through every route at the puzzle path's shapes, B={PUZZLE_BATCH}, "
          f"S=65 and the encoder's S=64, and at B=8, S=1025; then d=16, 64, 128)",
          flush=True)
    A.reset_launch_counts()
    err = {}
    # the decoder's self-attention (65, 65), its cross-attention (65, 64) and
    # the encoder's self-attention (64, 64: no CLS token) at the train batch
    shapes = [(PUZZLE_BATCH, s, sk) for s, sk in ((65, 65), (65, 64), (64, 64))]
    shapes += [(8, 1025, 1025), (8, 1025, 1024)]
    for dtype in (torch.float32, torch.bfloat16):
        for b, s, sk in shapes:
            t = heads_inputs(gen, dtype, b, s, sk, probe=True)
            outs = {}
            for layout in HEADS_INPUTS:
                if layout.startswith("qkv") and s != sk:
                    continue          # self-attention has Sk == S
                outs[layout] = check_heads_layout(layout, t, dtype,
                                                  f"B={b} S={s} Sk={sk}", err)
            if s != sk:   # the last decoder block's cross-attention: CLS row only
                check_heads_layout("kv", dict(t, q=t["q"][:, :1].contiguous()), dtype,
                                   f"B={b} S=1 Sk={sk}", err)
            bcast = A.fused_attention_packed_kv(
                t["q"], t["kv1"].expand(b, -1, -1).contiguous(), HH)
            torch.cuda.synchronize()
            if not torch.equal(outs["kv_shared"], bcast):
                raise AssertionError("heads kv_shared != kv on the broadcast")
            if s == sk and not torch.equal(outs["qkv_cls"], outs["qkv"][:, :1]):
                raise AssertionError("heads qkv_cls != row 0 of qkv")
            print(f"  {str(dtype)[6:]} B={b} S={s} Sk={sk}: kv_shared == broadcast kv"
                  + (" and cls == full row 0" if s == sk else "") + ", bit for bit",
                  flush=True)
            del t, outs, bcast
            torch.cuda.empty_cache()
        for d in (16, 64, 128):
            # 3 heads: C = 48 / 192 / 384; d = 64 at C = 192 is the 4-D route
            t = heads_inputs(gen, dtype, 4, 70, 70, h=3, d=d, probe=True)
            for layout in ("bhsd", "qkv", "qkv_cls", "kv"):
                check_heads_layout(layout, t, dtype, f"d={d} S=70", err, h=3)
    if any(v for k, v in A.launches.items() if not k.startswith("heads_")):
        raise AssertionError(f"phase 10 left the 4-D route: {nonzero(A.launches)}")
    # every shape a puzzle train step launches was held against plain above
    for name, n_q, n_k in PUZZLE_STEP_SHAPES:
        if not any(key[0] == name and key[1:] == (PUZZLE_BATCH, HH, n_q, n_k, HD)
                   for key in A.launches_by_shape):
            raise AssertionError(f"phase 10 never ran {name} at Sq={n_q} Sk={n_k}")
    return err


def heads_bound(kind, b, sq, sk, h=HH, d=HD, shared=False):
    """(bound_ms, bound_by) of one 4-D kernel on bf16 inputs: the products the
    function needs (forward 2, dq 3, dkv 4, each 2*B*H*Sq*Sk*D FLOPs) over
    the bf16 peak, against q, k, v (and do) read once and the result written
    once over HBM."""
    products = {"forward": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * products * b * h * sq * sk * d
    q_el, kv_el = b * h * sq * d, (1 if shared else b) * h * sk * d
    el = {"forward": 2 * q_el + 2 * kv_el,          # q, k, v in; out
          "dq": 3 * q_el + 2 * kv_el,               # q, k, v, do in; dq
          "dkv": 2 * q_el + 4 * kv_el}[kind]        # q, k, v, do in; dk, dv
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, 2 * el / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# phase 11's shapes: (batch, S, Sk of the cross layouts, tag, layouts timed)
HEADS_TIMED = (
    (PUZZLE_BATCH, 65, 64, "s65", ("qkv", "qkv_cls", "kv", "kv_shared", "bhsd", "flat")),
    (PUZZLE_BATCH, 64, 64, "s64", ("qkv",)),           # the encoder: no CLS token
    (PUZZLE_BATCH, 1, 64, "cls", ("kv",)),             # the last block's cross-attention
    (64, 1025, 1024, "s1025", ("qkv", "qkv_cls", "kv", "kv_shared", "bhsd", "flat")),
    (SCAN32_IMAGES, 1025, 1024, "scan", ("kv_shared",)),   # the d=32 scan's chunk
)


def heads_layout_times(gen, layout, b, s, sk, backward):
    """One 4-D layout's times at (B, S, Sk), bf16, H=12, d=32: the forward
    beside plain, SDPA and the bound, and with ``backward`` dq and dkv alone
    (the plain and SDPA backwards of dq, dk and dv together beside them).
    Returns ({"": forward row, "_dq": ..., "_dkv": ...}, the printed line)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    slow = dict(n=5, inner=1) if s > 256 else {}
    t = heads_inputs(gen, torch.bfloat16, b, s, sk)
    tensors = [t[n] for n in HEADS_INPUTS[layout]]
    q, k, v = A._heads_views(layout, tensors, HH)
    sq = q.shape[2]
    shape = f"B={b} H={HH} Sq={sq} Sk={sk} d={HD} bf16"
    qc, kc, vc = (x.contiguous() for x in (q, k, v))
    with torch.no_grad():
        r = {"ms": timed(lambda: heads_call(layout, tensors)),
             "plain_ms": timed(lambda: heads_plain(layout, tensors), **slow),
             "library_ms": timed(lambda: sdpa(qc, kc, vc)), "shape": shape}
    r["bound_ms"], r["bound_by"] = heads_bound(
        "forward", b, sq, sk, shared=layout == "kv_shared")
    rows = {"": r}
    line = (f"  B={b} S={s} {layout:10s} forward {r['ms']:.4f} ms (bound "
            f"{r['bound_ms']:.4f} {r['bound_by']}, plain {r['plain_ms']:.4f}, "
            f"sdpa {r['library_ms']:.4f})")
    if backward:
        scale = HD ** -0.5
        do = A._to_heads(layout, rand(gen, b, sq, HH * HD, dtype=torch.bfloat16), HH)
        grads = [torch.empty_like(x) for x in tensors]
        dq, dk, dv = A._heads_views(layout, grads, HH)
        stats = A._launch_heads_dq(layout, q, k, v, do, dq, scale)
        qg, kg, vg = (x.detach().requires_grad_() for x in (qc, kc, vc))
        lib_out, lib_do = sdpa(qg, kg, vg), do.contiguous()
        lib = timed(lambda: torch.autograd.grad(
            lib_out, (qg, kg, vg), lib_do, retain_graph=True))
        plain = timed(lambda: A.attention_backward_plain(q, k, v, do, scale), **slow)
        for kind, fn in (
                ("dq", lambda: A._launch_heads_dq(layout, q, k, v, do, dq, scale)),
                ("dkv", lambda: A._launch_heads_dkv(layout, q, k, v, do, dk, dv,
                                                    stats, scale))):
            rb = {"ms": timed(fn), "plain_ms": plain, "library_ms": lib,
                  "library": "sdpa backward: dq, dk and dv together",
                  "plain": "attention_backward_plain: dq, dk and dv together",
                  "shape": shape}
            rb["bound_ms"], rb["bound_by"] = heads_bound(kind, b, sq, sk)
            rows[f"_{kind}"] = rb
            line += (f"; {kind} {rb['ms']:.4f} ms (bound {rb['bound_ms']:.4f} "
                     f"{rb['bound_by']}; "
                     f"{rate(kind, b, HH, sq, sk, HD, rb['ms'], rb['bound_ms'])})")
        line += f"; plain backward {plain:.4f}, sdpa backward {lib:.4f}"
    torch.cuda.empty_cache()
    return rows, line


def phase_heads_times(gen):
    print(f"== phase 11: 4-D kernel times (bf16, H=12, d=32): the puzzle path's "
          f"shapes B={PUZZLE_BATCH} S=65 (decoder), S=64 (encoder) and Sq=1 (the last "
          f"block's cross-attention), B=64 S=1025, "
          f"and the head_dim 32 scan's chunk B={SCAN32_IMAGES} S=1025", flush=True)
    res = {}
    for b, s, sk_cross, tag, layouts in HEADS_TIMED:
        for layout in layouts:
            sk = s if layout in ("qkv", "qkv_cls") else sk_cross
            rows, line = heads_layout_times(gen, layout, b, s, sk, layout in PUZZLE_PATH)
            res.update({f"{layout}{kind}@{tag}": r for kind, r in rows.items()})
            print(line, flush=True)
    return res


def puzzle_argv(data, out, tag, mode, *extra):
    return ["--cfg", PUZZLE_CFG, "--data-path", data, "--mode", mode,
            "--output", out, "--tag", tag, *extra]


def phase_puzzle_model(tmp):
    from vit_ed_tpu_torch.main import DefaultTrainer, parse_option

    print("== phase 12: pjs patch8_64 (embed 384, 12 heads x 32, depth 8 + 8, 4 "
          "classes), full width and depth, seed 0: card against CPU", flush=True)
    rng = np.random.default_rng(2)
    samples = rng.normal(size=(16, 2, 64, 64, 3)).astype(np.float32)
    targets = np.eye(5, dtype=np.float32)[rng.integers(0, 5, 16)][:, :4]
    logits, grads, losses = {}, {}, {}
    for device in ("cpu", "cuda"):
        trainer = DefaultTrainer(parse_option(puzzle_argv(
            os.path.join(tmp, "none"), os.path.join(tmp, "out"), f"model_{device}",
            "train", "--device", device, "--disable_amp", "--opts",
            "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.AUTO_RESUME", "False")))
        model = trainer.model
        if device == "cpu":
            print(f"  {sum(p.numel() for p in model.parameters())} params, depth "
                  f"{len(model.blocks)}+{len(model.cross_blocks)}, {model.num_heads} "
                  f"heads of {model.embed_dim // model.num_heads}, "
                  f"{model.num_patches} patches", flush=True)
        trainer.setup_training(1)
        batch = trainer._to_device(trainer.prepare_data(samples, targets))
        A.reset_launch_counts()
        with torch.no_grad():
            logits[device] = model.eval()(batch["samples"]).float().cpu()
            if device == "cuda":
                model.dtype = torch.bfloat16
                logits["bf16"] = model(batch["samples"]).float().cpu()
                model.dtype = torch.float32
        model.train()
        loss = trainer.loss_fn(model, batch)
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        print(f"  {device}: loss {losses[device]:.6f}, {len(grads[device])} gradients; "
              f"launches {nonzero(A.launches)}", flush=True)
        del trainer, model
    torch.cuda.empty_cache()
    e32 = (logits["cuda"] - logits["cpu"]).abs().max().item()
    e16 = (logits["bf16"] - logits["cuda"]).abs().max().item()
    worst, worst_name = 0.0, ""
    for name, ref in grads["cpu"].items():
        rel = ((grads["cuda"][name] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"  logits f32 max|card-CPU| {e32:.3e} (tol 1e-3), max|bf16-f32| {e16:.3e} "
          f"(tol 5e-2); loss gap {abs(losses['cuda'] - losses['cpu']):.3e}; worst "
          f"gradient max|card-CPU|/max|grad| = {worst:.3e} at {worst_name} (tol 1e-3)",
          flush=True)
    if not (e32 <= 1e-3 and e16 <= 5e-2 and worst <= 1e-3
            and abs(losses["cuda"] - losses["cpu"]) <= 1e-4
            and torch.isfinite(logits["bf16"]).all()):
        raise AssertionError("full-width puzzle model disagrees with the CPU")


def write_div2k(root, n_train=256, n_valid=32, seed=0):
    """Synthetic DIV2K made from a seed: smooth colour fields of ~220 px as
    ``DIV2K_train_HR/*.png`` and ``DIV2K_valid_HR/*.png``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub, n in (("DIV2K_train_HR", n_train), ("DIV2K_valid_HR", n_valid)):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            small = rng.integers(0, 256, size=(28, 30, 3), dtype=np.uint8)
            Image.fromarray(small).resize((232 + i % 5, 220 + i % 7), Image.BICUBIC
                                          ).save(os.path.join(root, sub, f"{i:04d}.png"))
    return n_train, n_valid


def phase_puzzle_path(tmp):
    from vit_ed_tpu_torch import main as puzzle
    from vit_ed_tpu_torch.models.build import build_model as build
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    print(f"== phase 13: DIV2K main path, python -m vit_ed_tpu_torch.main --mode "
          f"train (bf16, drop path 0.1, {PUZZLE_BATCH} pairs per step, depth 8 + 8)",
          flush=True)
    data = os.path.join(tmp, "div2k")
    n_train, n_valid = write_div2k(data)
    steps = []
    inner = puzzle.DefaultTrainer.train_step

    def recorded(self, micro_batches):
        before, before_shapes = dict(A.launches), dict(A.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "grad_norm": norm.item(),
                      "launches": {k: A.launches[k] - before[k]
                                   for k in PUZZLE_STEP_LAUNCHES},
                      "shapes": {k: n - before_shapes.get(k, 0)
                                 for k, n in A.launches_by_shape.items()
                                 if n > before_shapes.get(k, 0)}})
        return loss, norm

    out = os.path.join(tmp, "out")
    opts = ("--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    puzzle.DefaultTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = puzzle.main(puzzle_argv(data, out, "train", "train", *opts))
    finally:
        puzzle.DefaultTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    # the main path's counts are read here, before the two other modes run
    counts, shapes = dict(A.launches), dict(A.launches_by_shape)
    ckpt_path = os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt")
    # another tag: a run directory's own checkpoint is resumed by train only
    # and would keep --pretrained from loading
    eval_argv = puzzle_argv(data, out, "eval", "eval", "--pretrained", ckpt_path, *opts)
    A.reset_launch_counts()
    eval_loss = puzzle.main(eval_argv)
    eval_counts = dict(A.launches)
    A.reset_launch_counts()
    rate = puzzle.main(puzzle_argv(data, out, "eval", "throughput", "--pretrained",
                                   ckpt_path, *opts))
    torch.cuda.synchronize()
    throughput_counts = dict(A.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30

    ms = [s["ms"] for s in steps[1:]]      # the first step warms cuBLAS up
    print(f"  {n_train} train + {n_valid} validation images, {len(steps)} optimizer "
          f"steps of {PUZZLE_BATCH} pairs; step {np.median(ms):.1f} ms median "
          f"({min(ms):.1f}-{max(ms):.1f}, first {steps[0]['ms']:.1f}); "
          f"{PUZZLE_BATCH * len(ms) / (sum(ms) / 1e3):.1f} trained pairs/s (pairs over "
          f"step time, host copy included; the loader's threads cut and resize the "
          f"next batches meanwhile); {wall:.1f}s with model build, two validates and "
          f"the checkpoint; peak device memory {peak:.2f} GiB")
    print(f"  step ms in order {[round(s['ms'], 1) for s in steps]}")
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  grad_norm {[round(s['grad_norm'], 3) for s in steps]}")
    print(f"  validation after the epoch: {trainer.val_metrics}; --mode eval from the "
          f"checkpoint: loss {eval_loss:.4f}; --mode throughput: {rate:.1f} img/s "
          f"(pairs of one validation batch, 30 forwards between CUDA events)")
    by_shape = sorted((k[0], k[1], k[3], k[4], n) for k, n in steps[-1]["shapes"].items())
    print(f"  launches per step {steps[-1]['launches']}; by shape (counter, B, Sq, Sk, "
          f"launches) {by_shape}")
    print(f"  launches of --mode train ({len(steps)} steps and two validates of "
          f"3 batches) {nonzero(counts)}; of --mode eval {nonzero(eval_counts)}; of "
          f"--mode throughput {nonzero(throughput_counts)}", flush=True)
    if len(steps) != 10 or trainer.step != len(steps):
        raise AssertionError(f"expected 10 optimizer steps, ran {len(steps)}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and s["loss"] > 0
                and np.isfinite(s["grad_norm"]) and s["grad_norm"] > 0):
            raise AssertionError(f"loss / grad_norm not finite and non-zero: {s}")
        if s["launches"] != PUZZLE_STEP_LAUNCHES:
            raise AssertionError(f"unexpected launches in a step: {s['launches']}")
        if s["shapes"] != {(name, PUZZLE_BATCH, HH, n_q, n_k, HD): n
                           for (name, n_q, n_k), n in PUZZLE_STEP_SHAPES.items()}:
            raise AssertionError(f"unexpected launch shapes in a step: {s['shapes']}")
    for name, run in (("train", counts), ("eval", eval_counts),
                      ("throughput", throughput_counts)):
        if any(v for k, v in run.items() if not k.startswith("heads_")):
            raise AssertionError(f"--mode {name} at head_dim 32 launched a pair "
                                 f"kernel: {nonzero(run)}")
        if not all(run[f"heads_{k}"] > 0 for k in PUZZLE_PATH):
            raise AssertionError(f"--mode {name} missed a 4-D forward: {nonzero(run)}")
    if not (0.0 < eval_loss < 2.0 and 0.0 < trainer.min_loss < 2.0 and rate > 0):
        raise AssertionError(f"validate gave {trainer.min_loss}, eval {eval_loss}, "
                             f"throughput {rate}")

    # parameters changed, and the checkpoint holds them
    torch.manual_seed(trainer.config.SEED)
    init = build(trainer.config, torch.device("cpu")).state_dict()
    now = {k: v.cpu() for k, v in trainer.model.state_dict().items()}
    moved = sum(not torch.equal(init[k], now[k]) for k in init)
    tree = load_checkpoint(ckpt_path)
    same = all(torch.equal(tree["model"][k], now[k]) for k in now)
    print(f"  {moved} of {len(init)} parameter tensors changed; checkpoint "
          f"reloaded: step {tree['step']}, epoch {tree['epoch']}, model equal "
          f"{same}", flush=True)
    loaded = puzzle.DefaultTrainer(puzzle.parse_option(eval_argv)).model.state_dict()
    if (moved < len(init) - 2 or not same or tree["step"] != len(steps)
            or not all(torch.equal(loaded[k].cpu(), now[k]) for k in now)):
        raise AssertionError("parameters did not move, the checkpoint differs or "
                             "--pretrained did not load it")
    step_breakdown(trainer)
    host_input_cost(trainer, div2k_stages(),
                    "PNG decode + flips, warp, crops and two resizes")
    del trainer
    torch.cuda.empty_cache()
    return shapes, ckpt_path


def phase_heads_scan(tmp):
    """The O(N^2) scan at head_dim 32: the hisfrag config with 12 heads (the
    S >= 256 traffic for which the JAX package keeps its 4-D kernels)."""
    from vit_ed_tpu_torch.hisfrag import main

    opts = ["--opts", "MODEL.PJS.NUM_HEADS", str(HH), "MODEL.PJS.DEPTH", "2",
            "MODEL.PJS.C_DEPTH", "2"]
    print(f"  the scan at head_dim 32: python -m vit_ed_tpu_torch.hisfrag --mode test "
          f"{' '.join(opts)}", flush=True)
    data = os.path.join(tmp, "scan32")
    n = write_corpus(data, writers=SCAN32_IMAGES // 4, seed=2)
    A.reset_launch_counts()
    metrics, dm, names, scorer = main([
        "--cfg", FLAGSHIP_CFG, "--data-path", data, "--mode", "test",
        "--output", os.path.join(tmp, "out"), "--tag", "scan32", *opts])
    torch.cuda.synchronize()
    counts, shapes = dict(A.launches), dict(A.launches_by_shape)
    by_shape = sorted((k[0], k[1], k[3], k[4], v) for k, v in shapes.items())
    print(f"  {n} images, {scorer.pairs_done} pairs in {scorer.scan_seconds:.3f}s: "
          f"{scorer.pairs_done / scorer.scan_seconds:.1f} pairs/s at depth 2 + 2; "
          f"launches {nonzero(counts)}; by shape (counter, B, Sq, Sk, launches) "
          f"{by_shape}", flush=True)
    if dm.shape != (n, n) or not np.array_equal(dm, dm.T) \
            or scorer.pairs_done != n * (n + 1) // 2:
        raise AssertionError("scan did not cover the symmetric pair space")
    for name in ("heads_qkv", "heads_kv_shared", "heads_qkv_cls"):
        if counts[name] <= 0:
            raise AssertionError(f"the head_dim 32 scan never launched {name}")
    if any(v for k, v in counts.items() if not k.startswith("heads_")):
        raise AssertionError(f"the head_dim 32 scan launched a pair kernel: {nonzero(counts)}")
    scan_vs_direct(data, dm, [(0, 0), (0, 5), (3, 9), (7, 15)], opts[1:])
    return shapes


# ---------------------------------------------------------------------------
# puzzle evaluation: python -m vit_ed_tpu_torch.evaluation
# ---------------------------------------------------------------------------

EVAL_CFG = os.path.join(ROOT, "configs", "puzzle", "puzzle_eval_4bin_patch8_64.yaml")
# BGU's 805-piece images at 28 px (35 x 23 pieces) are 980 x 644 px; cut at
# 64 px they give 15 x 10 = 150 pieces, 22,350 ordered pairs
EVAL_W, EVAL_H, EVAL_PIECES = 980, 644, 150
EVAL_SUBSETS = ("Cho", "McGill", "BGU")
EVAL_FILES = ("0.png", "1.png", "2.jpg")   # two PNG and one JPEG per subset
# the evaluation's forward shapes at B = PUZZLE_BATCH: (tag, layout, S, Sk)
EVAL_TIMED = (("encoder", "qkv", 64, 64), ("decoder", "qkv", 65, 65),
              ("cls", "qkv_cls", 65, 65), ("cross", "kv_shared", 65, 64),
              ("cross_cls", "kv_shared", 1, 64))


def write_puzzles(root, seed=0):
    """Synthetic Cho/, McGill/ and BGU/ puzzles made from a seed: smooth
    colour fields of EVAL_W x EVAL_H px, ``EVAL_FILES`` in each."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in EVAL_SUBSETS:
        os.makedirs(os.path.join(root, sub))
        for name in EVAL_FILES:
            small = rng.integers(0, 256, size=(EVAL_H // 28, EVAL_W // 28, 3), dtype=np.uint8)
            img = Image.fromarray(small).resize((EVAL_W, EVAL_H), Image.BICUBIC)
            img.save(os.path.join(root, sub, name), **({"quality": 95}
                                                       if name.endswith(".jpg") else {}))


def eval_shapes(n, batch=PUZZLE_BATCH, c_depth=8, depth=8):
    """The 4-D launches of one ``score_dense`` over n pieces, (counter, B,
    Sq, Sk) -> count: the encoder (S = 64) and stream 2's block-0
    self-attention (S = 65) once per batch of pieces; per 128-pair chunk of
    one x1 row, the self-attention of decoder blocks 1 .. 6, the last
    block's CLS row, and the shared-kv cross-attention of every block."""
    shapes = {}

    def add(key, count):
        shapes[key] = shapes.get(key, 0) + count

    for lo in range(0, n, batch):
        b = min(batch, n - lo)
        add(("heads_qkv", b, 64, 64), depth)
        add(("heads_qkv", b, 65, 65), 1)
    chunk = min(batch, n)
    chunks = n * -(-(n - 1) // chunk)
    add(("heads_qkv", chunk, 65, 65), chunks * (c_depth - 2))
    add(("heads_qkv_cls", chunk, 1, 65), chunks)
    add(("heads_kv_shared", chunk, 65, 64), chunks * (c_depth - 1))
    add(("heads_kv_shared", chunk, 1, 64), chunks)
    return shapes


def eval_kernel_times(gen):
    """The 4-D forward at the evaluation's shapes (B = PUZZLE_BATCH, bf16):
    kernel, plain and SDPA times, the bound, and the kernel's reading
    against plain (max |out - plain| / max |plain|)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for tag, layout, s, sk in EVAL_TIMED:
        t = heads_inputs(gen, torch.bfloat16, PUZZLE_BATCH, s, sk)
        tensors = [t[n] for n in HEADS_INPUTS[layout]]
        q, k, v = A._heads_views(layout, tensors, HH)
        sq = q.shape[2]
        qc, kc, vc = (x.contiguous() for x in (q, k, v))
        with torch.no_grad():
            err = forward_reading(heads_call(layout, tensors), heads_plain(layout, tensors))[1]
            r = {"ms": timed(lambda: heads_call(layout, tensors)),
                 "plain_ms": timed(lambda: heads_plain(layout, tensors)),
                 "library_ms": timed(lambda: sdpa(qc, kc, vc)),
                 "max_abs_err": err,
                 "shape": f"B={PUZZLE_BATCH} H={HH} Sq={sq} Sk={sk} d={HD} bf16"}
        r["bound_ms"], r["bound_by"] = heads_bound("forward", PUZZLE_BATCH, sq, sk,
                                                   shared=layout == "kv_shared")
        res[tag] = (layout, sq, sk, r)
        print(f"  {tag:9s} {layout:9s} {r['shape']}: {r['ms']:.4f} ms (bound "
              f"{r['bound_ms']:.4f} {r['bound_by']}, plain {r['plain_ms']:.4f}, sdpa "
              f"{r['library_ms']:.4f}); against plain {err:.3e} (tol 2e-2)", flush=True)
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"4-D {layout} forward disagrees with plain at {r['shape']}")
        del t, tensors, q, k, v, qc, kc, vc
    return res


def puzzle_eval_holds(argv, first, records, work):
    """The checks of phase 15 outside its counted run: score_dense against
    direct pair forwards, row-shared against mixed, the card against the
    CPU on a 3 x 3 puzzle, and the native solver against the Python one."""
    import copy

    from PIL import Image

    from vit_ed_tpu_torch import evaluation
    from vit_ed_tpu_torch.data.pieces import PiecesImages
    from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer
    from vit_ed_tpu_torch.solver.driver import paikin_tal_driver
    from vit_ed_tpu_torch.solver.importer import Puzzle
    from vit_ed_tpu_torch.train.checkpoint import load_pretrained

    def model_on(device, extra=()):
        config = evaluation.parse_option(argv + list(extra))[1]
        return load_pretrained(build_model(config, torch.device(device)),
                               config.MODEL.PRETRAINED).eval(), config

    model, config = model_on("cuda")
    puzzle = Puzzle(0, first, 64, starting_piece_id=0, erosion=config.DATA.EROSION_RATIO)
    transform = TwoImgSyncEval(64)
    imgs = PiecesImages(puzzle.pieces, transform=transform).all_images()
    n = len(imgs)
    row = PairwiseScorer(model, num_outputs=4, pair_chunk=PUZZLE_BATCH)
    logits = row.score_dense(imgs, batch_size=PUZZLE_BATCH)
    A.reset_launch_counts()
    mixed = PairwiseScorer(model, num_outputs=4, pair_chunk=PUZZLE_BATCH,
                           row_shared=False).score_dense(imgs, batch_size=PUZZLE_BATCH)
    torch.cuda.synchronize()
    mixed_counts = nonzero(A.launches)
    mixed_shapes = sorted((k[0], k[1], k[3], k[4], v) for k, v in A.launches_by_shape.items())
    gap_mixed = float(np.abs(mixed - logits).max())

    rng = np.random.default_rng(5)
    pi = rng.integers(0, n, 256)
    pj = (pi + rng.integers(1, n, 256)) % n
    x = torch.from_numpy(np.stack([np.stack([imgs[i], imgs[j]]) for i, j in zip(pi, pj)]))
    with torch.inference_mode():
        direct = torch.cat([model(x[lo:lo + PUZZLE_BATCH].cuda()).float().cpu()
                            for lo in range(0, len(x), PUZZLE_BATCH)]).numpy()
    gap_direct = float(np.abs(direct - logits[pi, pj]).max())

    # the CPU in float32 against the card in bf16 on a 3 x 3 puzzle
    small = os.path.join(work, "small.png")
    Image.open(first).crop((0, 0, 192, 192)).save(small)
    pieces3 = Puzzle(0, small, 64, erosion=config.DATA.EROSION_RATIO).pieces
    imgs3 = PiecesImages(pieces3, transform=transform).all_images()
    cpu_model, _ = model_on("cpu", ["--disable_amp"])
    on_cpu = PairwiseScorer(cpu_model, num_outputs=4, pair_chunk=PUZZLE_BATCH).score_dense(imgs3)
    on_card = row.score_dense(imgs3)
    gap_cpu = float(np.abs(on_card - on_cpu).max())
    print(f"  holds on {os.path.basename(first)} ({n} pieces, {n * (n - 1)} pairs): "
          f"score_dense against {len(pi)} direct pair forwards max gap "
          f"{gap_direct:.3e} (tol 1e-2); row_shared=False against row_shared=True "
          f"{gap_mixed:.3e} (tol 1e-2), launches of the mixed schedule {mixed_counts}, "
          f"by shape (counter, B, Sq, Sk, launches) {mixed_shapes}; 3 x 3 puzzle, "
          f"card bf16 against CPU f32 {gap_cpu:.3e} (tol 5e-2, |logits| up to "
          f"{np.abs(on_cpu).max():.3f})", flush=True)
    if not (gap_direct <= 1e-2 and gap_mixed <= 1e-2 and gap_cpu <= 5e-2
            and np.isfinite(logits).all() and logits.shape == (n, n, 4)):
        raise AssertionError("score_dense disagrees with its references")
    if not (mixed_counts.get("heads_kv", 0) > 0 and "heads_kv_shared" not in mixed_counts
            and all(k.startswith("heads_") for k in mixed_counts)):
        raise AssertionError(f"the mixed schedule missed the per-pair kv layout: {mixed_counts}")

    # the native solver against the Python one on the first puzzle's distances
    rec = records[0]
    solved, seconds = {}, {}
    for native in (True, False):
        t0 = time.time()
        solved[native] = paikin_tal_driver(
            copy.deepcopy(rec["puzzle"].pieces), 64, None, puzzle.grid_size,
            distances=rec["distances"], use_native=native)
        seconds[native] = time.time() - t0

    def placed(p):
        return sorted((q.original_piece_id, q.location, q.rotation.value) for q in p.pieces)

    def buddies(p):
        return sorted((i, s.value, j, t.value) for i, s, j, t in p.best_buddy_pairs)

    same = (placed(solved[True]) == placed(solved[False])
            and buddies(solved[True]) == buddies(solved[False]))
    print(f"  solver on {os.path.basename(rec['image'])}'s distances: native "
          f"{seconds[True] * 1e3:.1f} ms, Python {seconds[False] * 1e3:.1f} ms; "
          f"{len(buddies(solved[True]))} best-buddy pairs; placements and best "
          f"buddies equal: {same}", flush=True)
    if not same:
        raise AssertionError("the native solver disagrees with the Python solver")
    del model, cpu_model
    torch.cuda.empty_cache()
    return logits, imgs, seconds


def dense_breakdown(imgs):
    """Where one score_dense of 150 pieces goes: host wall against the
    profiler's device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from vit_ed_tpu_torch import evaluation
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    config = evaluation.parse_option(["--cfg", EVAL_CFG, "--pretrained", "none"])[1]
    torch.manual_seed(config.SEED)
    model = build_model(config, torch.device("cuda")).eval()
    scorer = PairwiseScorer(model, num_outputs=4, pair_chunk=PUZZLE_BATCH)
    scorer.score_dense(imgs)
    t0 = time.time()
    scorer.score_dense(imgs)
    torch.cuda.synchronize()
    plain_wall = (time.time() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        scorer.score_dense(imgs)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3
    rows = device_rows(prof, 1)
    busy = sum(r[1] for r in rows)
    print(f"  profiler, one score_dense of {len(imgs)} pieces: device time {busy:.1f} ms "
          f"of {wall:.1f} ms wall under the profiler, {plain_wall:.1f} ms without it "
          f"(the device {100 * (1 - busy / plain_wall):.1f}% idle; "
          f"{sum(r[2] for r in rows)} launches)"
          + ("" if rows else " (not measured: the profiler saw no device time)"))
    for key, t, cnt in rows[:12]:
        print(f"    {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}%  x{cnt:<5d} {key[:90]}")
    del model, scorer
    torch.cuda.empty_cache()


def flagship_fallback():
    """score_dataset at patch16_512 on N = 16 images: the row-sharded slab
    against the mixed-chunk fallback (K/V budget forced to 0)."""
    from vit_ed_tpu_torch.parallel import pairs as P

    config = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=None))
    torch.manual_seed(config.SEED)
    model = build_model(config, torch.device("cuda")).eval()
    rng = np.random.default_rng(6)

    class Images:
        imgs = rng.normal(size=(16, 512, 512, 3)).astype(np.float32)

        def __getitem__(self, i):
            return self.imgs[i], i

        def __len__(self):
            return len(self.imgs)

    s_row = P.PairwiseScorer(model, pair_chunk=8).score_dataset(Images(), 8, num_workers=0)
    warned = []
    logger = types.SimpleNamespace(info=lambda m: None, warning=warned.append)
    budget = P._KV_BLOCK_BUDGET
    P._KV_BLOCK_BUDGET = 0
    A.reset_launch_counts()
    try:
        s_mixed = P.PairwiseScorer(model, pair_chunk=8).score_dataset(
            Images(), 8, num_workers=0, logger=logger)
    finally:
        P._KV_BLOCK_BUDGET = budget
    torch.cuda.synchronize()
    counts = nonzero(A.launches)
    gap = float(np.abs(s_mixed.astype(np.float32) - s_row.astype(np.float32)).max())
    print(f"  patch16_512, N = 16, score_dataset: the mixed-chunk fallback against the "
          f"row-sharded slab max gap {gap:.3e} (tol 1e-2); fallback warned "
          f"{bool(warned)}; its launches {counts}", flush=True)
    if not (gap <= 1e-2 and warned and counts.get("kv", 0) > 0
            and "kv_shared" not in counts and np.isfinite(s_mixed).all()):
        raise AssertionError("the mixed-chunk fallback disagrees or missed the pair kv kernel")
    del model
    torch.cuda.empty_cache()


def phase_puzzle_eval(tmp, ckpt_path, gen):
    """Phase 15: ``python -m vit_ed_tpu_torch.evaluation`` at full width on
    150-piece puzzles, with the checkpoint of phase 13."""
    from vit_ed_tpu_torch import evaluation

    print(f"== phase 15: puzzle evaluation, python -m vit_ed_tpu_torch.evaluation "
          f"(pjs patch8_64, bf16, batch {PUZZLE_BATCH}) on {len(EVAL_FILES)} synthetic "
          f"{EVAL_W} x {EVAL_H} puzzles of {EVAL_PIECES} pieces in each of "
          f"{', '.join(EVAL_SUBSETS)}", flush=True)
    card = card_line()
    data, work = os.path.join(tmp, "puzzles"), os.path.join(tmp, "eval_cwd")
    write_puzzles(data)
    os.makedirs(work)
    argv = ["--cfg", EVAL_CFG, "--data-path", data, "--pretrained", ckpt_path,
            "--output", os.path.join(tmp, "out"), "--tag", "eval"]
    cwd = os.getcwd()
    os.chdir(work)        # the entry writes output/reconstructed/<subset>/ here
    A.reset_launch_counts()
    t0 = time.time()
    try:
        records = evaluation.main(argv)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts, shapes = dict(A.launches), dict(A.launches_by_shape)

    n_pairs = sum(r["pairs"] for r in records)
    stages = {k: np.asarray([r["seconds"][k] for r in records]) * 1e3
              for k in records[0]["seconds"]}
    rate = n_pairs / (stages["score"].sum() / 1e3)
    rate_all = n_pairs / ((stages["score"].sum() + stages["prepare"].sum()) / 1e3)
    print(f"  {card}: {len(records)} puzzles, {records[0]['pieces']} pieces, "
          f"{records[0]['pairs']} ordered pairs each; score_dense {rate:.1f} pairs/s "
          f"(score stage), {rate_all:.1f} pairs/s with encoder + K/V + prepare (host "
          f"clock, each stage ending in synchronize()); {wall:.1f}s for the entry "
          f"with model build and checkpoint load", flush=True)
    median_rate = records[0]["pairs"] / np.median(stages["score"]) * 1e3
    print(f"  {card}: ms per puzzle by stage, median (min-max; the first puzzle, which "
          f"also builds the native libraries it reads with): " + "; ".join(
              f"{k} {np.median(v):.1f} ({v.min():.1f}-{v.max():.1f}; {v[0]:.1f})"
              for k, v in stages.items())
          + f"; score_dense {median_rate:.1f} pairs/s at the median puzzle", flush=True)
    for sub in EVAL_SUBSETS:
        result, perfect = next(r["results"] for r in records if r["subset"] == sub)
        print(f"  {card}: {sub} accuracies " + ", ".join(
            f"{k} {np.mean(v):.4f}" for k, v in result.items()) + f", Perfect {perfect}",
            flush=True)
    by_shape = sorted((k[0], k[1], k[3], k[4], v) for k, v in shapes.items())
    print(f"  launches {nonzero(counts)}; by shape (counter, B, Sq, Sk, launches) "
          f"{by_shape}", flush=True)

    want = {}
    for r in records:
        for (name, b, n_q, n_k), v in eval_shapes(r["pieces"]).items():
            key = (name, b, HH, n_q, n_k, HD)
            want[key] = want.get(key, 0) + v
    out_dir = os.path.join(work, "output", "reconstructed")
    written = all(os.path.exists(os.path.join(out_dir, sub, f"{pre}{name}"))
                  for sub in EVAL_SUBSETS for name in EVAL_FILES for pre in ("", "accuracy_"))
    if not (len(records) == len(EVAL_SUBSETS) * len(EVAL_FILES) and written
            and all(r["pieces"] == EVAL_PIECES for r in records)):
        raise AssertionError("the evaluation did not cut, solve and save every puzzle")
    for r in records:
        result, perfect = r["results"]
        if not all(0.0 <= x <= 1.0 for v in result.values() for x in v):
            raise AssertionError(f"accuracies out of range: {result}")
        if not np.isfinite(r["distances"]).all():
            raise AssertionError("distances not finite")
    if shapes != want:
        raise AssertionError(f"unexpected launches of the evaluation: {by_shape}")
    if any(v for k, v in counts.items() if not k.startswith("heads_")):
        raise AssertionError(f"the evaluation launched a pair kernel: {nonzero(counts)}")

    first = os.path.join(data, EVAL_SUBSETS[0], EVAL_FILES[0])
    _logits, imgs, _ = puzzle_eval_holds(argv, first, records, work)
    flagship_fallback()
    dense_breakdown(imgs)
    times = eval_kernel_times(gen)
    # the accuracies of the first puzzle alone, for phase 19f
    in_subset = [r for r in records if r["subset"] == EVAL_SUBSETS[0]]
    i = next(k for k, r in enumerate(in_subset) if r["image"] == first)
    summary = {"rate": rate, "accuracies": {
        k: round(float(v[i]), 4) for k, v in in_subset[i]["results"][0].items()}}
    return shapes, times, len(records), summary


# ---------------------------------------------------------------------------
# the Michigan / Geshaem slice: pjs-S at patch16_384, so S = 577 on every
# pair kernel
# ---------------------------------------------------------------------------

MICHIGAN_CFG = os.path.join(ROOT, "configs", "michigan", "michigan_patch16_384.yaml")
M_S, M_SK = 577, 576            # decoder tokens (576 patches + CLS); encoder tokens
M_BATCH = 16
M_PAIRS = 2 * M_BATCH + 1       # Michigan's pair buffer: (1 + 1 negative ratio) * B + 1
M_FWD = ("qkv", "kv", "kv_shared", "qkv_cls")
M_BWD = ("qkv", "qkv_cls", "kv")
# the kernels of the Michigan paths by (counter, Sq, Sk): training launches
# the encoder's qkv at S = 576 and the decoder's qkv, qkv_cls and kv (each
# with dq and dkv); the val scan launches kv_shared; the Geshaem stacked-pair
# forwards launch qkv, qkv_cls and kv
M_TRAIN_SHAPES = {(f"{name}{kind}", n_q, n_k)
                  for name, n_q, n_k in (("qkv", M_SK, M_SK), ("qkv", M_S, M_S),
                                         ("qkv_cls", 1, M_S), ("kv", M_S, M_SK))
                  for kind in ("", "_dq", "_dkv")}
M_SCAN_SHAPES = {("kv_shared", M_S, M_SK), ("kv_shared", 1, M_SK), ("qkv", M_S, M_S),
                 ("qkv", M_SK, M_SK), ("qkv_cls", 1, M_S)}
M_PAIR_SHAPES = {("qkv", M_SK, M_SK), ("qkv", M_S, M_S), ("qkv_cls", 1, M_S),
                 ("kv", M_S, M_SK)}


def parts_reading(g, r, c):
    """(max |g - r|, the largest of max |g - r| / max |r| over the [..., C]
    parts of a gradient: dq, dk and dv of a fused [q | k | v] or [k | v]
    gradient each against its own max, so that a zeroed dk or dv cannot
    hide behind dq's)."""
    e = (g.float() - r.float()).abs()
    worst = max((e[..., i * c:(i + 1) * c].max()
                 / r[..., i * c:(i + 1) * c].float().abs().max().clamp(min=1e-30)).item()
                for i in range(g.shape[-1] // c))
    return e.max().item(), worst


def hold_pair_kernels(gen, sets, label):
    """Every pair kernel of ``sets`` ((tag, layouts forward, layouts
    backward, B, S, Sk) each) against plain, in f32 and bf16: the forward as
    phase 2 holds it (dominant last key, NaN-filled output), dq, dk and dv
    each against its own max (``parts_reading``) and bit-equal twice;
    returns the largest |kernel - plain| by (tag, layout) and (tag,
    layout_bwd)."""
    err = {}
    for dtype in (torch.float32, torch.bfloat16):
        for tag, fwd, bwd, b, s, sk in sets:
            cs = cases(gen, dtype, b, s, sk, probe=True)
            outs = {}
            for name in fwd:
                kern, plain, _lib, _inp = cs[name]
                ref = plain()
                out = kern(poison(ref))
                torch.cuda.synchronize()
                e, rel = forward_reading(out, ref)
                ok = rel <= TOL[dtype]
                print(f"  {label} {name:14s} {str(dtype)[6:]:8s} B={b} S={s} Sk={sk} "
                      f"/max|plain|={rel:.3e} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}",
                      flush=True)
                if not ok:
                    raise AssertionError(f"{name} {dtype} B={b} S={s}: kernel != plain")
                key = (tag, name.replace("kv_shared_cls", "kv_shared"))
                err[key] = max(err.get(key, 0.0), e)
                outs[name] = out
            if "kv_shared" in outs:
                inp = cs["kv_shared"][3]
                bcast = A.fused_attention_packed_kv(
                    inp["q"], inp["kv1"].expand(b, -1, -1).contiguous(), H)
                torch.cuda.synchronize()
                if not (torch.equal(outs["kv_shared"], bcast)
                        and torch.equal(outs["qkv_cls"], outs["qkv"][:, :1])):
                    raise AssertionError("kv_shared != broadcast kv or cls != row 0")
            del cs, outs
            if not bwd:
                continue
            t = vjp_inputs(gen, dtype, b, s, sk)
            for name in bwd:
                args, out, do = vjp_graph(name, t)
                got = torch.autograd.grad(out, args, do, retain_graph=True)
                again = torch.autograd.grad(out, args, do)
                ref = plain_grads(name, t, do)
                torch.cuda.synchronize()
                worst = 0.0
                for g, g2, r in zip(got, again, ref):
                    if not torch.equal(g, g2):
                        raise AssertionError(f"{name}_bwd: two launches differ")
                    e, rel = parts_reading(g, r, C)
                    worst = max(worst, rel)
                    key = (tag, name + "_bwd")
                    err[key] = max(err.get(key, 0.0), e)
                ok = worst <= TOL[dtype] and all(bool(torch.isfinite(g).all()) for g in got)
                print(f"  {label} {name + '_bwd':14s} {str(dtype)[6:]:8s} B={b} S={s} "
                      f"dq, dk, dv /max|grad| (each its own)={worst:.3e} tol={TOL[dtype]:g} "
                      f"bit-equal twice {'ok' if ok else 'FAIL'}", flush=True)
                if not ok:
                    raise AssertionError(f"{name}_bwd {dtype} B={b} S={s}: kernel != plain")
            del t
    torch.cuda.empty_cache()
    return err


def time_pair_kernels(gen, sets, label):
    """bf16 times of every kernel of ``sets`` beside plain, SDPA and the
    bound: {(tag, layout or layout_dq / _dkv): row}."""
    res = {}
    for tag, fwd, bwd, b, s, sk in sets:
        cs = cases(gen, torch.bfloat16, b, s, sk)
        for name in fwd:
            if name == "kv_shared_cls":
                continue
            kern, plain, lib, _ = cs[name]
            kv_len = s if name in ("qkv", "qkv_cls") else sk
            r = {"ms": timed(kern), "plain_ms": timed(plain, inner=1), "library_ms": timed(lib)}
            r["bound_ms"], r["bound_by"] = bound(name, b, s, kv_len)
            res[(tag, name)] = r
            print(f"  {label} {name:10s} B={b:<3d} S={s} kernel {r['ms']:.4f} ms  plain "
                  f"{r['plain_ms']:.4f} ms  sdpa {r['library_ms']:.4f} ms  bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']}, "
                  f"{100 * r['bound_ms'] / r['ms']:.1f}% of it)", flush=True)
        del cs
        if bwd:
            t = vjp_inputs(gen, torch.bfloat16, b, s, sk)
            for name in bwd:
                rows = backward_rows(name, t, b, s, sk, f"{label} B={b} S={s}")
                res.update({(tag, k): v for k, v in rows.items()})
            del t
    torch.cuda.empty_cache()
    return res


def by_shape(shapes, name, n_q, n_k, b=None):
    """Launches of counter ``name`` at (Sq, Sk), at batch ``b`` or every
    batch size."""
    return sum(v for k, v in shapes.items() if k[0] == name and k[3:5] == (n_q, n_k)
               and b in (None, k[1]))


def write_michigan(root, papyri, per=4, seed=0):
    """Synthetic Michigan tree: ``<root>/P<p>/front/detail/P<p>sub/papyrus/x/
    <f>.jpg``, papyrus-correlated noise textures of ~700 x 900 px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for p in range(papyri):
        d = os.path.join(root, f"P{p:03d}", "front", "detail", f"P{p:03d}sub",
                         "papyrus", "x")
        os.makedirs(d)
        base = rng.integers(0, 256, size=(700 + 4 * (p % 8), 900, 3))
        for f in range(per):
            arr = np.clip(base + rng.integers(-40, 40, base.shape), 0, 255)
            Image.fromarray(arr.astype(np.uint8)).save(os.path.join(d, f"{f}.jpg"),
                                                       quality=90)
    return papyri * per


def write_geshaem(root, groups=5, per=2, seed=0):
    """Synthetic Geshaem tree: ``<root>/<name>_r_c1/papyrus/x/<i>.jpg`` for
    ``groups`` groups, each of two fragments and their assembled name (A,
    B, A_B), ``per`` images each (so that every image has another of its
    fragment: wi19's Pr@k is NaN for a query without one, as upstream):
    3 * per * groups recto JPEGs of ~500 x 600 px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    n = 0
    for g in range(groups):
        a, b = f"G{2 * g:02d}", f"G{2 * g + 1:02d}"
        base = rng.integers(0, 256, size=(500 + 8 * g, 600, 3))
        for name in (a, b, f"{a}_{b}"):
            d = os.path.join(root, f"{name}_r_c1", "papyrus", "x")
            os.makedirs(d)
            for i in range(per):
                arr = np.clip(base + rng.integers(-60, 60, base.shape), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(os.path.join(d, f"{i}.jpg"),
                                                           quality=90)
                n += 1
    return n


# the pair kernels of the Michigan paths, held against plain and timed:
# (tag, layouts forward, layouts backward, B, S, Sk): the training pair
# buffer at S = 577, B = 64 (the scan's chunk), the encoder's S = 576
M_KERNEL_SETS = (("train", M_FWD + ("kv_shared_cls",), M_BWD, M_PAIRS, M_S, M_SK),
                 ("b64", M_FWD + ("kv_shared_cls",), (), 64, M_S, M_SK),
                 ("encoder", ("qkv",), ("qkv",), M_BATCH, M_SK, M_SK))


def michigan_argv(data, out, tag, mode, *extra):
    return ["--cfg", MICHIGAN_CFG, "--data-path", data, "--mode", mode,
            "--output", out, "--tag", tag, *extra]


def geshaem_argv(data, out, tag):
    return ["--cfg", MICHIGAN_CFG, "--data-path", data, "--output", out, "--tag", tag]


def michigan_stages():
    from vit_ed_tpu_torch import michigan
    from vit_ed_tpu_torch.data import transforms as T

    return [("decode", T, "open_rgb"), ("random_crop", T, "random_crop"),
            ("coarse_dropout", michigan, "_coarse_dropout"),
            ("color_jitter", T, "color_jitter"), ("blur", T.GaussianBlur, "__call__"),
            ("normalize", T, "normalize_image")]


def phase_michigan_train(tmp, data):
    """Phase 16c: ``python -m vit_ed_tpu_torch.michigan --mode train`` at full
    width, one epoch at batch 16, launch counts reset before and read
    after."""
    from vit_ed_tpu_torch import michigan

    card = card_line()
    print(f"== phase 16c: python -m vit_ed_tpu_torch.michigan --mode train (pjs-S "
          f"patch16_384, bf16, drop path 0.1, batch {M_BATCH} -> <= {M_PAIRS} pairs)",
          flush=True)
    steps = []
    inner = michigan.MichiganTrainer.train_step

    def recorded(self, micro_batches):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "pairs": int(sum(b["pair_mask"].sum() for b in micro_batches))})
        return loss, norm

    argv = michigan_argv(data, os.path.join(tmp, "out"), "train", "train",
                         "--batch-size", str(M_BATCH), "--opts", "TRAIN.EPOCHS", "1",
                         "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "4")
    A.reset_launch_counts()
    michigan.MichiganTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = michigan.main(argv)
    finally:
        michigan.MichiganTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    shapes = dict(A.launches_by_shape)
    ms = [s["ms"] for s in steps[1:]]
    pairs = sum(s["pairs"] for s in steps[1:])
    mfu = [line.split("INFO ", 1)[-1].strip() for line in open(os.path.join(
        trainer.config.OUTPUT, "log_rank0train.txt")) if "Model FLOPs" in line]
    print(f"  {card}: {len(steps)} optimizer steps; step {np.median(ms):.1f} ms median "
          f"({min(ms):.1f}-{max(ms):.1f}, first {steps[0]['ms']:.1f}) with the loader; "
          f"{pairs / (sum(ms) / 1e3):.1f} trained pairs/s ({pairs / len(ms):.1f} live "
          f"pairs per step); {wall:.1f}s with model build and two validates")
    print(f"  loss {[round(s['loss'], 3) for s in steps[:12]]} ...")
    print(f"  {card}: MFU line as logged: {mfu}", flush=True)
    print(f"  launches by shape (counter, B, Sq, Sk, launches) "
          f"{sorted((k[0], k[1], k[3], k[4], v) for k, v in shapes.items())}", flush=True)
    n_steps = len(trainer.get_dataloader("train"))
    if len(steps) != n_steps or trainer.step != n_steps or len(steps) < 8:
        raise AssertionError(f"ran {len(steps)} of {n_steps} optimizer steps")
    if not all(np.isfinite(s["loss"]) and s["loss"] > 0 for s in steps):
        raise AssertionError("loss not finite and positive")
    if not mfu or "989.4 TF/s" not in mfu[0]:
        raise AssertionError(f"no MFU line against the card's peak: {mfu}")
    for key in M_TRAIN_SHAPES:
        if by_shape(shapes, *key) <= 0:
            raise AssertionError(f"--mode train never launched {key}")
    step_breakdown(trainer)
    host_input_cost(trainer, michigan_stages(), "JPEG decode + Michigan train augmentation")
    del trainer
    torch.cuda.empty_cache()
    return shapes, n_steps


def phase_michigan_preempt(tmp, data, n_steps):
    """Phase 16d: the SIGTERM guard on the card. ``--mode train`` in a
    subprocess gets SIGTERM after its first ``Train:`` line; it must exit 0
    with a mid-epoch checkpoint, and a rerun must continue that epoch and
    end with the uninterrupted run's update count."""
    import signal
    import threading

    from vit_ed_tpu_torch import michigan
    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    print("== phase 16d: preemption: SIGTERM to python -m vit_ed_tpu_torch.michigan "
          "--mode train after its first Train: line, then a rerun (full width)",
          flush=True)
    argv = michigan_argv(data, os.path.join(tmp, "out"), "preempt", "train",
                         "--batch-size", str(M_BATCH), "--opts", "TRAIN.EPOCHS", "1",
                         "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "4")
    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-m", "vit_ed_tpu_torch.michigan", *argv],
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"})
    watchdog = threading.Timer(600, proc.kill)
    watchdog.start()
    lines, sent = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if sent is None and "Train:" in line:
                proc.send_signal(signal.SIGTERM)
                sent = time.time()
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    said = [x.split("INFO ", 1)[-1].strip() for x in lines if "Preempted" in x]
    print(f"  subprocess exit {rc} {time.time() - t0:.1f}s after its start, "
          f"{time.time() - sent if sent else float('nan'):.1f}s after SIGTERM; {said}",
          flush=True)
    out_dir = os.path.join(tmp, "out", "michigan_patch16_384", "preempt")
    if rc != 0 or sent is None or not said:
        print("".join(lines[-30:]))
        raise AssertionError("the preempted run did not exit 0 after saving")
    tree = load_checkpoint(os.path.join(out_dir, "checkpoint.ckpt"))
    k = int(tree.get("in_epoch_opt_steps", 0))
    print(f"  checkpoint.ckpt: epoch {tree['epoch']}, step {tree['step']}, "
          f"in_epoch_opt_steps {k}", flush=True)
    if not (0 < k < n_steps and tree["step"] == k and tree["epoch"] == 0):
        raise AssertionError("the preemption checkpoint is not mid-epoch")
    A.reset_launch_counts()
    resumed = michigan.main(argv)
    log = open(os.path.join(out_dir, "log_rank0train.txt")).read()
    print(f"  rerun: start epoch {resumed.start_epoch}, skipped {resumed._resume_skip_opt_steps} "
          f"updates, ended at {resumed.step} updates (an uninterrupted run: {n_steps}); "
          f"'continuing from optimizer step {k}' logged: "
          f"{f'continuing from optimizer step {k}' in log}", flush=True)
    if not (resumed.start_epoch == 0 and resumed._resume_skip_opt_steps == k
            and resumed.step == n_steps and not resumed.preempted
            and f"continuing from optimizer step {k}" in log):
        raise AssertionError("the rerun did not continue the interrupted epoch")
    del resumed
    torch.cuda.empty_cache()


def phase_michigan_eval(tmp, data):
    """Phase 16e: ``--mode eval`` (the val scan) and ``--mode throughput`` on
    the 80-papyrus tree, each with launch counts of its own; the scan's
    slab against direct pair forwards."""
    from vit_ed_tpu_torch import michigan
    from vit_ed_tpu_torch.data.michigan import MichiganTest
    from vit_ed_tpu_torch.data.transforms import OneImgEvalZoom
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    card = card_line()
    print("== phase 16e: python -m vit_ed_tpu_torch.michigan --mode eval (the val "
          "scan) and --mode throughput", flush=True)
    seen = []
    inner = PairwiseScorer.score_dataset

    def recorded(self, *a, **k):
        sim = inner(self, *a, **k)
        seen.append((self, sim))
        return sim

    out = os.path.join(tmp, "out")
    A.reset_launch_counts()
    PairwiseScorer.score_dataset = recorded
    try:
        loss = michigan.main(michigan_argv(data, out, "eval", "eval"))
    finally:
        PairwiseScorer.score_dataset = inner
    torch.cuda.synchronize()
    shapes = dict(A.launches_by_shape)
    scorer, sim = seen[-1]
    n = sim.shape[0]
    print(f"  {card}: {n} val images, {scorer.pairs_done} pairs in "
          f"{scorer.scan_seconds:.3f}s: {scorer.pairs_done / scorer.scan_seconds:.1f} "
          f"pairs/s (encode, K/V, token cache and chunks); 1 - mAP {loss:.4f}; "
          f"launches {sorted((k[0], k[1], k[3], k[4], v) for k, v in shapes.items())}",
          flush=True)
    if scorer.pairs_done != n * (n + 1) // 2 or not np.isfinite(sim.astype(np.float32)).all():
        raise AssertionError("the scan did not score every pair")
    for key in M_SCAN_SHAPES:
        if by_shape(shapes, *key) <= 0:
            raise AssertionError(f"--mode eval never launched {key}")
    ds = MichiganTest(data, MichiganTest.Split.VAL, transforms=OneImgEvalZoom(384),
                      val_n_items_per_writer=5)
    pairs = [(0, 0), (0, 7), (5, 30), (12, n - 1), (n - 2, n - 1)]
    x = torch.from_numpy(np.stack([np.stack([ds[i][0], ds[j][0]]) for i, j in pairs]))
    with torch.inference_mode():
        direct = scorer.model(x.to(scorer.device)).float().cpu().numpy()[:, 0]
    gap = float(np.abs(direct - np.asarray([float(sim[i, j]) for i, j in pairs])).max())
    print(f"  scan vs direct pair forward at {pairs}: max gap {gap:.3e} (tol 1e-2)",
          flush=True)
    if gap > 1e-2:
        raise AssertionError("scan scores differ from direct forwards")
    # one chunk of the scan's inner op: the scorer's chunk is all N columns
    model = scorer.model
    with torch.inference_mode():
        kv_row = model.context_kv_cache(model.encode(x[:1, 0].to(scorer.device)))
        adv = model.prepare_x2_scan(x[:, 1].to(scorer.device)).index_select(
            0, torch.arange(n, device=scorer.device) % len(pairs))
    print(f"  the scan's {n}-pair score_tokens_row chunk at S={M_S}:", flush=True)
    chunk_breakdown(model, kv_row, adv)
    del seen, scorer, model, kv_row, adv
    A.reset_launch_counts()
    img_s = michigan.main(michigan_argv(data, out, "throughput", "throughput"))
    torch.cuda.synchronize()
    tput = dict(A.launches_by_shape)
    print(f"  {card}: --mode throughput {img_s:.1f} pairs/s (a batch of 128 stacked val "
          f"pairs, 30 forwards between CUDA events); launches "
          f"{sorted((k[0], k[1], k[3], k[4], v) for k, v in tput.items())}", flush=True)
    for key in M_PAIR_SHAPES:
        if by_shape(tput, *key) <= 0:
            raise AssertionError(f"--mode throughput never launched {key}")
    torch.cuda.empty_cache()
    return shapes


def phase_geshaem(tmp, data, gesh):
    """Phase 16f: ``--mode test`` (geshaem_test) and ``python -m
    vit_ed_tpu_torch.geshame_evaluation`` on the Geshaem tree, each with
    launch counts of its own; the stacked-pair loader's whole-batch route."""
    from vit_ed_tpu_torch import geshame_evaluation, michigan
    from vit_ed_tpu_torch.native.pipeline import PipelinePool

    card = card_line()
    print("== phase 16f: python -m vit_ed_tpu_torch.michigan --mode test "
          "(geshaem_test) and python -m vit_ed_tpu_torch.geshame_evaluation", flush=True)
    out = os.path.join(tmp, "out")
    pooled, timing = [], {}
    prep, scores, standard = (PipelinePool.prep_batch, michigan.MichiganTrainer.geshaem_scores,
                              geshame_evaluation.eval_standard)

    def counted_prep(self, images, *a, **k):
        pooled.append(len(images))
        return prep(self, images, *a, **k)

    def timed_scores(self, dataset):
        t0 = time.time()
        res = scores(self, dataset)
        timing["test"] = (time.time() - t0, len(dataset))
        return res

    def timed_standard(config, *a, **k):
        t0 = time.time()
        res = standard(config, *a, **k)
        n = res[0].shape[0]
        timing["standard"] = (time.time() - t0, n * (n + 1) // 2)
        return res

    PipelinePool.prep_batch = counted_prep
    michigan.MichiganTrainer.geshaem_scores = timed_scores
    geshame_evaluation.eval_standard = timed_standard
    try:
        A.reset_launch_counts()
        loss = michigan.main(michigan_argv(data, out, "gtest", "test",
                                           "--geshaem-data-path", gesh))
        torch.cuda.synchronize()
        test_shapes, test_pooled = dict(A.launches_by_shape), list(pooled)
        A.reset_launch_counts()
        pooled.clear()
        metrics, dm, names, frags = geshame_evaluation.main(
            geshaem_argv(gesh, out, "gstd"))
        torch.cuda.synchronize()
        std_shapes, std_pooled = dict(A.launches_by_shape), list(pooled)
    finally:
        PipelinePool.prep_batch = prep
        michigan.MichiganTrainer.geshaem_scores = scores
        geshame_evaluation.eval_standard = standard
    log = [line.split("INFO ", 1)[-1].strip() for line in open(os.path.join(
        out, "michigan_patch16_384", "gtest", "log_rank0test.txt")) if "Geshaem test" in line]
    # the stacked-pair loader alone (decode + the pooled eval transform), as
    # geshaem_test builds it: what the forwards wait on
    from vit_ed_tpu_torch.data.geshaem import GeshaemPatch
    from vit_ed_tpu_torch.data.loader import DataLoader
    from vit_ed_tpu_torch.data.transforms import OneImgEvalZoom

    ds = GeshaemPatch(gesh, GeshaemPatch.Split.VAL, transform=OneImgEvalZoom(384))
    t0 = time.time()
    n_loaded = sum(len(b[0]) for b in DataLoader(ds, batch_size=128, num_workers=8))
    t_loader = time.time() - t0
    (t_test, n_test), (t_std, n_std) = timing["test"], timing["standard"]
    print(f"  {card}: --mode test: {n_test} stacked pairs in {t_test:.2f}s = "
          f"{n_test / t_test:.1f} pairs/s (loader + forwards); {log}; 1 - mAP {loss:.4f}; "
          f"whole-batch pool calls {len(test_pooled)} of {sum(test_pooled)} images; the "
          f"loader alone (8 threads, host clock) {n_loaded} pairs in {t_loader:.2f}s = "
          f"{n_loaded / t_loader:.1f} pairs/s", flush=True)
    print(f"  {card}: geshame_evaluation: {n_std} stacked pairs in {t_std:.2f}s = "
          f"{n_std / t_std:.1f} pairs/s; mAP {metrics[0]:.3f} Top 1 {metrics[1]:.3f} "
          f"Pr@k10 {metrics[2]:.3f} Pr@k100 {metrics[3]:.3f}; {dm.shape[0]} images; "
          f"whole-batch pool calls {len(std_pooled)} of {sum(std_pooled)} images", flush=True)
    for what, shapes in (("--mode test", test_shapes), ("geshame_evaluation", std_shapes)):
        print(f"  launches of {what}: "
              f"{sorted((k[0], k[1], k[3], k[4], v) for k, v in shapes.items())}", flush=True)
        for key in M_PAIR_SHAPES:
            if by_shape(shapes, *key) <= 0:
                raise AssertionError(f"{what} never launched {key}")
    if not (len(log) == 2 and 0.0 <= loss <= 1.0 and np.isfinite(dm).all()
            and all(0.0 <= float(m) <= 1.0 for m in metrics)):
        raise AssertionError("the Geshaem evaluations gave no finite metrics")
    # every batch of stacked pairs went through the pool whole: two images per pair
    if sum(test_pooled) != 2 * n_test or sum(std_pooled) != 2 * n_std:
        raise AssertionError("a Geshaem batch missed the whole-batch route")
    return test_shapes, std_shapes


def phase_michigan(tmp, gen):
    """Phase 16: the Michigan / Geshaem slice at pjs-S patch16_384."""
    t0 = time.time()
    train_data = os.path.join(tmp, "michigan_train")
    eval_data = os.path.join(tmp, "michigan")
    gesh = os.path.join(tmp, "geshaem")
    n_train = write_michigan(train_data, 8, seed=1)
    n_eval = write_michigan(eval_data, 80, seed=2)
    n_gesh = write_geshaem(gesh)
    print(f"== phase 16: Michigan / Geshaem (configs/michigan/michigan_patch16_384.yaml): "
          f"synthetic trees of {n_train} and {n_eval} Michigan JPEGs (~700 x 900 px) and "
          f"{n_gesh} Geshaem JPEGs (~500 x 600 px) in {time.time() - t0:.1f}s", flush=True)
    print(f"== phase 16a: pair kernels against plain at pjs-S patch16_384's length "
          f"(C=384, H=6, S={M_S}, Sk={M_SK}; B={M_PAIRS} and 64; the encoder's S={M_SK} "
          f"at B={M_BATCH}) on {card_line()}", flush=True)
    err = {}
    for (_tag, name), e in hold_pair_kernels(gen, M_KERNEL_SETS, "16a").items():
        err[name] = max(err.get(name, 0.0), e)
    print(f"== phase 16b: pair kernel times at S={M_S} (bf16) on {card_line()}", flush=True)
    times = {f"{name}@{tag}": r for (tag, name), r in
             time_pair_kernels(gen, M_KERNEL_SETS, "16b").items()}
    train_shapes, n_steps = phase_michigan_train(tmp, train_data)
    phase_michigan_preempt(tmp, train_data, n_steps)
    scan_shapes = phase_michigan_eval(tmp, eval_data)
    phase_geshaem(tmp, eval_data, gesh)
    print(f"  phase 16 took {time.time() - t0:.1f}s", flush=True)

    # one row per kernel and shape: ``launches`` from --mode train (the
    # scan's kv_shared from --mode eval), times at the training pair buffer
    # (kv_shared at B = 64, the encoder's qkv at its image batch)
    rows = []
    for name, n_q, n_k, tag, suffix in (
            ("qkv", M_S, M_S, "train", "s577"), ("qkv", M_SK, M_SK, "encoder", "encoder_s576"),
            ("qkv_cls", 1, M_S, "train", "s577"), ("kv", M_S, M_SK, "train", "s577")):
        rows.append({
            "name": f"pair_attention_{name}_{suffix}", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": by_shape(train_shapes, name, n_q, n_k),
            "max_abs_err": err[name], **times[f"{name}@{tag}"]})
        for kind in ("dq", "dkv"):
            rows.append({
                "name": f"pair_attention_{name}_{kind}_{suffix}", "route": "cuda",
                "source": HEADS_BWD_SOURCE, "replaces": BWD_REPLACES,
                "launches": by_shape(train_shapes, f"{name}_{kind}", n_q, n_k),
                "max_abs_err": err[f"{name}_bwd"], **times[f"{name}_{kind}@{tag}"]})
    rows.append({
        "name": "pair_attention_kv_shared_s577", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["kv_shared"],
        "launches": (by_shape(scan_shapes, "kv_shared", M_S, M_SK)
                     + by_shape(scan_shapes, "kv_shared", 1, M_SK)),
        "max_abs_err": err["kv_shared"], **times["kv_shared@b64"]})
    return rows


# ---------------------------------------------------------------------------
# the ViT embedding baselines: python -m vit_ed_tpu_torch.main_vit, .hisfrag_vit
# ---------------------------------------------------------------------------

VIT_CFG = os.path.join(ROOT, "configs", "puzzle", "vit_div2k_erosion7_4bin_patch8_64.yaml")
VIT_BATCH = PUZZLE_BATCH              # items per step, each 4 directions x 3 images
VIT_IMAGES = VIT_BATCH * 12           # 1,536 sequences of 65 tokens per forward
VIT_TEST_IMAGES = VIT_BATCH * 8       # 1,024: 128 ordered pairs x 4 pairings x 2
VIT_DEPTH = 12
# launches of one main_vit step, (counter, B, H, Sq, Sk, D) -> count: 12
# self-attentions at S = 65, each one forward, one dq and one dkv launch
VIT_STEP_SHAPES = {(f"heads_qkv{kind}", VIT_IMAGES, HH, 65, 65, HD): VIT_DEPTH
                   for kind in ("", "_dq", "_dkv")}
# 17d: puzzles of 384 x 384 px cut at 64 px: 36 pieces, 1,260 ordered pairs
VIT_PUZZLE_PX, VIT_PIECES = 384, 36
# hisfrag_vit: ViT-S/16 at 512 px (S = 1025, 6 heads of 64: the pair route)
HFV_OPTS = ("MODEL.TYPE", "vit", "MODEL.NUM_CLASSES", "384", "MODEL.VIT.EMBED_DIM", "384",
            "MODEL.VIT.NUM_HEADS", "6", "MODEL.VIT.PATCH_SIZE", "16")
HFV_BATCH = 16
HFV_STEP_SHAPES = {(f"qkv{kind}", HFV_BATCH, H, 1025, 1025, D): VIT_DEPTH
                   for kind in ("", "_dq", "_dkv")}


def vit_argv(data, out, tag, mode, *extra):
    return ["--cfg", VIT_CFG, "--data-path", data, "--mode", mode,
            "--output", out, "--tag", tag, *extra]


def hfv_argv(data, out, tag, mode, *extra, opts=()):
    return ["--cfg", FLAGSHIP_CFG, "--data-path", data, "--mode", mode, "--output", out,
            "--tag", tag, "--batch-size", str(HFV_BATCH), *extra,
            "--opts", *HFV_OPTS, *opts]


def phase_vit_model(tmp):
    """Phase 17a: the ViT of the committed vit config at full width and depth,
    f32 card against f32 CPU (embeddings and the triplet loss's gradients),
    bf16 card against f32 card."""
    from vit_ed_tpu_torch.main_vit import VitTripletTrainer, parse_option

    print(f"== phase 17a: the ViT of {os.path.relpath(VIT_CFG, ROOT)} (embed 384, 12 "
          f"blocks, 12 heads x 32, patch 8 at 64 px: S = 65), seed 0: card against "
          f"CPU on {card_line()}", flush=True)
    rng = np.random.default_rng(3)
    samples = rng.normal(size=(4, 4, 3, 64, 64, 3)).astype(np.float32)
    emb, grads, losses = {}, {}, {}
    for device in ("cpu", "cuda"):
        trainer = VitTripletTrainer(parse_option(vit_argv(
            os.path.join(tmp, "none"), os.path.join(tmp, "out"), f"vit_model_{device}",
            "train", "--device", device, "--disable_amp", "--opts",
            "MODEL.DROP_PATH_RATE", "0.0", "TRAIN.AUTO_RESUME", "False")))
        model = trainer.model
        if device == "cpu":
            print(f"  {sum(p.numel() for p in model.parameters())} params, depth "
                  f"{len(model.blocks)}, {model.num_heads} heads of "
                  f"{model.embed_dim // model.num_heads}, {model.num_patches} patches, "
                  f"embedding width {model.head.weight.shape[0]}", flush=True)
        trainer.setup_training(1)
        batch = trainer._to_device(trainer.prepare_data(samples, np.arange(4)))
        flat = batch["samples"].reshape(48, 64, 64, 3)
        A.reset_launch_counts()
        with torch.no_grad():
            emb[device] = model.eval()(flat).float().cpu()
            if device == "cuda":
                model.dtype = torch.bfloat16
                emb["bf16"] = model(flat).float().cpu()
                model.dtype = torch.float32
        model.train()
        loss = trainer.loss_fn(model, batch)
        loss.backward()
        losses[device] = loss.item()
        grads[device] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        print(f"  {device}: triplet loss {losses[device]:.6f}, {len(grads[device])} "
              f"gradients; launches {nonzero(A.launches)}", flush=True)
        if device == "cuda" and not (A.launches["heads_qkv"] > 0
                                     and A.launches["heads_qkv_dkv"] == VIT_DEPTH):
            raise AssertionError("the ViT did not run the 4-D kernels")
        del trainer, model
    torch.cuda.empty_cache()
    top = emb["cpu"].abs().max().item()
    e32 = (emb["cuda"] - emb["cpu"]).abs().max().item() / top
    e16 = (emb["bf16"] - emb["cuda"]).abs().max().item() / top
    worst, worst_name = 0.0, ""
    for name, ref in grads["cpu"].items():
        rel = ((grads["cuda"][name] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if rel > worst:
            worst, worst_name = rel, name
    print(f"  embeddings (max |e| {top:.3f}): f32 max|card-CPU|/max {e32:.3e} (tol 1e-3), "
          f"bf16 max|bf16-f32|/max {e16:.3e} (tol 5e-2); loss gap "
          f"{abs(losses['cuda'] - losses['cpu']):.3e}; worst gradient "
          f"max|card-CPU|/max|grad| = {worst:.3e} at {worst_name} (tol 1e-3)", flush=True)
    if not (e32 <= 1e-3 and e16 <= 5e-2 and worst <= 1e-3 and losses["cpu"] > 0
            and abs(losses["cuda"] - losses["cpu"]) <= 1e-4
            and torch.isfinite(emb["bf16"]).all()):
        raise AssertionError("the full-width ViT disagrees with the CPU")


def phase_vit_kernels(gen):
    """Phase 17b: the 4-D qkv kernels at main_vit's batches (B = 1,536 in
    training, 1,024 in testing; S = 65, 12 heads of 32) against plain, then
    timed; a batch over the grid's limit raises."""
    print(f"== phase 17b: 4-D qkv kernels at main_vit's batches (S=65, H={HH}, d={HD}): "
          f"B={VIT_IMAGES} forward, dq, dkv and B={VIT_TEST_IMAGES} forward against plain "
          f"(last key dominant, outputs filled with NaN), then timed, on {card_line()}",
          flush=True)
    c, err = HH * HD, {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (VIT_IMAGES, VIT_TEST_IMAGES):
            qkv = rand(gen, b, 65, 3 * c, dtype=torch.float32)
            probe_packed(qkv[..., :c], qkv[..., c:], HH)
            qkv = qkv.to(dtype)
            with torch.no_grad():
                ref = heads_plain("qkv", [qkv])
                out = heads_call("qkv", [qkv], out=poison(ref))
            torch.cuda.synchronize()
            e, rel = forward_reading(out, ref)
            err["fwd"] = max(err["fwd"], e)
            line = (f"  qkv {str(dtype)[6:]:8s} B={b} S=65 forward max|kernel-plain|="
                    f"{e:.3e}, /max|plain|={rel:.3e}")
            ok = rel <= TOL[dtype]
            if b == VIT_IMAGES:
                x = qkv.detach().requires_grad_()
                o = A.fused_attention_packed_qkv(x, HH)
                do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
                got = torch.autograd.grad(o, x, do, retain_graph=True)[0]
                again = torch.autograd.grad(o, x, do)[0]
                (want,) = heads_plain_grads("qkv", [qkv], do)
                torch.cuda.synchronize()
                ge, worst = parts_reading(got, want, c)
                err["bwd"] = max(err["bwd"], ge)
                ok = (ok and worst <= TOL[dtype] and torch.equal(got, again)
                      and bool(torch.isfinite(got).all()))
                line += (f"; dq, dk, dv /max|grad| (each its own) <= {worst:.3e}, "
                         f"bit-equal twice")
                del x, o, do, got, again, want
            print(f"{line} tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"heads qkv {dtype} B={b}: kernel != plain")
            del qkv, ref, out
            torch.cuda.empty_cache()
    before = dict(A.launches)
    big = torch.zeros(1, 65, 3 * c, device="cuda", dtype=torch.bfloat16).expand(
        A._MAX_GRID + 1, -1, -1)
    try:
        A.fused_attention_packed_qkv(big, HH)
    except ValueError as e:
        print(f"  B={A._MAX_GRID + 1}: the wrapper raises before launching ({e})", flush=True)
    else:
        raise AssertionError(f"a batch of {A._MAX_GRID + 1} did not raise")
    if dict(A.launches) != before:
        raise AssertionError("the over-limit batch launched a kernel")
    times = {}
    for b, backward, tag in ((VIT_IMAGES, True, "train"), (VIT_TEST_IMAGES, False, "test")):
        rows, line = heads_layout_times(gen, "qkv", b, 65, 65, backward)
        times.update({f"{kind}@{tag}": r for kind, r in rows.items()})
        print(line, flush=True)
    return err, times


def phase_vit_train(tmp):
    """Phase 17c: ``python -m vit_ed_tpu_torch.main_vit --mode train`` on
    phase 13's synthetic DIV2K (10 updates of 128 items), then ``--mode
    eval`` and ``--mode throughput``, each with launch counts of its own."""
    from vit_ed_tpu_torch import main_vit

    card = card_line()
    print(f"== phase 17c: python -m vit_ed_tpu_torch.main_vit --mode train (bf16, drop "
          f"path 0.1, {VIT_BATCH} items x 12 images = {VIT_IMAGES} sequences per step)",
          flush=True)
    data, out = os.path.join(tmp, "div2k"), os.path.join(tmp, "out")
    steps = []
    inner = main_vit.VitTripletTrainer.train_step

    def recorded(self, micro_batches):
        before_shapes = dict(A.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "grad_norm": norm.item(),
                      "shapes": {k: n - before_shapes.get(k, 0)
                                 for k, n in A.launches_by_shape.items()
                                 if n > before_shapes.get(k, 0)}})
        return loss, norm

    opts = ("--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    main_vit.VitTripletTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = main_vit.main(vit_argv(data, out, "vit_train", "train", *opts))
    finally:
        main_vit.VitTripletTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    # the main path's counts are read here, before the other modes run
    shapes = dict(A.launches_by_shape)
    ckpt_path = os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt")
    mfu = [line.split("INFO ", 1)[-1].strip() for line in open(os.path.join(
        trainer.config.OUTPUT, "log_rank0train.txt")) if "Model FLOPs" in line]
    ms = [s["ms"] for s in steps[1:]]
    print(f"  {card}: {len(steps)} optimizer steps of {VIT_BATCH} items; step "
          f"{np.median(ms):.1f} ms median ({min(ms):.1f}-{max(ms):.1f}, first "
          f"{steps[0]['ms']:.1f}) with the loader; {VIT_BATCH * len(ms) / (sum(ms) / 1e3):.1f} "
          f"items/s = {VIT_IMAGES * len(ms) / (sum(ms) / 1e3):.1f} images/s; {wall:.1f}s "
          f"with model build and two validates; peak device memory {peak:.2f} GiB", flush=True)
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  grad_norm {[round(s['grad_norm'], 3) for s in steps]}")
    print(f"  {card}: MFU line as logged: {mfu}", flush=True)
    print(f"  launches per step by shape (counter, B, Sq, Sk, launches) "
          f"{sorted((k[0], k[1], k[3], k[4], n) for k, n in steps[-1]['shapes'].items())}; "
          f"--mode train in all {sorted((k[0], k[1], k[3], k[4], n) for k, n in shapes.items())}",
          flush=True)
    if len(steps) != 10 or trainer.step != len(steps):
        raise AssertionError(f"expected 10 optimizer steps, ran {len(steps)}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and s["loss"] > 0 and np.isfinite(s["grad_norm"])):
            raise AssertionError(f"loss / grad_norm not finite: {s}")
        if s["shapes"] != VIT_STEP_SHAPES:
            raise AssertionError(f"unexpected launches in a step: {s['shapes']}")
    if not mfu or "vit geometry" not in mfu[0] or "989.4 TF/s" not in mfu[0]:
        raise AssertionError(f"no MFU line of the ViT count against the card's peak: {mfu}")
    if any(not k[0].startswith("heads_qkv") for k in shapes):
        raise AssertionError(f"--mode train launched another kernel: {shapes}")
    breakdown = step_breakdown(trainer)
    print(f"  {card}: device-only step {sum(breakdown[k] for k in ('forward_ms', 'backward_ms', 'update_ms')):.1f} "
          f"ms by CUDA events; the profiler's device busy share "
          f"{100 * breakdown['device_ms'] / max(breakdown['wall_ms'], 1e-9):.1f}% of its wall, "
          f"{breakdown['launches']} launches per step", flush=True)
    from PIL import Image

    host_input_cost(trainer, div2k_stages() + [("rotate", Image.Image, "rotate")],
                    "PNG decode + flips, warp, crops, then 12 x (rotation, resize, "
                    "normalize) as TwoImgSyncEval of the image with itself")
    del trainer
    torch.cuda.empty_cache()

    eval_argv = vit_argv(data, out, "vit_eval", "eval", "--pretrained", ckpt_path, *opts)
    A.reset_launch_counts()
    loss = main_vit.main(eval_argv)
    eval_counts = nonzero(A.launches)
    A.reset_launch_counts()
    rate = main_vit.main(vit_argv(data, out, "vit_eval", "throughput", "--pretrained",
                                  ckpt_path, *opts))
    torch.cuda.synchronize()
    thr_counts = nonzero(A.launches)
    print(f"  {card}: --mode eval from the checkpoint: triplet loss {loss:.4f}, launches "
          f"{eval_counts}; --mode throughput: {rate:.1f} images/s ({VIT_IMAGES} images of "
          f"one validation batch, 30 forwards between CUDA events; the JAX entry raises "
          f"here), launches {thr_counts}", flush=True)
    if not (0.0 <= loss < 1.0 and rate > 0 and eval_counts.get("heads_qkv", 0) > 0
            and thr_counts.get("heads_qkv", 0) > 0):
        raise AssertionError(f"eval gave {loss}, throughput {rate}")
    return shapes, ckpt_path


def write_vit_puzzles(root, seed=0):
    """One synthetic VIT_PUZZLE_PX-square puzzle in each of Cho/, McGill/
    (PNG) and BGU/ (JPEG), smooth colour fields made from a seed."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for sub in EVAL_SUBSETS:
        os.makedirs(os.path.join(root, sub))
        name = "0.jpg" if sub == "BGU" else "0.png"
        small = rng.integers(0, 256, size=(14, 14, 3), dtype=np.uint8)
        img = Image.fromarray(small).resize((VIT_PUZZLE_PX, VIT_PUZZLE_PX), Image.BICUBIC)
        img.save(os.path.join(root, sub, name), **({"quality": 95}
                                                   if name.endswith(".jpg") else {}))


def phase_vit_test(tmp, ckpt_path):
    """Phase 17d: ``python -m vit_ed_tpu_torch.main_vit --mode test`` with
    phase 17c's checkpoint on one 36-piece puzzle per subset."""
    from vit_ed_tpu_torch import main_vit
    from vit_ed_tpu_torch.data.pieces import PiecesDatasetTriplet
    from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval

    n_pairs = VIT_PIECES * (VIT_PIECES - 1)
    print(f"== phase 17d: python -m vit_ed_tpu_torch.main_vit --mode test (bf16) on one "
          f"{VIT_PUZZLE_PX} x {VIT_PUZZLE_PX} px puzzle per subset: {VIT_PIECES} pieces, "
          f"{n_pairs} ordered pairs, {8 * n_pairs} embeddings each", flush=True)
    card = card_line()
    data, work = os.path.join(tmp, "vit_puzzles"), os.path.join(tmp, "vit_cwd")
    write_vit_puzzles(data)
    os.makedirs(work)
    argv = vit_argv(data, os.path.join(tmp, "out"), "vit_test", "test",
                    "--pretrained", ckpt_path)
    cwd = os.getcwd()
    os.chdir(work)        # the entry writes output/reconstructed/<subset>/ here
    A.reset_launch_counts()
    try:
        trainer = main_vit.VitTripletTrainer(main_vit.parse_option(argv))
        records = trainer.testing()
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    shapes = dict(A.launches_by_shape)
    log = open(os.path.join(trainer.config.OUTPUT, "log_rank0test.txt")).read()
    avg = [line.split("INFO ", 1)[1] for line in log.splitlines() if "Average_Results" in line]
    stages = {k: np.asarray([r["seconds"][k] for r in records]) * 1e3
              for k in records[0]["seconds"]}
    n_emb = 8 * n_pairs * len(records)
    print(f"  {card}: {len(records)} puzzles; ms per puzzle by stage (median): "
          + ", ".join(f"{k} {np.median(v):.1f}" for k, v in stages.items())
          + f"; {n_emb / (stages['embed'].sum() / 1e3):.1f} embeddings/s over the embed "
          f"stage (the loader's pairings and the forwards)", flush=True)
    for line in avg:
        print(f"  {line}")
    ds = PiecesDatasetTriplet(records[0]["pieces"], transform=TwoImgSyncEval(64))
    t0 = time.perf_counter()
    for i in range(64):
        ds[i]
    per = (time.perf_counter() - t0) / 64
    print(f"  host: {per * 1e3:.2f} ms per pairing item (2 LAB -> RGB, 8 rotations and "
          f"resizes, one thread) = {per * n_pairs:.2f} s of host work per puzzle over "
          f"{trainer.config.DATA.NUM_WORKERS} loader threads", flush=True)
    print(f"  launches by shape (counter, B, Sq, Sk, launches) "
          f"{sorted((k[0], k[1], k[3], k[4], n) for k, n in shapes.items())}", flush=True)
    if len(records) != 3 or len(avg) != 3:
        raise AssertionError(f"{len(records)} puzzles and {len(avg)} Average_Results lines")
    for r in records:
        d = r["distances"]
        if d.shape != (4, VIT_PIECES, VIT_PIECES) or np.isfinite(d).sum() != 4 * n_pairs:
            raise AssertionError("the distance tensor is not [4, N, N] with a finite off-diagonal")
    # the entry's distances against direct forwards of the same items
    rec = records[0]
    ds = PiecesDatasetTriplet(rec["pieces"], transform=TwoImgSyncEval(64))
    picks = [0, 17, 500, n_pairs - 1]
    x = torch.from_numpy(np.stack([ds[i][0] for i in picks])).cuda()
    with torch.inference_mode():
        e = trainer.model.eval()(x.reshape(-1, 64, 64, 3)).float().cpu().numpy()
    direct = main_vit.cosine_distance_np(*np.split(e.reshape(len(picks), 4, 2, -1), 2, axis=2))
    got = np.stack([[rec["distances"][side, ds.entries[i][0], ds.entries[i][1]] / 1000.0
                     for side in main_vit.SIDE_ORDER] for i in picks])
    gap = np.abs(direct[..., 0] - got).max()
    print(f"  {len(picks)} pairs' distances against direct forwards of their 8 images: "
          f"max |entry - direct| = {gap:.3e} (tol 1e-2)", flush=True)
    if not gap <= 1e-2:
        raise AssertionError("the testing distances differ from direct forwards")
    if any(k[0] != "heads_qkv" for k in shapes):
        raise AssertionError(f"testing launched another kernel: {shapes}")
    del trainer
    torch.cuda.empty_cache()
    return shapes


def phase_vit_pair_kernels(gen):
    """Phase 17e, first: the pair qkv forward and its backward at
    hisfrag_vit's shape (B = 16 images, S = 1025, 6 heads of 64) against
    plain, then timed."""
    print(f"== phase 17e: hisfrag_vit (ViT-S/16 at 512 px: S=1025, {H} heads of {D}, the "
          f"pair route); the pair qkv kernels at B={HFV_BATCH} against plain, then timed, on "
          f"{card_line()}", flush=True)
    err = {"fwd": 0.0, "bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        kern, plain, _lib, _ = cases(gen, dtype, HFV_BATCH, 1025, 1024, probe=True)["qkv"]
        ref = plain()
        out = kern(poison(ref))
        torch.cuda.synchronize()
        e, rel = forward_reading(out, ref)
        t = vjp_inputs(gen, dtype, HFV_BATCH, 1025, 1025)
        args, o, do = vjp_graph("qkv", t)
        got = torch.autograd.grad(o, args, do, retain_graph=True)[0]
        again = torch.autograd.grad(o, args, do)[0]
        (want,) = plain_grads("qkv", t, do)
        torch.cuda.synchronize()
        ge, worst = parts_reading(got, want, C)
        err["fwd"], err["bwd"] = max(err["fwd"], e), max(err["bwd"], ge)
        ok = (rel <= TOL[dtype] and worst <= TOL[dtype] and torch.equal(got, again)
              and bool(torch.isfinite(got).all()))
        print(f"  qkv {str(dtype)[6:]:8s} B={HFV_BATCH} S=1025 forward /max|plain|={rel:.3e}; "
              f"dq, dk, dv /max|grad| (each its own) <= {worst:.3e}, bit-equal twice "
              f"tol={TOL[dtype]:g} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"pair qkv {dtype} B={HFV_BATCH}: kernel != plain")
        del ref, out, t, args, o, do, got, again, want
    cs = cases(gen, torch.bfloat16, HFV_BATCH, 1025, 1024)
    kern, plain, lib, _ = cs["qkv"]
    r = {"ms": timed(kern), "plain_ms": timed(plain, inner=1), "library_ms": timed(lib)}
    r["bound_ms"], r["bound_by"] = bound("qkv", HFV_BATCH, 1025, 1025)
    print(f"  qkv B={HFV_BATCH} S=1025 forward {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} "
          f"{r['bound_by']}, plain {r['plain_ms']:.4f}, sdpa {r['library_ms']:.4f})", flush=True)
    del cs
    t = vjp_inputs(gen, torch.bfloat16, HFV_BATCH, 1025, 1025)
    rows = backward_rows("qkv", t, HFV_BATCH, 1025, 1025, f"B={HFV_BATCH} S=1025")
    del t
    torch.cuda.empty_cache()
    return err, {"": r, "_dq": rows["qkv_dq"], "_dkv": rows["qkv_dkv"]}


def phase_hisfrag_vit(tmp):
    """Phase 17e: ``python -m vit_ed_tpu_torch.hisfrag_vit --mode train`` on
    phase 9's synthetic train split, then ``eval``, ``test`` (phase 5's test
    split) and ``throughput``, each with launch counts of its own."""
    from vit_ed_tpu_torch import hisfrag_vit

    card = card_line()
    print(f"  python -m vit_ed_tpu_torch.hisfrag_vit --mode train (bf16, drop path 0.1, "
          f"batch {HFV_BATCH}, --opts {' '.join(HFV_OPTS)})", flush=True)
    data = os.path.join(tmp, "hfvit")
    os.makedirs(data)
    os.symlink(os.path.join(tmp, "train_data", "train"), os.path.join(data, "train"))
    os.symlink(os.path.join(tmp, "data", "test"), os.path.join(data, "test"))
    out = os.path.join(tmp, "out")
    steps = []
    inner = hisfrag_vit.HisfragVitTrainer.train_step

    def recorded(self, micro_batches):
        before_shapes = dict(A.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "shapes": {k: n - before_shapes.get(k, 0)
                                 for k, n in A.launches_by_shape.items()
                                 if n > before_shapes.get(k, 0)}})
        return loss, norm

    opts = ("TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    hisfrag_vit.HisfragVitTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = hisfrag_vit.main(hfv_argv(data, out, "hfv_train", "train", opts=opts))
    finally:
        hisfrag_vit.HisfragVitTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    shapes = dict(A.launches_by_shape)
    ckpt_path = os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt")
    mfu = [line.split("INFO ", 1)[-1].strip() for line in open(os.path.join(
        trainer.config.OUTPUT, "log_rank0train.txt")) if "Model FLOPs" in line]
    ms = [s["ms"] for s in steps[1:]]
    print(f"  {card}: {len(steps)} optimizer steps of {HFV_BATCH} images; step "
          f"{np.median(ms):.1f} ms median ({min(ms):.1f}-{max(ms):.1f}, first "
          f"{steps[0]['ms']:.1f}) with the loader; {HFV_BATCH * len(ms) / (sum(ms) / 1e3):.1f} "
          f"images/s; {wall:.1f}s with model build and two validates; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  {card}: MFU line as logged: {mfu}", flush=True)
    print(f"  launches per step by shape (counter, B, Sq, Sk, launches) "
          f"{sorted((k[0], k[1], k[3], k[4], n) for k, n in steps[-1]['shapes'].items())}",
          flush=True)
    if len(steps) != 10 or trainer.step != len(steps):
        raise AssertionError(f"expected 10 optimizer steps, ran {len(steps)}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and s["loss"] >= 0):
            raise AssertionError(f"loss not finite: {s}")
        if s["shapes"] != HFV_STEP_SHAPES:
            raise AssertionError(f"unexpected launches in a step: {s['shapes']}")
    if not mfu or "vit geometry" not in mfu[0] or "989.4 TF/s" not in mfu[0]:
        raise AssertionError(f"no MFU line of the ViT count against the card's peak: {mfu}")
    breakdown = step_breakdown(trainer)
    print(f"  {card}: device-only step {sum(breakdown[k] for k in ('forward_ms', 'backward_ms', 'update_ms')):.1f} "
          f"ms by CUDA events; the profiler's device busy share "
          f"{100 * breakdown['device_ms'] / max(breakdown['wall_ms'], 1e-9):.1f}% of its wall, "
          f"{breakdown['launches']} launches per step", flush=True)
    del trainer
    torch.cuda.empty_cache()

    results = {}
    for mode in ("eval", "test", "throughput"):
        A.reset_launch_counts()
        t0 = time.time()
        results[mode] = hisfrag_vit.main(hfv_argv(data, out, "hfv_eval", mode,
                                                  "--pretrained", ckpt_path, opts=opts))
        torch.cuda.synchronize()
        print(f"  --mode {mode}: {time.time() - t0:.1f}s, launches {nonzero(A.launches)}",
              flush=True)
        if A.launches["qkv"] <= 0:
            raise AssertionError(f"--mode {mode} never launched the pair qkv kernel")
    metrics, dm, labels = results["test"]
    print(f"  {card}: val 1 - mAP {results['eval']:.4f}; test mAP {metrics[0]:.3f} Top 1 "
          f"{metrics[1]:.3f} Pr@k10 {metrics[2]:.3f} Pr@k100 {metrics[3]:.3f} over "
          f"{len(labels)} fragments; throughput {results['throughput']:.1f} images/s",
          flush=True)
    if not (all(np.isfinite(float(m)) and 0.0 <= float(m) <= 1.0 for m in metrics)
            and 0.0 <= results["eval"] <= 1.0 and results["throughput"] > 0
            and dm.shape == (len(labels), len(labels))):
        raise AssertionError("hisfrag_vit's metrics are not finite and in [0, 1]")
    # the distance matrix against -(E E^T) of direct forwards
    trainer = hisfrag_vit.HisfragVitTrainer(hisfrag_vit.parse_option(
        hfv_argv(data, out, "hfv_eval", "test", "--pretrained", ckpt_path, opts=opts)))
    ds = trainer.get_dataloader("test").dataset
    picks = [0, 5, 17, 40, len(ds) - 1]
    x = torch.from_numpy(np.stack([ds[i][0] for i in picks])).cuda()
    with torch.inference_mode():
        e = trainer.model.eval()(x).float().cpu().numpy()
    direct = -(e @ e.T)
    got = dm[np.ix_(picks, picks)]
    gap = np.abs(got - direct).max() / np.abs(direct).max()
    print(f"  {len(picks)} fragments: max |matrix - (-(E E^T))| / max = {gap:.3e} (tol 1e-2)",
          flush=True)
    if not gap <= 1e-2:
        raise AssertionError("the distance matrix differs from direct forwards")
    del trainer
    torch.cuda.empty_cache()
    return shapes


def phase_vit(tmp, gen):
    """Phase 17: the ViT embedding baselines. Returns the kernels' rows."""
    t0 = time.time()
    phase_vit_model(tmp)
    heads_err, heads_times = phase_vit_kernels(gen)
    train_shapes, ckpt_path = phase_vit_train(tmp)
    test_shapes = phase_vit_test(tmp, ckpt_path)
    pair_err, pair_times = phase_vit_pair_kernels(gen)
    hfv_shapes = phase_hisfrag_vit(tmp)
    print(f"  phase 17 took {time.time() - t0:.1f}s", flush=True)

    # one row per kernel and shape: ``launches`` of main_vit --mode train (the
    # testing forward's of --mode test) and hisfrag_vit --mode train, each at
    # its own shape; the times of 17b and 17e at those shapes
    rows = []
    for kind, source, replaces in (("", HEADS_SOURCE, HEADS_REPLACES["forward"]),
                                   ("_dq", HEADS_BWD_SOURCE, HEADS_REPLACES["dq"]),
                                   ("_dkv", HEADS_BWD_SOURCE, HEADS_REPLACES["dkv"])):
        rows.append({
            "name": f"heads_attention_qkv{kind}_vit_b{VIT_IMAGES}", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": train_shapes.get((f"heads_qkv{kind}", VIT_IMAGES, HH, 65, 65, HD), 0),
            "max_abs_err": heads_err["bwd" if kind else "fwd"],
            **heads_times[f"{kind}@train"]})
    rows.append({
        "name": f"heads_attention_qkv_vit_test_b{VIT_TEST_IMAGES}", "route": "cuda",
        "source": HEADS_SOURCE, "replaces": HEADS_REPLACES["forward"],
        "launches": by_shape(test_shapes, "heads_qkv", 65, 65),
        "max_abs_err": heads_err["fwd"], **heads_times["@test"]})
    for kind, source, replaces in (("", SOURCE, REPLACES["qkv"]),
                                   ("_dq", HEADS_BWD_SOURCE, BWD_REPLACES),
                                   ("_dkv", HEADS_BWD_SOURCE, BWD_REPLACES)):
        rows.append({
            "name": f"pair_attention_qkv{kind}_vit_s1025", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": hfv_shapes.get((f"qkv{kind}", HFV_BATCH, H, 1025, 1025, D), 0),
            "max_abs_err": pair_err["bwd" if kind else "fwd"], **pair_times[kind]})
    return rows


# ---------------------------------------------------------------------------
# phase 18: the Pajigsaw entry, lr_finder, solver_driver, the BatchNorm models
# ---------------------------------------------------------------------------

PJS_CFG = os.path.join(ROOT, "configs", "pajigsaw", "pajigsaw_patch16_512.yaml")
PJS_BATCH = 64               # stacked pairs per update
PJS_ROWS, PJS_COLS = 3, 4    # the fragment grid of every image
PJS_TRAIN_IMAGES = 54        # 648 anchors: 10 updates of 64 pairs
PJS_CHUNK = PJS_ROWS * PJS_COLS   # score_dense's chunk: a row's 11 pairs padded to 12
# launches of one Pajigsaw update by (counter, B, H, Sq, Sk, d): the encoder's
# 12 self-attentions at S = 1024 (no CLS), the decoder's 11 at 1025 and its
# last block's CLS row, 11 per-pair cross-attentions and the last block's
# CLS-row one, each one forward, one dq and one dkv
PJS_STEP_SHAPES = {(f"{name}{kind}", PJS_BATCH, H, n_q, n_k, D): n
                   for name, n_q, n_k, n in (("qkv", 1024, 1024, 12), ("qkv", 1025, 1025, 11),
                                             ("qkv_cls", 1, 1025, 1), ("kv", 1025, 1024, 11),
                                             ("kv", 1, 1024, 1))
                   for kind in ("", "_dq", "_dkv")}
# the kernels of the train path (B = PJS_BATCH) and of score_dense (B =
# PJS_CHUNK), each held against plain and timed at that shape:
# (tag, layouts forward, layouts backward, B, S, Sk)
PJS_KERNEL_SETS = (("train", ("qkv", "qkv_cls", "kv"), ("qkv", "qkv_cls", "kv"),
                    PJS_BATCH, 1025, 1024),
                   ("encoder", ("qkv",), ("qkv",), PJS_BATCH, 1024, 1024),
                   ("dense", ("kv_shared", "kv_shared_cls", "qkv", "qkv_cls"), (),
                    PJS_CHUNK, 1025, 1024),
                   ("dense_encoder", ("qkv",), (), PJS_CHUNK, 1024, 1024))
# the BatchNorm baselines at 512 px: MODEL.TYPE -> --opts
BN_MODELS = {
    "resnet": ("MODEL.RES.ARCH", "resnet34"),
    "mixconv": ("MODEL.MIXCONV.ARCH", "resnet18", "MODEL.MIXCONV.MIX_DEPTH", "4",
                "MODEL.MIXCONV.OUT_CHANNELS", "512"),
    "ss": ("MODEL.SS.ARCH", "resnet34", "MODEL.SS.EMBED_DIM", "2048",
           "MODEL.SS.PRED_DIM", "512"),
    "ss2": ("MODEL.SS.ARCH", "resnet34", "MODEL.SS.EMBED_DIM", "2048",
            "MODEL.SS.PRED_DIM", "512"),
    "ss2ce": ("MODEL.SS.ARCH", "resnet34", "MODEL.SS.EMBED_DIM", "2048",
              "MODEL.SS.PRED_DIM", "512", "MODEL.SS.N_CLASSES", "20"),
}
SS_BATCH = 16


def write_pajigsaw(root, split, images, seed, size=512):
    """``images`` synthetic images cut into a PJS_ROWS x PJS_COLS grid of
    ``size`` px JPEG fragments, and ``<root>/<split>.json``."""
    import json

    from PIL import Image

    rng = np.random.default_rng(seed)
    manifest = {}
    for im in range(images):
        name = f"{split}{im:03d}"
        small = rng.integers(0, 256, (PJS_ROWS * 2, PJS_COLS * 2, 3), dtype=np.uint8)
        big = np.asarray(Image.fromarray(small).resize(
            (PJS_COLS * size, PJS_ROWS * size), Image.BICUBIC)).astype(np.int16)
        big = np.clip(big + rng.integers(-24, 24, big.shape), 0, 255).astype(np.uint8)
        os.makedirs(os.path.join(root, name), exist_ok=True)
        fragments = []
        for r in range(PJS_ROWS):
            for c in range(PJS_COLS):
                rel = f"{name}/{r}_{c}.jpg"
                Image.fromarray(big[r * size:(r + 1) * size, c * size:(c + 1) * size]).save(
                    os.path.join(root, rel), quality=90)
                fragments.append({"im_path": rel, "row": r, "col": c, "degree": 0,
                                  "white_percentage": 0.0})
        manifest[name] = {"Fragment1v1Rotate90": fragments}
    with open(os.path.join(root, f"{split}.json"), "w") as f:
        json.dump(manifest, f)
    return images * PJS_ROWS * PJS_COLS


def pajigsaw_argv(data, out, tag, mode, *extra):
    return ["--cfg", PJS_CFG, "--data-path", data, "--mode", mode, "--output", out,
            "--tag", tag, "--batch-size", str(PJS_BATCH), *extra]


def phase_pajigsaw_entry(tmp, data):
    """Phase 18b: ``python -m vit_ed_tpu_torch.pajigsaw --mode train`` at
    full width (10 updates of 64 stacked pairs, a validate before and after
    solving every val puzzle), then ``eval``, ``test`` and ``throughput``,
    each with launch counts of its own; score_dense against direct
    forwards."""
    from PIL import Image

    from vit_ed_tpu_torch import pajigsaw
    from vit_ed_tpu_torch.data.pajigsaw import PajigsawPieces, Split
    from vit_ed_tpu_torch.data.pieces import PiecesImages
    from vit_ed_tpu_torch.data.transforms import TwoImgSyncEval
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    card = card_line()
    print(f"== phase 18b: python -m vit_ed_tpu_torch.pajigsaw --mode train (pjs-S "
          f"patch16_512, bf16, drop path 0.1, {PJS_BATCH} stacked pairs per update, "
          f"{PJS_TRAIN_IMAGES} images x {PJS_CHUNK} fragments of 512 px)", flush=True)
    out = os.path.join(tmp, "out")
    steps = []
    inner = pajigsaw.PajigsawTrainer.train_step

    def recorded(self, micro_batches):
        before = dict(A.launches_by_shape)
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item(),
                      "shapes": {k: n - before.get(k, 0) for k, n in
                                 A.launches_by_shape.items() if n > before.get(k, 0)}})
        return loss, norm

    opts = ("--opts", "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2")
    torch.cuda.reset_peak_memory_stats()
    A.reset_launch_counts()
    pajigsaw.PajigsawTrainer.train_step = recorded
    t0 = time.time()
    try:
        trainer = pajigsaw.main(pajigsaw_argv(data, out, "pjs_train", "train", *opts))
    finally:
        pajigsaw.PajigsawTrainer.train_step = inner
    torch.cuda.synchronize()
    wall = time.time() - t0
    train_shapes = dict(A.launches_by_shape)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log = open(os.path.join(trainer.config.OUTPUT, "log_rank0train.txt")).read()
    mfu = [line.split("INFO ", 1)[-1].strip() for line in log.splitlines()
           if "Model FLOPs" in line]
    ms = [s["ms"] for s in steps[1:]]
    print(f"  {card}: {len(steps)} optimizer steps of {PJS_BATCH} pairs; step "
          f"{np.median(ms):.1f} ms median ({min(ms):.1f}-{max(ms):.1f}, first "
          f"{steps[0]['ms']:.1f}) with the loader; {PJS_BATCH * len(ms) / (sum(ms) / 1e3):.1f} "
          f"trained pairs/s; {wall:.1f}s with model build and two validates; peak device "
          f"memory {peak:.2f} GiB", flush=True)
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  {card}: MFU line as logged: {mfu}")
    print(f"  validates: {[m.split('INFO ', 1)[-1] for m in log.splitlines() if 'Average_Results' in m]}")
    print(f"  launches per step by shape (counter, B, Sq, Sk, launches) "
          f"{sorted((k[0], k[1], k[3], k[4], n) for k, n in steps[-1]['shapes'].items())}",
          flush=True)
    if len(steps) != 10 or trainer.step != 10:
        raise AssertionError(f"expected 10 optimizer steps, ran {len(steps)}")
    for s in steps:
        if not (np.isfinite(s["loss"]) and s["loss"] > 0):
            raise AssertionError(f"loss not finite and positive: {s['loss']}")
        if s["shapes"] != PJS_STEP_SHAPES:
            raise AssertionError(f"unexpected launches in a step: {s['shapes']}")
    if not mfu or "pjs geometry" not in mfu[0] or "989.4 TF/s" not in mfu[0]:
        raise AssertionError(f"no MFU line of the pjs count against the card's peak: {mfu}")
    if log.count("Average_Results") != 2:
        raise AssertionError("--mode train did not validate twice")
    breakdown = step_breakdown(trainer)
    print(f"  {card}: device-only step "
          f"{sum(breakdown[k] for k in ('forward_ms', 'backward_ms', 'update_ms')):.1f} ms by "
          f"CUDA events; the profiler's device busy share "
          f"{100 * breakdown['device_ms'] / max(breakdown['wall_ms'], 1e-9):.1f}% of its wall",
          flush=True)

    # score_dense on a val puzzle against direct forwards of its 132 pairs
    model = trainer.model.eval()
    pieces, _name, _grid = PajigsawPieces(data, Split.VAL)[0]
    imgs = PiecesImages(pieces, transform=TwoImgSyncEval(
        trainer.config.DATA.IMG_SIZE)).all_images()
    n = len(imgs)
    logits = PairwiseScorer(model, num_outputs=4, pair_chunk=PJS_BATCH).score_dense(
        imgs, batch_size=PJS_BATCH)
    pi, pj = np.nonzero(~np.eye(n, dtype=bool))
    x = torch.from_numpy(np.stack([np.stack([imgs[i], imgs[j]]) for i, j in zip(pi, pj)]))
    with torch.inference_mode():
        direct = torch.cat([model(x[lo:lo + PJS_BATCH].cuda()).float().cpu()
                            for lo in range(0, len(x), PJS_BATCH)]).numpy()
    gap = float(np.abs(direct - logits[pi, pj]).max())
    print(f"  score_dense of a {n}-piece val puzzle against {len(pi)} direct pair forwards: "
          f"max gap {gap:.3e} (tol 1e-2; |logits| up to {np.abs(direct).max():.3f})",
          flush=True)
    if not (gap <= 1e-2 and np.isfinite(logits).all()):
        raise AssertionError("score_dense disagrees with direct forwards")
    seconds = trainer.puzzle_seconds
    ckpt_path = os.path.join(trainer.config.OUTPUT, "checkpoint.ckpt")
    del trainer, model, x
    torch.cuda.empty_cache()

    results, shapes = {}, {}
    for mode in ("eval", "test", "throughput"):
        A.reset_launch_counts()
        t0 = time.time()
        results[mode] = pajigsaw.main(pajigsaw_argv(data, out, "pjs_eval", mode,
                                                    "--pretrained", ckpt_path, *opts))
        torch.cuda.synchronize()
        shapes[mode] = dict(A.launches_by_shape)
        print(f"  --mode {mode}: {time.time() - t0:.1f}s, launches {nonzero(A.launches)}",
              flush=True)
        if A.launches["qkv"] <= 0:
            raise AssertionError(f"--mode {mode} never launched the pair qkv kernel")
    acc, puzzles, names = results["test"]
    rec_dir = os.path.join(out, "pajigsaw_patch16_512", "pjs_eval", "reconstructed")
    sizes = []
    for name in names:
        with Image.open(os.path.join(rec_dir, f"{name}.jpg")) as im:
            im.load()
            sizes.append(im.size)
    per = {k: np.mean([s[k] for s in seconds]) * 1e3 for k in seconds[0]}
    print(f"  {card}: val 1 - neighbour {results['eval']:.4f}; test neighbour {acc:.4f} "
          f"over {len(names)} puzzles, reconstructions {sizes}; throughput "
          f"{results['throughput']:.1f} pairs/s; ms per {n}-piece puzzle by stage "
          + ", ".join(f"{k} {v:.1f}" for k, v in per.items()), flush=True)
    if not (0.0 <= results["eval"] <= 1.0 and 0.0 <= acc <= 1.0
            and results["throughput"] > 0 and len(sizes) == 2):
        raise AssertionError("pajigsaw's eval / test / throughput results are off")
    if by_shape(shapes["eval"], "kv_shared", 1025, 1024, PJS_CHUNK) <= 0:
        raise AssertionError("--mode eval never launched kv_shared at the validation's chunk")
    return train_shapes, shapes["eval"]


def ss2_trainer_cls():
    """A trainer of single-view SimSiam on hisfrag fragments (the one the
    JAX package's tests/test_ss_entry.py defines; neither package has an
    entry for the BatchNorm types)."""
    from vit_ed_tpu_torch.hisfrag_vit import HisfragVitTrainer
    from vit_ed_tpu_torch.train.losses import negative_cosine_similarity

    class Trainer(HisfragVitTrainer):
        def make_loss_fn(self, criterion):
            def loss_fn(model, batch):
                p1, z1 = model(batch["samples"])
                return negative_cosine_similarity(p1.float(), z1.float())

            return loss_fn

        def validate(self):
            self.model.eval()
            losses = []
            with torch.inference_mode():
                for images, _ in self.get_dataloader("val"):
                    p1, z1 = self.model(self._to_device({"x": images})["x"])
                    losses.append(float(negative_cosine_similarity(p1.float(), z1.float())))
            return float(np.mean(losses))

    return Trainer


def bn_argv(model_type, out, tag, data="none", *extra):
    return ["--cfg", FLAGSHIP_CFG, "--data-path", data, "--output", out, "--tag", tag,
            *extra, "--opts", "MODEL.TYPE", model_type, *BN_MODELS[model_type]]


def close(got, want, tol, what):
    """max |got - want| over max |want| within ``tol``, else raise."""
    rel = (got.float() - want.float()).abs().max().item() / max(
        want.float().abs().max().item(), 1e-30)
    if not rel <= tol:
        raise AssertionError(f"{what}: {rel:.3e} of the max, tol {tol:g}")
    return rel


def stats_reading(got, want):
    """The largest reading over the running statistics ``got`` against
    ``want`` (state dicts, after one training forward from the init values
    0 / 1): a variance against its max; a mean against the larger of its
    max and 0.01 x the batch's std (the momentum's share of a batch mean
    that is zero up to rounding, as after a bias-free Dense fed by an
    affine-free BatchNorm, has no scale of its own)."""
    worst = 0.0
    for k, v in got.items():
        if "running_" not in k:
            continue
        w = want[k].double()
        scale = float(w.abs().max())
        if k.endswith("running_mean"):
            var = (want[k.replace("mean", "var")].double() - 0.99) / 0.01
            scale = max(scale, 0.01 * float(var.clamp(min=0).max()) ** 0.5)
        worst = max(worst, float((v.double().cpu() - w).abs().max()) / scale)
    return worst


def phase_bn_models(tmp):
    """Phase 18c: the BatchNorm baselines at 512 px from seed 0: forwards
    card against CPU and bf16 against f32, one ss2 step card against CPU,
    two steps from one state bit for bit, and ss2 training through a
    trainer."""
    import copy

    from vit_ed_tpu_torch.hisfrag_vit import parse_option
    from vit_ed_tpu_torch.train.losses import negative_cosine_similarity

    card = card_line()
    print(f"== phase 18c: the BatchNorm baselines at 512 px (resnet34, mixconv on "
          f"resnet18 with 4 MetaFormer blocks of 512, SimSiam ss / ss2 / ss2ce on "
          f"resnet34 with 2048 / 512) on {card}", flush=True)
    out = os.path.join(tmp, "out")
    for model_type in BN_MODELS:
        cfg = get_config(parse_option(bn_argv(model_type, out, f"bn_{model_type}_cpu",
                                              "none", "--disable_amp")))
        torch.manual_seed(0)
        cpu = build_model(cfg)
        card_f32 = copy.deepcopy(cpu).cuda()
        card_bf16 = build_model(get_config(parse_option(
            bn_argv(model_type, out, f"bn_{model_type}")))).cuda()
        card_bf16.load_state_dict(cpu.state_dict())
        px = cfg.DATA.IMG_SIZE
        # train mode normalises the SimSiam heads' features by statistics
        # over the batch: over 4 samples some of the 2048 features have a
        # spread that float32 does not resolve to 1e-3 of the max (PERF.md,
        # PR 10), over 16 it does. The SimSiam types run train mode at 16,
        # everything else at 4.
        n = SS_BATCH if model_type.startswith("ss") else 4
        shape = (n, 2, px, px, 3) if model_type == "ss" else (n, px, px, 3)
        x = torch.randn(shape, generator=torch.Generator().manual_seed(1))
        readings = []
        for mode in ("train", "eval"):
            xm = x if mode == "train" else x[:4]
            with torch.no_grad():
                ref = cpu.train(mode == "train")(xm)
                got = card_f32.train(mode == "train")(xm.cuda())
                half = card_bf16.train(mode == "train")(xm.cuda())
            if mode == "train":
                train_stats = copy.deepcopy(card_f32.state_dict())
                cpu_train_stats = copy.deepcopy(cpu.state_dict())
            ref, got, half = (o if isinstance(o, tuple) else (o,) for o in (ref, got, half))
            for i, (r, g, hb) in enumerate(zip(ref, got, half)):
                f32 = close(g.cpu(), r, 1e-3, f"{model_type} {mode} out {i} card f32")
                # bf16 against f32 in eval mode only: in train mode the
                # SimSiam projector's BatchNorms divide by the spread of 4
                # random-init pooled features (~6% of their mean), which
                # bf16's rounding of those features does not resolve
                bf16 = (close(hb.cpu(), g.cpu(), 5e-2, f"{model_type} out {i} bf16")
                        if mode == "eval" else
                        (hb.float().cpu() - g.cpu()).abs().max().item()
                        / g.abs().max().item())
                readings.append((mode, i, f32, bf16))
        # the statistics after the train-mode forward from their init values
        stats = stats_reading(train_stats, cpu_train_stats)
        if not stats <= 1e-3:
            raise AssertionError(f"{model_type} running statistics card != CPU: {stats:.3e}")
        n_bn = sum(k.endswith("running_mean") for k in train_stats)
        print(f"  {model_type:7s} {sum(p.numel() for p in cpu.parameters()) / 1e6:.2f} M "
              f"params, {n_bn} BatchNorms; (mode, output, f32 card/CPU, bf16/f32) "
              + "; ".join(f"{m} {i} {a:.2e} {b:.2e}" for m, i, a, b in readings)
              + f"; running statistics card/CPU {stats:.2e}", flush=True)
        del cpu, card_f32, card_bf16
    torch.cuda.empty_cache()

    # one ss2 step, card against CPU. In float32 the loss and the running
    # statistics are held; the gradients of this loss at random init are
    # not float32-stable (many are small differences of large terms through
    # the BatchNorms: the CPU's own float32 gradients are read against its
    # float64 below), so they are held in float64, card against CPU, and the
    # float32 readings are printed beside them
    cfg = get_config(parse_option(bn_argv("ss2", out, "bn_step", "none", "--disable_amp")))
    torch.manual_seed(0)
    cpu = build_model(cfg)
    px = cfg.DATA.IMG_SIZE
    x = torch.randn((SS_BATCH, px, px, 3), generator=torch.Generator().manual_seed(2))
    res = {}
    for dtype in (torch.float32, torch.float64):
        for where in ("cpu", "cuda"):
            m = copy.deepcopy(cpu).to(where, dtype)
            for mod in m.modules():
                if getattr(mod, "dtype", None) == torch.float32:
                    mod.dtype = dtype
            p1, z1 = m.train()(x.to(where, dtype))
            loss = negative_cosine_similarity(p1, z1)
            loss.backward()
            cos = torch.nn.functional.cosine_similarity(p1.detach(), z1, dim=1)
            res[(where, dtype)] = (
                loss.item(), cos.abs().max().item(),
                {k: p.grad.cpu().double() for k, p in m.named_parameters()},
                {k: v.cpu().double() for k, v in m.state_dict().items() if "running_" in k})
            del m, p1, z1, loss
    torch.cuda.empty_cache()

    def grad_reading(got, want):
        worst, where_ = 0.0, ""
        for k, g in got.items():
            if k == "projector.fc3.bias":    # zero in exact arithmetic (a BN follows)
                continue
            rel = float((g - want[k]).abs().max() / want[k].abs().max().clamp(min=1e-300))
            if rel > worst:
                worst, where_ = rel, k
        return worst, where_

    f32, f64 = torch.float32, torch.float64
    card32, cpu32 = res[("cuda", f32)], res[("cpu", f32)]
    card64, cpu64 = res[("cuda", f64)], res[("cpu", f64)]
    held = {
        "f32 loss (of the largest |cosine| term)":
            abs(card32[0] - cpu32[0]) / cpu32[1],
        "f32 running statistics": stats_reading(card32[3], cpu32[3]),
        "f64 loss": abs(card64[0] - cpu64[0]) / cpu64[1],
        "f64 gradients (each its own max)": grad_reading(card64[2], cpu64[2])[0],
        "f64 running statistics": stats_reading(card64[3], cpu64[3]),
    }
    largest = max(float(g.abs().max()) for g in cpu64[2].values())
    held["f64 projector.fc3.bias gradient (of the largest gradient)"] = max(
        float(r[2]["projector.fc3.bias"].abs().max()) for r in (card64, cpu64)) / largest
    read = {"f32 gradients card against CPU": grad_reading(card32[2], cpu32[2]),
            "f32 gradients card against f64": grad_reading(card32[2], cpu64[2]),
            "f32 gradients CPU against f64": grad_reading(cpu32[2], cpu64[2])}
    print(f"  ss2 step at batch {SS_BATCH}, card against CPU: loss f32 {card32[0]:.6f} / "
          f"{cpu32[0]:.6f}; held (tol 1e-3): "
          + "; ".join(f"{k} {v:.3e}" for k, v in held.items())
          + "; read, not held: " + "; ".join(f"{k} {v:.3e} ({n})" for k, (v, n) in read.items()),
          flush=True)
    bad = [k for k, v in held.items() if not v <= 1e-3]
    if bad:
        raise AssertionError(f"ss2 step card != CPU: {bad}")
    del cpu, res
    torch.cuda.empty_cache()

    # ss2 training through the trainer, then two steps from one state
    data = os.path.join(tmp, "ss2")
    if not os.path.isdir(data):
        os.makedirs(data)
        os.symlink(os.path.join(tmp, "train_data", "train"), os.path.join(data, "train"))
    trainer_cls = ss2_trainer_cls()
    steps = []
    inner = trainer_cls.train_step

    def recorded(self, micro_batches):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = inner(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "loss": loss.item()})
        return loss, norm

    trainer_cls.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    argv = bn_argv("ss2", out, "ss2_train", data, "--batch-size", str(SS_BATCH))
    argv += ["TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2"]
    t0 = time.time()
    trainer = trainer_cls(parse_option(argv))
    stats0 = {k: v.clone() for k, v in trainer.model.state_dict().items() if "running_" in k}
    trainer.train()
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    mfu = [line.split("INFO ", 1)[-1].strip() for line in open(os.path.join(
        trainer.config.OUTPUT, "log_rank0train.txt")) if "Model FLOPs" in line]
    ms = [s["ms"] for s in steps[1:]]
    moved = sum(not torch.equal(v, trainer.model.state_dict()[k]) for k, v in stats0.items())
    print(f"  {card}: ss2 train, {len(steps)} steps of {SS_BATCH} images (bf16); step "
          f"{np.median(ms):.1f} ms median ({min(ms):.1f}-{max(ms):.1f}, first "
          f"{steps[0]['ms']:.1f}) with the loader; {wall:.1f}s with build and two validates; "
          f"peak device memory {peak:.2f} GiB; {moved} of {len(stats0)} running statistics "
          f"moved", flush=True)
    print(f"  loss {[round(s['loss'], 4) for s in steps]}")
    print(f"  {card}: MFU line as logged: {mfu}", flush=True)
    if len(steps) < 10 or trainer.step != len(steps):
        raise AssertionError(f"ss2 ran {len(steps)} steps, expected >= 10")
    if not all(np.isfinite(s["loss"]) for s in steps) or moved != len(stats0):
        raise AssertionError("ss2 loss not finite or running statistics not updated")
    if not mfu or "ss2 geometry" not in mfu[0] or "989.4 TF/s" not in mfu[0]:
        raise AssertionError(f"no MFU line of the ss2 count against the card's peak: {mfu}")
    breakdown = step_breakdown(trainer)
    print(f"  {card}: ss2 device-only step "
          f"{sum(breakdown[k] for k in ('forward_ms', 'backward_ms', 'update_ms')):.1f} ms",
          flush=True)
    trainer_cls.train_step = inner
    samples, targets = next(iter(trainer.get_dataloader("train")))
    host = trainer.prepare_data(samples, targets)
    model, opt = trainer.model, trainer.optimizer
    start = (copy.deepcopy(model.state_dict()), copy.deepcopy(opt.state_dict()), trainer.step)

    def step():
        model.load_state_dict(start[0])
        opt.load_state_dict(copy.deepcopy(start[1]))
        trainer.step = start[2]
        trainer.train_step([host])
        torch.cuda.synchronize()
        got = {k: v.clone() for k, v in model.state_dict().items()}
        for i, st in opt.state_dict()["state"].items():
            got.update({f"moment {i} {k}": v.clone() for k, v in st.items()
                        if torch.is_tensor(v)})
        return got

    a, b = step(), step()
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    print(f"  ss2 two steps from one state: {len(a)} parameter, buffer and moment tensors, "
          f"{len(a) - len(differ)} equal bit for bit (cudnn.deterministic "
          f"{torch.backends.cudnn.deterministic})", flush=True)
    if differ:
        raise AssertionError(f"an ss2 step is not reproducible: {differ[:8]}")
    del trainer, model, opt
    torch.cuda.empty_cache()


def phase_lr_finder(tmp):
    """Phase 18d: ``python -m vit_ed_tpu_torch.lr_finder`` on phase 13's
    DIV2K at patch8_64, B = 128, 30 iterations, launch counts of its own."""
    from vit_ed_tpu_torch import lr_finder

    print(f"== phase 18d: python -m vit_ed_tpu_torch.lr_finder (pjs patch8_64, bf16, "
          f"B={PUZZLE_BATCH}, 30 iterations)", flush=True)
    A.reset_launch_counts()
    t0 = time.time()
    trainer = lr_finder.main(["--cfg", PUZZLE_CFG, "--data-path", os.path.join(tmp, "div2k"),
                              "--output", os.path.join(tmp, "out"), "--tag", "lrf",
                              "--batch-size", str(PUZZLE_BATCH), "--numb-iter", "30"])
    torch.cuda.synchronize()
    shapes = dict(A.launches_by_shape)
    log = open(os.path.join(trainer.config.OUTPUT, "log_rank0lr_finder.txt")).read()
    plot = [m.split("INFO ", 1)[-1] for m in log.splitlines() if "lr_finder_result" in m]
    print(f"  {card_line()}: {len(trainer.losses)} iterations in {time.time() - t0:.1f}s; "
          f"smoothed losses {[round(float(v), 4) for v in trainer.losses]}; suggestion "
          f"{trainer.suggestion:.3e}; plot: {plot or 'written'}; launches {nonzero(A.launches)}",
          flush=True)
    if not (len(trainer.losses) >= 4 and np.isfinite(trainer.losses).all()):
        raise AssertionError("lr_finder's losses are not finite")
    if A.launches["heads_qkv"] <= 0 or A.launches["heads_qkv_dq"] <= 0:
        raise AssertionError("lr_finder never launched the 4-D kernels")
    return shapes


def phase_solver_driver(tmp):
    """Phase 18e: ``python -m vit_ed_tpu_torch.solver_driver`` on two
    synthetic JPEGs."""
    import random

    from PIL import Image

    from vit_ed_tpu_torch import solver_driver

    images, out = os.path.join(tmp, "solver_images"), os.path.join(tmp, "solver_out")
    os.makedirs(images)
    rng = np.random.default_rng(7)
    for i, (w, h) in enumerate(((512, 384), (448, 448))):
        small = rng.integers(0, 256, (6, 7, 3), dtype=np.uint8)
        Image.fromarray(small).resize((w, h), Image.BICUBIC).save(
            os.path.join(images, f"{i}.jpg"), quality=95)
    random.seed(0)
    t0 = time.time()
    records = solver_driver.main(["--images", images, "--output", out])
    print(f"== phase 18e: python -m vit_ed_tpu_torch.solver_driver: {len(records)} images "
          f"in {time.time() - t0:.2f}s: " + "; ".join(
              f"{os.path.basename(r['image'])} {len(r['puzzle'].pieces)} pieces "
              f"{ {k: round(v[0], 4) for k, v in r['result'].items()} } perfect {r['perfect']}"
              for r in records), flush=True)
    if len(records) != 2 or sorted(os.listdir(out)) != ["0.jpg", "1.jpg"]:
        raise AssertionError("solver_driver did not solve and write both images")


def phase_options(tmp):
    """Phase 18f: TPU.FAST_GELU card against CPU, MODEL.DROP_RATE 0.1
    reproducible from one generator seed and absent in eval."""
    import copy

    from vit_ed_tpu_torch import main as puzzle_main

    def model_for(*opts, f32=False):
        cfg = get_config(puzzle_main.parse_option(puzzle_argv(
            "none", os.path.join(tmp, "out"), "opts", "eval",
            *(("--disable_amp",) if f32 else ()), "--opts", "TRAIN.AUTO_RESUME", "False",
            *opts)))
        torch.manual_seed(0)
        return build_model(cfg)

    cpu = model_for("TPU.FAST_GELU", "True", f32=True)
    card_m = copy.deepcopy(cpu).cuda()
    x = torch.randn((8, 2, 64, 64, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = cpu.eval()(x)
        got = card_m.eval()(x.cuda()).cpu()
    fast = close(got, ref, 1e-3, "FAST_GELU card f32")
    drop = model_for("MODEL.DROP_RATE", "0.1").cuda()
    plain = model_for().cuda()
    plain.load_state_dict(drop.state_dict())
    xs = x.cuda()
    runs = []
    for _ in range(2):
        drop.train().seed_drop_path(5)
        drop.zero_grad(set_to_none=True)
        loss = drop(xs).float().square().mean()
        loss.backward()
        runs.append((loss.detach().clone(), [p.grad.clone() for p in drop.parameters()]))
    same = torch.equal(runs[0][0], runs[1][0]) and all(
        torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    with torch.no_grad():
        untouched = torch.equal(drop.eval()(xs), plain.eval()(xs))
        drop.train().seed_drop_path(5)
        plain.train().seed_drop_path(5)
        dropped = not torch.equal(drop(xs), plain(xs))
    print(f"== phase 18f: TPU.FAST_GELU pjs patch8_64 f32 card against CPU {fast:.3e} of the "
          f"max (tol 1e-3); MODEL.DROP_RATE 0.1: a train step twice from one generator seed "
          f"equal bit for bit {same}, eval equal to DROP_RATE 0 {untouched}, training "
          f"differs from DROP_RATE 0 {dropped}", flush=True)
    if not (same and untouched and dropped):
        raise AssertionError("MODEL.DROP_RATE: not reproducible, or eval touched, or no effect")


def phase_pajigsaw(tmp, gen):
    """Phase 18. Returns the kernels' rows and lr_finder's launches."""
    t0 = time.time()
    print(f"== phase 18a: pair kernels against plain at the Pajigsaw shapes (C=384, H=6; "
          f"train B={PJS_BATCH} at S=1025 and the encoder's 1024; score_dense's chunk "
          f"B={PJS_CHUNK}) on {card_line()}", flush=True)
    err = hold_pair_kernels(gen, PJS_KERNEL_SETS, "18a")
    times = time_pair_kernels(gen, PJS_KERNEL_SETS, "18a")
    data = os.path.join(tmp, "pajigsaw")
    t1 = time.time()
    n = write_pajigsaw(data, "train", PJS_TRAIN_IMAGES, seed=0)
    n += write_pajigsaw(data, "val", 2, seed=1) + write_pajigsaw(data, "test", 2, seed=2)
    print(f"  wrote {n} fragments of 512 px in {time.time() - t1:.1f}s", flush=True)
    train_shapes, eval_shapes_run = phase_pajigsaw_entry(tmp, data)
    phase_bn_models(tmp)
    lrf_shapes = phase_lr_finder(tmp)
    phase_solver_driver(tmp)
    phase_options(tmp)
    print(f"  phase 18 took {time.time() - t0:.1f}s", flush=True)

    rows = []
    for tag, name, n_q, n_k, suffix in (("train", "qkv", 1025, 1025, ""),
                                        ("encoder", "qkv", 1024, 1024, "_encoder"),
                                        ("train", "qkv_cls", 1, 1025, ""),
                                        ("train", "kv", 1025, 1024, "")):
        for kind, source, replaces in (("", SOURCE, REPLACES[name]),
                                       ("_dq", HEADS_BWD_SOURCE, BWD_REPLACES),
                                       ("_dkv", HEADS_BWD_SOURCE, BWD_REPLACES)):
            rows.append({
                "name": f"pair_attention_{name}{kind}_pajigsaw{suffix}", "route": "cuda",
                "source": source, "replaces": replaces,
                "launches": by_shape(train_shapes, f"{name}{kind}", n_q, n_k, PJS_BATCH),
                "max_abs_err": err[(tag, name + ("_bwd" if kind else ""))],
                **times[(tag, name + kind)]})
    for name, n_q, n_k in (("kv_shared", 1025, 1024), ("qkv", 1025, 1025),
                           ("qkv_cls", 1, 1025)):
        rows.append({
            "name": f"pair_attention_{name}_pajigsaw_dense", "route": "cuda",
            "source": SOURCE, "replaces": REPLACES[name],
            "launches": by_shape(eval_shapes_run, name, n_q, n_k, PJS_CHUNK),
            "max_abs_err": err[("dense", name)], **times[("dense", name)]})
    return rows, lrf_shapes


# ---------------------------------------------------------------------------
# slice 11: the one-process sharded test path, int8 scoring, explainability
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12    # H100 SXM dense int8
# the int8 GEMMs of one 64-pair scan chunk at patch16_512: (M, K, N)
INT8_CHUNK = 64 * 1025
INT8_SHAPES = ((INT8_CHUNK, 384, 1152), (INT8_CHUNK, 384, 768), (INT8_CHUNK, 384, 384),
               (INT8_CHUNK, 384, 1536), (INT8_CHUNK, 1536, 384),
               (64, 384, 384), (64, 384, 1536), (64, 1536, 384),
               (12, 384, 384), (12, 384, 1536), (12, 1536, 384))
SHARDED_OPTS = ("TPU.SHARDED_EVAL_METRICS", "True", "TPU.EVAL_SLAB_ON_DISK", "True")
# the entry in a subprocess: runs ``main``, then prints one JSON line with
# the scan's numbers, the peak of the host memory it allocated from Python
# (tracemalloc: numpy arrays and Python objects, not what CUDA or native
# libraries allocate) and the process's peak resident memory (VmHWM where
# /proc/self/status has it, else getrusage's ru_maxrss: the same counter),
# also as it stood before the entry ran
SCAN_CHILD = """
import json, resource, sys, tracemalloc
import torch
from vit_ed_tpu_torch.hisfrag import main
torch.ones(1, device="cuda").sum().item()
base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
tracemalloc.start()
metrics, rows, names, scorer = main(sys.argv[1:])
hwm = [int(l.split()[1]) for l in open("/proc/self/status") if l.startswith("VmHWM")]
print("SCAN_RESULT " + json.dumps({
    "traced_peak_bytes": tracemalloc.get_traced_memory()[1],
    "cuda_context_rss_kib": base,
    "metrics": [float(m) for m in metrics], "n": len(names),
    "pairs_done": scorer.pairs_done, "scan_seconds": scorer.scan_seconds,
    "token_cache_bytes": scorer._token_cache_bytes(len(names)),
    "peak_rss_kib": hwm[0] if hwm else resource.getrusage(resource.RUSAGE_SELF).ru_maxrss,
    "peak_rss_from": "VmHWM" if hwm else "ru_maxrss"}), flush=True)
"""


def hisfrag_test_argv(data, out, tag, *opts):
    return ["--cfg", FLAGSHIP_CFG, "--data-path", data, "--mode", "test",
            "--output", out, "--tag", tag, *(("--opts", *opts) if opts else ())]


def scan_child(argv, kill_at_markers=None, marker_dir=None, timeout=600):
    """``hisfrag --mode test`` in a subprocess. With ``kill_at_markers`` it
    gets SIGKILL once that many ``.done`` markers exist in ``marker_dir``.
    Returns (exit code, the SCAN_RESULT dict or None, output, seconds)."""
    import glob
    import signal
    import threading

    t0 = time.time()
    proc = subprocess.Popen([sys.executable, "-c", SCAN_CHILD, *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "PYTHONUNBUFFERED": "1"})
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        while proc.poll() is None:
            if time.time() - t0 > timeout:
                proc.kill()
                break
            if kill_at_markers and len(glob.glob(os.path.join(
                    marker_dir, "*.done"))) >= kill_at_markers:
                proc.send_signal(signal.SIGKILL)
                break
            time.sleep(0.05)
        rc = proc.wait()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join()
    result = next((json.loads(x.split("SCAN_RESULT ", 1)[1]) for x in lines
                   if x.startswith("SCAN_RESULT ")), None)
    return rc, result, "".join(lines), time.time() - t0


def read_npz_slab(out_dir, n):
    """The upper-triangle rows the assembled scan wrote as .npz blocks."""
    import glob

    slab = np.zeros((n, n), np.float16)
    for path in glob.glob(os.path.join(out_dir, "test_rank0_rows*.npz")):
        start = int(path.rsplit("rows", 1)[1].split(".")[0])
        scores = np.load(path)["scores"][..., 0]
        slab[start:start + len(scores)] = scores
    return slab


def phase_sharded(tmp, scan5):
    """19a-c: the sharded test path on phase 5's corpus, the scan at N = 256
    with the slab on disk, and a killed scan resumed at N = 128."""
    import glob

    from vit_ed_tpu_torch.hisfrag import main

    card = card_line()
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    print("== phase 19a: python -m vit_ed_tpu_torch.hisfrag --mode test --opts "
          "TPU.SHARDED_EVAL_METRICS True TPU.EVAL_SLAB_ON_DISK True, phase 5's corpus",
          flush=True)
    A.reset_launch_counts()
    metrics, rows, names, scorer = main(hisfrag_test_argv(data, out, "sharded", *SHARDED_OPTS))
    counts = {name: A.launches[name] for name in MAIN_PATH}
    run_dir = os.path.join(out, "hisfrag20_patch16_512", "sharded")
    n = len(names)
    upper = read_npz_slab(os.path.join(out, "hisfrag20_patch16_512", "smoke"), n)
    iu = np.triu_indices(n)
    same_rows = (isinstance(rows, np.memmap) and np.array_equal(rows[iu], upper[iu])
                 and np.array_equal(rows, rows.T))
    same_dm = np.array_equal((1.0 - rows.astype(np.float32)).astype(np.float16), scan5["dm"])
    csvs = glob.glob(os.path.join(run_dir, "*.csv"))
    markers = glob.glob(os.path.join(run_dir, "*.done"))
    print(f"  {card}: mAP {metrics[0]:.6f} Top 1 {metrics[1]:.6f} Pr@k10 {metrics[2]:.6f} "
          f"Pr@k100 {metrics[3]:.6f} (phase 5: {[round(float(m), 6) for m in scan5['metrics']]}); "
          f"{scorer.pairs_done} pairs in {scorer.scan_seconds:.3f}s, "
          f"{scorer.pairs_done / scorer.scan_seconds:.1f} pairs/s (phase 5 "
          f"{scan5['rate']:.1f}); rows equal phase 5's .npz scores bit for bit {same_rows}, "
          f"distances equal phase 5's matrix {same_dm}; {len(markers)} .done markers, "
          f"CSVs written {csvs}; launches {counts}", flush=True)
    if not (same_rows and same_dm and not csvs and markers
            and [float(m) for m in metrics] == [float(m) for m in scan5["metrics"]]):
        raise AssertionError("the sharded test path differs from the assembled one")
    if not all(counts[name] > 0 for name in MAIN_PATH):
        raise AssertionError(f"the sharded scan did not launch every pair kernel: {counts}")
    del rows

    print("== phase 19b: the scan at N = 256, slab on disk, in a subprocess of the entry",
          flush=True)
    d256 = os.path.join(tmp, "data256")
    t0 = time.time()
    n256 = write_corpus(d256, writers=64, seed=7)
    wrote = time.time() - t0
    rc, res, log, secs = scan_child(hisfrag_test_argv(d256, out, "n256", *SHARDED_OPTS))
    if rc != 0 or res is None:
        print(log[-3000:])
        raise AssertionError(f"the N = {n256} scan failed (exit {rc})")
    dat = os.path.join(out, "hisfrag20_patch16_512", "n256", "test_rank0_slab.dat")
    print(f"  {card}: N = {res['n']} ({wrote:.1f}s to write the JPEGs), {res['pairs_done']} "
          f"pairs in {res['scan_seconds']:.3f}s: {res['pairs_done'] / res['scan_seconds']:.1f} "
          f"pairs/s; token cache {res['token_cache_bytes'] / 2**30:.4f} GiB; slab "
          f"{os.path.getsize(dat)} bytes on disk; host memory allocated from Python at its peak "
          f"{res['traced_peak_bytes'] / 2**20:.1f} MiB (tracemalloc); peak RSS "
          f"{res['peak_rss_kib'] / 2**20:.2f} GiB "
          f"({res['peak_rss_from']}; {res['cuda_context_rss_kib'] / 2**20:.2f} GiB after "
          f"importing the entry and starting CUDA); "
          f"the subprocess took {secs:.1f}s; mAP {res['metrics'][0]:.4f}", flush=True)
    if res["n"] != n256 or res["pairs_done"] != n256 * (n256 + 1) // 2 or not all(
            0.0 <= m <= 1.0 for m in res["metrics"]):
        raise AssertionError("the N = 256 scan did not cover its pairs")

    print("== phase 19c: SIGKILL the scan at N = 128 after two row blocks of 16, resume, "
          "and an uninterrupted scan", flush=True)
    # the first 32 writers of 19b's corpus
    d128 = os.path.join(tmp, "data128")
    os.makedirs(os.path.join(d128, "test"))
    for name in sorted(os.listdir(os.path.join(d256, "test")))[:128]:
        os.link(os.path.join(d256, "test", name), os.path.join(d128, "test", name))
    n128 = 128
    opts = SHARDED_OPTS + ("DATA.BATCH_SIZE", "16")
    kill_dir = os.path.join(out, "hisfrag20_patch16_512", "killed")
    rc, res, log, secs = scan_child(hisfrag_test_argv(d128, out, "killed", *opts),
                                    kill_at_markers=2, marker_dir=kill_dir)
    at_kill = len(glob.glob(os.path.join(kill_dir, "*.done")))
    if res is not None or rc != -9:
        raise AssertionError(f"the scan was not killed mid-way (exit {rc})")
    rc, res, log, secs2 = scan_child(hisfrag_test_argv(d128, out, "killed", *opts))
    resumed_blocks = log.count("complete on disk")
    if rc != 0 or res is None:
        print(log[-3000:])
        raise AssertionError(f"the resumed scan failed (exit {rc})")
    _m, full, _names, ref = main(hisfrag_test_argv(d128, out, "whole", *opts))
    killed = np.memmap(os.path.join(kill_dir, "test_rank0_slab.dat"), dtype=np.float16,
                       mode="r", shape=(n128, n128, 1))[..., 0]
    same = np.array_equal(killed, full)
    print(f"  {card}: killed (SIGKILL) after {secs:.1f}s with {at_kill} "
          f"blocks marked; the rerun skipped {resumed_blocks} and scored "
          f"{res['pairs_done']} of {n128 * (n128 + 1) // 2} pairs in {secs2:.1f}s; the "
          f"uninterrupted scan {ref.pairs_done / ref.scan_seconds:.1f} pairs/s; resumed slab "
          f"equals the uninterrupted one bit for bit {same}", flush=True)
    if not (same and at_kill >= 2 and resumed_blocks >= 2
            and res["pairs_done"] < n128 * (n128 + 1) // 2
            and [float(m) for m in _m] == res["metrics"]):
        raise AssertionError("the resumed scan differs from the uninterrupted one")
    del killed, full


def int8_bound(m, k, n):
    """(bound_ms, bound_by) of the int8 product: 2 M K N operations at the
    int8 peak, or the int8 operands read and the int32 result written."""
    t_ops = 2 * m * k * n / PEAK_INT8_OPS
    t_bytes = (m * k + n * k + 4 * m * n) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def phase_int8_gemm(gen):
    """19d: the int8 GEMM at a scan chunk's shapes, card against CPU bit for
    bit in f32 and bf16, timed against the port's bf16 Linear."""
    from vit_ed_tpu_torch.models.layers import Linear

    card = card_line()
    print(f"== phase 19d: the int8 GEMM (ops/quant.py, torch._int_mm) at a 64-pair "
          f"chunk's shapes, card against CPU, on {card}", flush=True)
    rows = []
    for m, k, n in INT8_SHAPES:
        same = []
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((m, k), generator=gen, device="cuda") * 3).to(dtype)
            w = torch.randn((n, k), generator=gen, device="cuda") * 0.05
            b = torch.randn((n,), generator=gen, device="cuda") * 0.01
            with torch.inference_mode():
                got = Q.int8_matmul(x, w, b)
                ref = Q.int8_matmul(x.cpu(), w.cpu(), b.cpu())
            same.append(torch.equal(got.cpu(), ref))
            del got, ref
        lin = Linear(k, n).cuda()
        with torch.inference_mode():
            wq, sw, aw = Q.quantize_weight(lin.weight)
            xq, _ = Q.quantize_rows(x)
            r = {"shape": f"M={m} K={k} N={n}",
                 "ms": timed(lambda: Q.int8_mm(xq, wq), n=10, inner=3),
                 "int8_linear_ms": timed(lambda: Q.int8_linear(x, wq, sw, aw, lin.bias),
                                         n=10, inner=3),
                 "bf16_matmul_ms": timed(lambda: torch.matmul(x, lin.weight.to(x.dtype).t()),
                                         n=10, inner=3),
                 "bf16_linear_ms": timed(lambda: lin(x), n=10, inner=3)}
        r["bound_ms"], r["bound_by"] = int8_bound(m, k, n)
        r["card_equals_cpu"] = same
        rows.append(r)
        print(f"  {r['shape']}: card == CPU bit for bit (f32, bf16) {same}; int8 product "
              f"{r['ms']:.4f} ms (bound {r['bound_ms']:.4f} {r['bound_by']}), with quantize "
              f"and epilogue {r['int8_linear_ms']:.4f}; bf16 product {r['bf16_matmul_ms']:.4f}, "
              f"bf16 Linear {r['bf16_linear_ms']:.4f}", flush=True)
        if not all(same):
            raise AssertionError(f"the int8 GEMM differs card against CPU at {r['shape']}")
        del x, w, b, lin, xq, wq
    torch.cuda.empty_cache()
    # one 64-pair score_tokens_row chunk with the int8 route on: the GEMMs'
    # launches by shape, where its device time goes (phase 4's inputs), and
    # the GEMM kernels its int8 products ran (int8 in their names: s8, i8,
    # imma; the profiler saw nothing of a lone product late in the run)
    config = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=None))
    torch.manual_seed(0)
    model = build_model(config, torch.device("cuda")).eval()
    imgs = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 512, 512, 3)).astype(np.float32)).cuda()
    with torch.inference_mode(), Q.int8_gemms(model):
        kv_row = model.context_kv_cache(model.encode(imgs[:1]))
        adv = model.prepare_x2_scan(imgs[1:]).index_select(
            0, torch.arange(64, device="cuda") % 2)
        Q.reset_launch_counts()
        model.score_tokens_row(kv_row, adv)
        torch.cuda.synchronize()
        per_chunk = dict(Q.launches_by_shape)
        print(f"  int8 GEMMs of one 64-pair score_tokens_row chunk (M, K, N): "
              f"{sorted(per_chunk.items())}", flush=True)
        prof_rows = chunk_breakdown(model, kv_row, adv)
    del model, kv_row, adv, imgs
    torch.cuda.empty_cache()
    names = [key for key, _t, _n in prof_rows if "gemm" in key.lower()
             and re.search(r"(^|[^a-z])(s8|i8|imma|int8)", key.lower())]
    print(f"  the int8 products' kernels (profiler): {names}", flush=True)
    if not names:
        raise AssertionError("the profiler saw no int8 kernel in the int8 chunk")
    for r in rows:
        m, k, n = (int(v.split("=")[1]) for v in r["shape"].split())
        r["launches_per_chunk"] = per_chunk.get((m, k, n), 0)
    return rows, names


def phase_int8_scan(tmp, scan5):
    """19e: the scan at N = 64 with TPU.INT8_SCORE, against phase 5's."""
    from vit_ed_tpu_torch.hisfrag import main

    card = card_line()
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    print("== phase 19e: python -m vit_ed_tpu_torch.hisfrag --mode test --opts "
          "TPU.INT8_SCORE True, phase 5's corpus", flush=True)
    A.reset_launch_counts()
    Q.reset_launch_counts()
    metrics, dm, names, scorer = main(hisfrag_test_argv(data, out, "int8",
                                                        "TPU.INT8_SCORE", "True"))
    torch.cuda.synchronize()
    counts = {name: A.launches[name] for name in MAIN_PATH}
    gemms = Q.launches["int8_gemm"]
    gap = float(np.abs(dm.astype(np.float32) - scan5["dm"].astype(np.float32)).max())
    rate = scorer.pairs_done / scorer.scan_seconds
    print(f"  {card}: int8 {rate:.1f} pairs/s against bf16 {scan5['rate']:.1f} (phase 5); "
          f"mAP int8 {metrics[0]:.6f} against bf16 {scan5['metrics'][0]:.6f}; max |int8 - bf16| "
          f"score {gap:.4f} (tol 0.25); pair kernel launches {counts}, int8 GEMMs {gemms}; "
          f"by shape (M, K, N) {sorted(Q.launches_by_shape.items())}", flush=True)
    if not (gap < 0.25 and np.isfinite(dm.astype(np.float32)).all()):
        raise AssertionError("int8 scores stray from bf16")
    if not (all(counts[name] > 0 for name in MAIN_PATH) and gemms > 0):
        raise AssertionError("the int8 scan did not launch the pair kernels and int8 GEMMs")
    return {"rate": rate, "metrics": [float(m) for m in metrics],
            "gemms_per_shape": dict(Q.launches_by_shape)}


def phase_int8_eval(tmp, ckpt_path, eval15):
    """19f: the puzzle evaluation with TPU.INT8_SCORE on one of phase 15's
    puzzles: the 4-D kernels and the int8 GEMMs launched."""
    import shutil

    from vit_ed_tpu_torch import evaluation

    print("== phase 19f: python -m vit_ed_tpu_torch.evaluation --opts TPU.INT8_SCORE True "
          f"on phase 15's {EVAL_SUBSETS[0]}/{EVAL_FILES[0]}", flush=True)
    data, work = os.path.join(tmp, "puzzles_int8"), os.path.join(tmp, "eval_int8_cwd")
    os.makedirs(os.path.join(data, EVAL_SUBSETS[0]))
    os.makedirs(work)
    shutil.copy(os.path.join(tmp, "puzzles", EVAL_SUBSETS[0], EVAL_FILES[0]),
                os.path.join(data, EVAL_SUBSETS[0], EVAL_FILES[0]))
    argv = ["--cfg", EVAL_CFG, "--data-path", data, "--pretrained", ckpt_path,
            "--output", os.path.join(tmp, "out"), "--tag", "eval_int8",
            "--opts", "TPU.INT8_SCORE", "True"]
    cwd = os.getcwd()
    os.chdir(work)
    A.reset_launch_counts()
    Q.reset_launch_counts()
    try:
        records = evaluation.main(argv)
    finally:
        os.chdir(cwd)
    torch.cuda.synchronize()
    heads = {k: v for k, v in nonzero(A.launches).items() if k.startswith("heads_")}
    gemms = Q.launches["int8_gemm"]
    (rec,) = records
    result, perfect = rec["results"]
    acc = {k: round(float(v[0]), 4) for k, v in result.items()}
    print(f"  {card_line()}: int8 score_dense {rec['pairs'] / rec['seconds']['score']:.1f} "
          f"pairs/s (bf16, phase 15: {eval15['rate']:.1f}); accuracies {acc}, Perfect "
          f"{perfect} (bf16, phase 15: {eval15['accuracies']}); 4-D launches {heads}; "
          f"int8 GEMMs {gemms}", flush=True)
    if not (heads.get("heads_kv_shared") and heads.get("heads_qkv") and gemms > 0
            and np.isfinite(rec["distances"]).all()):
        raise AssertionError("the int8 evaluation did not launch the 4-D kernels and "
                             "int8 GEMMs")


def phase_explain(tmp):
    """19g: generate_relevance at full width on one pair, card against CPU,
    and a keep_attn forward against the fused one."""
    from vit_ed_tpu_torch.ops.explain import generate_relevance

    print("== phase 19g: ops/explain.py generate_relevance at pjs-S patch16_512 (one pair, "
          "f32), card against CPU; keep_attn against the fused forward", flush=True)
    config = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=None))
    torch.manual_seed(config.SEED)
    model = build_model(config).eval()
    ds = HisFrag20Test(os.path.join(tmp, "data"), Split.TEST, transform=OneImgEval(512, crop=True))
    x_pair = np.stack([ds[0][0], ds[5][0]])[None]
    pjs = config.MODEL.PJS
    args = (x_pair, pjs.PATCH_SIZE, pjs.NUM_HEADS, pjs.DEPTH, pjs.C_DEPTH)
    t0 = time.time()
    card = generate_relevance(model, *args, device="cuda")
    t1 = time.time()
    cpu = generate_relevance(model, *args, device="cpu")
    t2 = time.time()
    err = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"  relevance {card.shape}: card {t1 - t0:.1f}s, CPU {t2 - t1:.1f}s; max |card - CPU| "
          f"{err:.3e} of the max {np.abs(cpu).max():.4e} (tol 1e-3)", flush=True)
    if not (card.shape == (1024, 1024) and np.isfinite(card).all() and err <= 1e-3):
        raise AssertionError("generate_relevance disagrees card against CPU")

    sd = model.state_dict()
    kept = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=["MODEL.PJS.KEEP_ATTN", "True"]))
    readings = {}
    x = torch.from_numpy(np.stack([np.stack([ds[i][0], ds[j][0]]) for i, j in ((0, 5), (3, 17))]))
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        outs = []
        for cfg in (config, kept):
            m = build_model(cfg, torch.device("cuda")).eval()
            m.load_state_dict(sd)
            m.dtype = dtype
            with torch.inference_mode():
                outs.append(m(x.cuda()).float().cpu())
            maps = m.attention_maps()
            del m
        readings[str(dtype)] = float((outs[1] - outs[0]).abs().max() / outs[0].abs().max())
        if not readings[str(dtype)] <= tol:
            raise AssertionError(f"keep_attn differs from the fused forward in {dtype}")
    print(f"  keep_attn against fused logits, max |diff| / max: {readings} (tol f32 1e-3, "
          f"bf16 5e-2); {len(maps)} maps kept, the last decoder block's "
          f"{tuple(maps['cross_blocks.11.attn'].shape)}", flush=True)
    if len(maps) != 36:
        raise AssertionError("keep_attn did not keep every map")
    torch.cuda.empty_cache()


def phase_slice11(tmp, gen, scan5, eval15, puzzle_ckpt):
    """Phase 19. Returns the int8 GEMM's rows."""
    t0 = time.time()
    phase_sharded(tmp, scan5)
    rows, names = phase_int8_gemm(gen)
    int8_scan = phase_int8_scan(tmp, scan5)
    phase_int8_eval(tmp, puzzle_ckpt, eval15)
    phase_explain(tmp)
    print(f"  phase 19 took {time.time() - t0:.1f}s", flush=True)
    print("  int8 GEMM rows: " + json.dumps({
        "kernels_seen": names, "scan_launches": {
            f"M={m} K={k} N={n}": c for (m, k, n), c in
            int8_scan["gemms_per_shape"].items()}, "rows": rows}), flush=True)
    return rows


# ---------------------------------------------------------------------------
# slice 12: the serving tier (phase 20) and MoE on one card (phase 21)
# ---------------------------------------------------------------------------

# one pair forward at depth 12 + 12 with the CLS short-circuit: 12 encoder
# and 11 decoder self-attentions, the CLS row's, and 12 cross-attentions
PAIR_LAUNCHES = {"qkv": 23, "qkv_cls": 1, "kv": 12}
SERVE_BATCHES = (1, 7, 64)
SERVE_THREADS, SERVE_REQUESTS = 8, 16     # client threads x requests of 1-4 pairs
MOE_CFG = os.path.join(ROOT, "configs", "scale", "hisfrag20_pjsL_moe_hybrid.yaml")
# the one-card configuration: the file with its mesh and its TP / SP / EP /
# FSDP switches turned off; every width kept
MOE_ONE_CARD = ("TPU.MESH_SHAPE", "[]", "TPU.MESH_AXES", "[]",
                "TPU.TENSOR_PARALLEL", "False", "TPU.SEQ_PARALLEL", "False",
                "TPU.EXPERT_PARALLEL", "False", "TPU.FSDP", "False")
MOE_BATCH = 8           # images per update: what fits pjs-L MoE on one card
MOE_STEPS = 5
# the entry, the upcycling and the export at 2 + 2 blocks (the bank on
# encoder block 1): the full depth's checkpoint would write ~17 GB twice
MOE_SHORT = ("MODEL.PJS.DEPTH", "2", "MODEL.PJS.C_DEPTH", "2")


def dispatch_cost(gen):
    """Host microseconds per call of the pair forward, straight and through
    the registered operator (``torch.ops.vit_ed.pair_forward``), at a shape
    whose kernel is shorter than its launch (CLS row, B = 1): the
    dispatcher's cost per launch, read on the host clock over 500 calls."""
    qkv = torch.randn((1, 1025, 3 * C), generator=gen, device="cuda").bfloat16()
    scale = 1.0 / math.sqrt(D)
    calls = {"direct": lambda: A._forward("qkv_cls", (qkv,), H, scale),
             "operator": lambda: A.pair_forward_op([qkv], "qkv_cls", H, scale)}
    if not torch.equal(calls["direct"](), calls["operator"]()):
        raise AssertionError("the operator and the direct launch differ")
    us = {}
    for _ in range(2):                   # the second round is the reading
        for name, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            torch.cuda.synchronize()
            us[name] = (time.perf_counter() - t0) / 500 * 1e6
    print(f"  dispatch per launch (qkv_cls, B=1, 500 calls, host clock): direct "
          f"{us['direct']:.1f} us, through torch.ops.vit_ed.pair_forward "
          f"{us['operator']:.1f} us: +{us['operator'] - us['direct']:.1f} us per "
          f"launch", flush=True)
    return us


def replay_vs_live(model, scorer, stage, x, want=None):
    """One replay of ``stage`` against the live forward on ``x``: bit
    equality, max |diff|, the launches of each (reset before, read after)
    and their device ms (CUDA events)."""
    runs = {}
    for name, fn in (("live", lambda: model(x)), ("replay", lambda: scorer(stage, x))):
        A.reset_launch_counts()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            a.record()
            out = fn()
            b.record()
        torch.cuda.synchronize()
        runs[name] = (out, nonzero(A.launches), a.elapsed_time(b))
    (live, n_live, ms_live), (got, n_got, ms_got) = runs["live"], runs["replay"]
    diff = float((got.float() - live.float()).abs().max())
    equal = torch.equal(got, live)
    print(f"  {stage} B={x.shape[0]}: replay {'equal to' if equal else 'differs from'} "
          f"the live forward bit for bit (max |diff| {diff:.3e}, bound 2e-3); "
          f"{ms_got:.2f} ms replay / {ms_live:.2f} ms live (first-call device "
          f"time); launches replay {n_got} live {n_live}", flush=True)
    if n_got != n_live or (want is not None and n_got != want):
        raise AssertionError(f"the replay's launches {n_got} are not the live "
                             f"forward's {n_live} (expected {want})")
    if not (diff <= 2e-3 and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{stage} replay differs from the live forward by {diff}")
    return {"equal": equal, "max_abs_diff": diff}


def serve_load(url, stage, xs, threads=SERVE_THREADS, n=SERVE_REQUESTS):
    """``threads`` clients x ``n`` requests each (request i of a thread sends
    ``xs[i % len(xs)]``) -> (per-request seconds, wall seconds, pairs,
    the responses of the first thread)."""
    import threading

    from vit_ed_tpu_torch.serve import ServeClient

    lat, first, errors = [], {}, []
    lock = threading.Lock()

    def client(t):
        c = ServeClient(url, timeout=600)
        for i in range(n):
            x = xs[(i + t) % len(xs)]
            t0 = time.perf_counter()
            try:
                out = c.stage(stage, x)
            except Exception as e:  # noqa: BLE001 — raised below, after join
                errors.append(e)
                return
            with lock:
                lat.append(time.perf_counter() - t0)
                if t == 0:
                    first[(i + t) % len(xs)] = out

    workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
    t0 = time.perf_counter()
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    pairs = sum(len(xs[(i + t) % len(xs)]) for t in range(threads) for i in range(n))
    return np.asarray(lat), wall, pairs, first


def phase_serve(tmp, scan5, gen):
    """Phase 20. The serving tier at pjs-S patch16_512 bf16, weights from a
    seed."""
    from vit_ed_tpu_torch import export_serving
    from vit_ed_tpu_torch.serve import BundleServer, export_scorer, load_scorer, scan_pairs

    print("== phase 20: the serving tier (vit_ed_tpu_torch.serve) at pjs-S "
          "patch16_512, bf16, weights from seed 0", flush=True)
    t_phase = time.time()
    res = {"dispatch_us": dispatch_cost(gen)}
    config = get_config(types.SimpleNamespace(cfg=FLAGSHIP_CFG, opts=None))
    torch.manual_seed(config.SEED)
    model = build_model(config, torch.device("cuda")).eval()

    # (a) every stage, symbolic batch, exported on the card
    out = os.path.join(tmp, "bundle")
    t0 = time.time()
    meta = export_scorer(model, None, out)
    res["export_s"] = time.time() - t0
    sizes = {f: os.path.getsize(os.path.join(out, f)) for f in sorted(os.listdir(out))}
    t0 = time.time()
    scorer = load_scorer(out)
    res["load_s"] = time.time() - t0
    res["bundle_bytes"] = sum(sizes.values())
    print(f"  (a) exported {sorted(meta['stages'])} on {meta['stages']['pair'][0]['device']} "
          f"in {res['export_s']:.1f}s; bundle {res['bundle_bytes'] / 2**20:.1f} MiB: "
          + ", ".join(f"{f} {s / 2**20:.2f}" for f, s in sizes.items())
          + f" MiB; loaded in {res['load_s']:.1f}s", flush=True)
    if sizes["weights.pt"] < 0.9 * res["bundle_bytes"]:
        raise AssertionError("the artifacts carry weights of their own")

    # (b) the pair stage replayed against the live model
    res["pair"] = {}
    for b in SERVE_BATCHES:
        x = torch.randn((b, 2, 512, 512, 3), generator=gen, device="cuda")
        res["pair"][b] = replay_vs_live(model, scorer, "pair", x, PAIR_LAUNCHES)
        del x
    torch.cuda.empty_cache()

    # (c) the headless scan over phase 5's corpus against phase 5's matrix
    ds = HisFrag20Test(os.path.join(tmp, "data"), Split.TEST,
                       transform=OneImgEval(512, crop=True))
    imgs = np.stack([ds[i][0] for i in range(len(ds))])
    n = len(imgs)
    A.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    sim = scan_pairs(scorer, imgs, batch_size=64)
    secs = time.time() - t0
    counts = nonzero(A.launches)
    gap = float(np.abs((1.0 - sim.astype(np.float32)) - scan5["dm"].astype(np.float32)).max())
    res["scan_rate"] = n * (n + 1) / 2 / secs
    print(f"  (c) scan_pairs over phase 5's {n} images: {n * (n + 1) // 2} pairs in "
          f"{secs:.3f}s = {res['scan_rate']:.1f} pairs/s (phase 5's scorer: "
          f"{scan5['rate']:.1f}; host-to-device copies of the images included); "
          f"max |1 - score - phase 5's distance| {gap:.3e} (tol 1e-2); launches "
          f"{counts}", flush=True)
    if gap > 1e-2 or not all(counts.get(k, 0) > 0 for k in MAIN_PATH):
        raise AssertionError("the bundle's scan differs from phase 5's or skipped a kernel")

    # (d) the HTTP host on localhost: concurrent clients, coalesced batches
    rng = np.random.default_rng(20)
    xs = [imgs[rng.integers(0, n, size=(k, 2))] for k in (1, 2, 3, 4)]
    server = BundleServer(scorer, batch_stages=("pair", "pair_u8"), max_batch=64,
                          max_wait_ms=5.0)
    server.start()
    try:
        res["http"] = {}
        for stage, wire in (("pair", xs),
                            ("pair_u8", [((x * 0.5 + 0.5) * 255).round().clip(0, 255)
                                         .astype(np.uint8) for x in xs])):
            before = dict(server.stats()["batched"][stage])
            lat, wall, pairs, first = serve_load(server.url, stage, wire)
            after = server.stats()["batched"][stage]
            calls = after["device_calls"] - before["device_calls"]
            reqs = after["requests"] - before["requests"]
            r = {"requests_s": len(lat) / wall, "pairs_s": pairs / wall,
                 "device_calls": calls, "requests": reqs,
                 "p50_ms": float(np.percentile(lat, 50) * 1e3),
                 "p99_ms": float(np.percentile(lat, 99) * 1e3)}
            res["http"][stage] = r
            worst = max(float(np.abs(first[i] - scorer(stage, wire[i]).float().cpu().numpy()).max())
                        for i in first)
            print(f"  (d) {stage} over HTTP ({SERVE_THREADS} threads x {SERVE_REQUESTS} "
                  f"requests of 1-4 pairs, {'float32' if stage == 'pair' else 'uint8'} "
                  f"wire): {r['requests_s']:.1f} requests/s, {r['pairs_s']:.1f} pairs/s, "
                  f"{calls} device calls for {reqs} requests, latency p50 "
                  f"{r['p50_ms']:.1f} ms p99 {r['p99_ms']:.1f} ms; responses against "
                  f"a direct replay max |diff| {worst:.3e} (tol 1e-2)", flush=True)
            if reqs != SERVE_THREADS * SERVE_REQUESTS or calls > reqs or worst > 1e-2:
                raise AssertionError(f"the HTTP host served {reqs} requests in {calls} "
                                     f"calls, worst gap {worst}")
    finally:
        server.shutdown()
    del scorer, imgs
    torch.cuda.empty_cache()

    # (e) a bucketed bundle through the export entry, verified on the card;
    # (f) meanwhile the host's own entry starts in a child process on (a)'s
    # bundle (its start-up overlaps the export)
    child = serve_cli_start(out)
    try:
        out_b = os.path.join(tmp, "bundle_b")
        t0 = time.time()
        meta_b = export_serving.main(["--cfg", FLAGSHIP_CFG, "--output", out_b,
                                      "--batch-sizes", "8,64", "--verify"])
        res["bucketed_s"] = time.time() - t0
        print(f"  (e) python -m vit_ed_tpu_torch.export_serving --batch-sizes 8,64 "
              f"--verify: {sum(len(v) for v in meta_b['stages'].values())} artifacts "
              f"(buckets {meta_b['batch_mode']}), export and verify "
              f"{res['bucketed_s']:.1f}s", flush=True)
        if meta_b["batch_mode"] != [8, 64]:
            raise AssertionError(f"buckets {meta_b['batch_mode']}")
        res["cli"] = serve_cli_check(*child, model, xs[1])
    finally:
        serve_cli_stop(child[0])
    del model
    torch.cuda.empty_cache()
    print(f"  phase 20 took {time.time() - t_phase:.1f}s", flush=True)
    return res


def serve_cli_start(bundle):
    """Start ``python -m vit_ed_tpu_torch.serve --bundle <bundle> --port 0``
    as a child process: (the process, its start time)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "vit_ed_tpu_torch.serve", "--bundle", bundle,
         "--port", "0"], cwd=ROOT, stdout=subprocess.PIPE, text=True)
    return proc, time.time()


def serve_cli_check(proc, t0, model, x):
    """Wait for the child's ``serving ... on <url>`` line, then one
    ``/v1/score`` of ``x`` against the live model."""
    import select

    from vit_ed_tpu_torch.serve import ServeClient

    line = ""
    while " on http://" not in line and time.time() - t0 < 300:
        ready, _, _ = select.select([proc.stdout], [], [], 300)
        line = proc.stdout.readline() if ready else ""
        if not line and proc.poll() is not None:
            break
    if " on http://" not in line:
        raise AssertionError(f"the serving host did not start: {line!r}")
    up = time.time() - t0
    got = ServeClient(line.strip().rsplit(" on ", 1)[1], timeout=300).score(x)
    with torch.inference_mode():
        want = model(torch.from_numpy(x).cuda()).float().cpu().numpy()
    gap = float(np.abs(got - want).max())
    print(f"  (f) python -m vit_ed_tpu_torch.serve --bundle <(a)'s bundle>: serving "
          f"within {up:.1f}s of its start (it started with (e)); /v1/score of "
          f"{len(x)} pairs against the live model max |diff| {gap:.3e} (tol 2e-3)",
          flush=True)
    if gap > 2e-3:
        raise AssertionError("the serving host's scores differ from the live model")
    return {"up_s": up, "max_abs_diff": gap}


def serve_cli_stop(proc):
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


def moe_argv(data, out, tag, *extra, opts=()):
    return ["--cfg", MOE_CFG, "--data-path", data, "--mode", "train", "--output", out,
            "--tag", tag, "--batch-size", str(MOE_BATCH), *extra, "--opts",
            *MOE_ONE_CARD, "TRAIN.AUTO_RESUME", "False", *opts]


def moe_bank_count(model):
    from vit_ed_tpu_torch.models.moe import MoeMlp

    return sum(isinstance(m, MoeMlp) for m in model.modules())


def phase_moe_full(tmp):
    """Phase 21a: the full-depth one-card pjs-L MoE configuration, trained
    MOE_STEPS updates through the hisfrag trainer's own step."""
    from vit_ed_tpu_torch.hisfrag import HisfragTrainer, parse_option

    data = os.path.join(tmp, "train_data")              # phase 9's corpus
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    trainer = HisfragTrainer(parse_option(moe_argv(data, os.path.join(tmp, "out"),
                                                   "moe_full")))
    model = trainer.model
    n_params = sum(p.numel() for p in model.parameters())
    pjs = trainer.config.MODEL.PJS
    print(f"  (a) {n_params / 1e9:.3f} B parameters (embed {pjs.EMBED_DIM}, "
          f"{pjs.NUM_HEADS} heads, {pjs.DEPTH} + {pjs.C_DEPTH} blocks, "
          f"{moe_bank_count(model)} banks of {pjs.MOE.EXPERTS} experts, top-"
          f"{pjs.MOE.ROUTE_K}, jitter {pjs.MOE.JITTER}), built in "
          f"{time.time() - t0:.1f}s", flush=True)
    loader = trainer.get_dataloader("train")
    trainer.setup_training(len(loader))
    A.reset_launch_counts()
    steps = []
    it = iter(loader)
    for _ in range(MOE_STEPS):
        samples, targets = next(it)
        micro = [trainer.prepare_data(samples, targets)]
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.time()
        a.record()
        loss, norm = trainer.train_step(micro)
        b.record()
        torch.cuda.synchronize()
        lb, z = trainer.moe_aux.float().mean(0).tolist()
        steps.append({"ms": (time.time() - t0) * 1e3, "device_ms": a.elapsed_time(b),
                      "loss": loss.item(), "grad_norm": norm.item(), "lb": lb, "z": z,
                      "pairs": int(micro[0]["pair_mask"].sum()),
                      "flops": trainer.step_model_flops(micro)})
    counts = nonzero(A.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    timed_steps = steps[1:]                     # the first warms cuBLAS up
    step_s = float(np.median([s["ms"] for s in timed_steps])) / 1e3
    mfu = trainer._log_mfu(step_s, float(np.mean([s["flops"] for s in timed_steps])), "pjs")
    print(f"  (a) {MOE_STEPS} updates of {MOE_BATCH} images -> "
          f"{[s['pairs'] for s in steps]} live pairs: step {step_s * 1e3:.1f} ms median "
          f"(host clock, batch copy included; first {steps[0]['ms']:.1f}), device "
          f"{np.median([s['device_ms'] for s in timed_steps]):.1f} ms (CUDA events); peak "
          f"device memory {peak:.2f} GiB", flush=True)
    print(f"  (a) loss {[round(s['loss'], 4) for s in steps]}; grad_norm "
          f"{[round(s['grad_norm'], 3) for s in steps]}; mean load balance "
          f"{[round(s['lb'], 4) for s in steps]}; mean router z "
          f"{[round(s['z'], 3) for s in steps]}", flush=True)
    print(f"  (a) {mfu}", flush=True)
    print(f"  (a) launches over the {MOE_STEPS} updates: {counts}", flush=True)
    for s in steps:
        if not all(np.isfinite(s[k]) and s[k] > 0 for k in ("loss", "grad_norm", "lb", "z")):
            raise AssertionError(f"MoE step not finite: {s}")
    for name in TRAIN_PATH_FWD + TRAIN_PATH_BWD:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the MoE training step never launched {name}")
    res = {"params": n_params, "step_ms": step_s * 1e3, "peak_gib": peak,
           "device_ms": float(np.median([s["device_ms"] for s in timed_steps])),
           "mfu": mfu, "launches": counts}
    del it
    res["breakdown"] = step_breakdown(trainer)
    del trainer, model, loader
    torch.cuda.empty_cache()
    return res


def phase_moe_entry(tmp):
    """Phase 21a (the entry), b, c at MOE_SHORT's depth."""
    from vit_ed_tpu_torch import hisfrag
    from vit_ed_tpu_torch.serve import export_scorer, load_scorer
    from vit_ed_tpu_torch.utils import set_seed

    data = os.path.join(tmp, "train_data")
    A.reset_launch_counts()
    t0 = time.time()
    trainer = hisfrag.main(moe_argv(data, os.path.join(tmp, "out"), "moe_entry", opts=(
        *MOE_SHORT, "TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "2")))
    torch.cuda.synchronize()
    counts = nonzero(A.launches)
    lb, z = trainer.moe_aux.float().mean(0).tolist()
    print(f"  (a) python -m vit_ed_tpu_torch.hisfrag --mode train at 2 + 2 blocks: "
          f"{trainer.step} updates, val loss {trainer.min_loss:.4f}, last aux terms "
          f"load balance {lb:.4f} router z {z:.3f}; {time.time() - t0:.1f}s with two "
          f"validates and the checkpoints; launches {counts}", flush=True)
    if trainer.step < 3 or not np.isfinite(trainer.min_loss) or not np.isfinite(lb):
        raise AssertionError("the MoE entry did not train")
    for name in TRAIN_PATH_FWD + TRAIN_PATH_BWD:
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the MoE entry never launched {name}")
    del trainer
    torch.cuda.empty_cache()

    # (b) a dense pjs-L checkpoint from a seed, upcycled by --pretrained
    dense_cfg = get_config(types.SimpleNamespace(
        cfg=MOE_CFG, opts=[*MOE_ONE_CARD, *MOE_SHORT, "MODEL.PJS.MOE.EXPERTS", "0"]))
    torch.manual_seed(1)
    dense = build_model(dense_cfg, torch.device("cuda"))
    path = os.path.join(tmp, "dense_pjsL.pth")
    torch.save({k: v.cpu() for k, v in dense.state_dict().items()}, path)
    trainer = hisfrag.HisfragTrainer(hisfrag.parse_option(moe_argv(
        data, os.path.join(tmp, "out"), "moe_upcycle", "--pretrained", path,
        opts=MOE_SHORT)))
    moe = trainer.model
    set_seed(trainer.config.SEED)
    fresh = build_model(trainer.config, torch.device("cuda"))
    banks = [(i, blk) for i, blk in enumerate(moe.blocks) if hasattr(blk.mlp, "w1")]
    same = all(
        torch.equal(blk.mlp.w1[e], dense.blocks[i].mlp.fc1.weight.t())
        and torch.equal(blk.mlp.b1[e], dense.blocks[i].mlp.fc1.bias)
        and torch.equal(blk.mlp.w2[e], dense.blocks[i].mlp.fc2.weight.t())
        and torch.equal(blk.mlp.b2[e], dense.blocks[i].mlp.fc2.bias)
        for i, blk in banks for e in range(blk.mlp.num_experts))
    routers = all(torch.equal(blk.mlp.router.weight, fresh.blocks[i].mlp.router.weight)
                  for i, blk in banks)
    dense_rest = torch.equal(moe.blocks[0].mlp.fc1.weight, dense.blocks[0].mlp.fc1.weight)
    print(f"  (b) dense pjs-L checkpoint (seed 1, 2 + 2 blocks) through --pretrained: "
          f"{len(banks)} bank(s) x {banks[0][1].mlp.num_experts} experts equal to their "
          f"block's fc1 / fc2 {same}; routers at their init {routers}; dense blocks "
          f"loaded {dense_rest}", flush=True)
    if not (banks and same and routers and dense_rest):
        raise AssertionError("sparse upcycling did not initialise the experts")
    del dense, fresh

    # (c) the upcycled model's pair stage, exported and replayed
    out = os.path.join(tmp, "bundle_moe")
    model = moe.eval()
    t0 = time.time()
    export_scorer(model, None, out, stages=("pair",))
    scorer = load_scorer(out)
    print(f"  (c) MoE pair stage exported in {time.time() - t0:.1f}s", flush=True)
    gen = torch.Generator("cuda").manual_seed(21)
    replay_vs_live(model, scorer, "pair", torch.randn((7, 2, 512, 512, 3), generator=gen,
                                                      device="cuda"))
    del trainer, moe, model, scorer
    torch.cuda.empty_cache()


def phase_moe(tmp):
    """Phase 21."""
    print(f"== phase 21: MoE on one card, the pjs-L MoE configuration "
          f"({os.path.relpath(MOE_CFG, ROOT)}) without its mesh, bf16, "
          f"{MOE_BATCH} images per update", flush=True)
    t0 = time.time()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  device memory held by earlier phases: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    res = phase_moe_full(tmp)
    phase_moe_entry(tmp)
    print(f"  phase 21 took {time.time() - t0:.1f}s", flush=True)
    return res


def phase_slice12(tmp, gen, scan5):
    """Phases 20 and 21."""
    serve = phase_serve(tmp, scan5, gen)
    moe = phase_moe(tmp)
    return serve, moe


# ---------------------------------------------------------------------------
# slice 13: several processes (phase 22)
# ---------------------------------------------------------------------------

MP_TIMEOUT = 60           # seconds: the group's bound on every collective
MP_SCAN_OPTS = ("DATA.BATCH_SIZE", "16")   # row blocks of 16: rank 1 holds three
MP_HISFRAG_BATCH, MP_DIV2K_BATCH = 8, 64   # per rank and update
MP_F32 = {"hisfrag": 4, "main": 64}        # per rank: the f32 update-1 check
MP_PAIR_KERNELS = tuple(f"{n}{k}" for n in ("qkv", "qkv_cls", "kv") for k in ("", "_dq", "_dkv"))
MP_HEADS_KERNELS = tuple(f"heads_{n}" for n in MP_PAIR_KERNELS)
_MP_PROCS = []


def param_digest(model):
    """sha256 of every parameter's bytes, in order: equal digests are equal
    parameters bit for bit."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def mp_f32_batch(kind, rank, n):
    """A seeded host batch of ``n`` items of rank ``rank`` at full size."""
    rng = np.random.default_rng(300 + rank)
    if kind == "hisfrag":
        return (rng.normal(size=(n, 512, 512, 3)).astype(np.float32),
                np.repeat(np.arange(n // 2), 2).astype(np.int32))
    return (rng.normal(size=(n, 2, 64, 64, 3)).astype(np.float32),
            (rng.random((n, 4)) > 0.5).astype(np.float32))


def rank_child(spec_path):
    """One rank of a phase-22 run (``python chip_smoke.py --rank-child
    <spec.json>``; WORLD_SIZE, RANK, LOCAL_RANK and MASTER_* from the
    environment): joins the gloo group, drives the entry's ``main(argv)``
    for each run of the spec with the launch counts reset before, and
    writes what it saw to ``spec['result']``. ``kill_at_block`` makes rank 1
    SIGKILL itself at that row block of a scan; ``f32`` adds one f32 update
    on a seeded batch, dumped for the parent's one-process reference."""
    import importlib
    import signal

    from vit_ed_tpu_torch.parallel import mesh
    from vit_ed_tpu_torch.parallel.pairs import PairwiseScorer

    with open(spec_path) as f:
        spec = json.load(f)
    mesh.maybe_init_distributed(backend="gloo", timeout=MP_TIMEOUT)
    rank = mesh.process_index()
    entry = importlib.import_module(f"vit_ed_tpu_torch.{spec['entry']}")
    cls = entry.HisfragTrainer if spec["entry"] == "hisfrag" else entry.DefaultTrainer
    blocks, steps, reduce_ms = [], [], []
    score_rows, train_step = PairwiseScorer.score_rows_block, cls.train_step
    allreduce_grads = cls._allreduce_grads

    def counted(self, *args, **kwargs):
        if rank == 1 and len(blocks) + 1 == spec.get("kill_at_block"):
            os.kill(os.getpid(), signal.SIGKILL)
        blocks.append(len(args[2]))
        return score_rows(self, *args, **kwargs)

    def timed_reduce(self, loss_sum):
        torch.cuda.synchronize()
        t0 = time.time()
        out = allreduce_grads(self, loss_sum)
        torch.cuda.synchronize()
        reduce_ms.append((time.time() - t0) * 1e3)
        return out

    def recorded(self, micro_batches):
        torch.cuda.synchronize()
        t0 = time.time()
        loss, norm = train_step(self, micro_batches)
        torch.cuda.synchronize()
        steps.append({"ms": (time.time() - t0) * 1e3, "reduce_ms": reduce_ms[-1],
                      "digest": param_digest(self.model), "loss": loss.item()})
        with open(spec["result"] + ".updates", "w") as f:   # the parent's SIGTERM cue
            f.write(str(len(steps)))
        return loss, norm

    PairwiseScorer.score_rows_block, cls.train_step = counted, recorded
    cls._allreduce_grads = timed_reduce
    result = {"rank": rank, "runs": []}
    for i, argv in enumerate(spec["runs"]):
        A.reset_launch_counts()
        blocks.clear()
        steps.clear()
        t0 = time.time()
        out = entry.main(argv)
        torch.cuda.synchronize()
        run = {"seconds": time.time() - t0, "launches": nonzero(A.launches),
               "blocks": len(blocks), "steps": list(steps)}
        if isinstance(out, tuple):      # hisfrag --mode test
            metrics, mat, _names, scorer = out
            np.save(f"{spec['result']}.{i}.npy", np.asarray(mat))
            run.update(metrics=[float(m) for m in metrics], pairs=scorer.pairs_done,
                       scan_seconds=scorer.scan_seconds,
                       row_range=[scorer.row_range.start, scorer.row_range.stop])
        else:
            run.update(step=out.step, preempted=out.preempted,
                       steps_per_epoch=len(out.get_dataloader("train")),
                       epochs=out.config.TRAIN.EPOCHS)
        result["runs"].append(run)
    if spec.get("f32"):
        f32 = spec["f32"]
        trainer = cls(entry.parse_option(f32["argv"]))
        trainer.setup_training(1)
        np.random.seed(rank)
        batch = trainer.prepare_data(*mp_f32_batch(spec["entry"], rank, f32["images"]))
        np.savez(f"{spec['result']}.f32batch.npz", **batch)
        trainer.train_step([batch])
        torch.save({n: p.detach().cpu() for n, p in trainer.model.named_parameters()},
                   f"{spec['result']}.f32params.pt")
    with open(spec["result"], "w") as f:
        json.dump(result, f)
    return 0


class MpRun:
    """Two ranks of ``python chip_smoke.py --rank-child`` sharing the card
    over gloo."""

    def __init__(self, tmp, name, entry, runs, kill_at_block=None, f32=None):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.name, self.procs, self.results, self.logs = name, [], [], []
        self.t0 = time.time()
        for rank in range(2):
            res = os.path.join(tmp, f"mp_{name}_rank{rank}.json")
            spec = {"entry": entry, "runs": runs, "result": res,
                    "kill_at_block": kill_at_block, "f32": f32}
            with open(res + ".spec", "w") as f:
                json.dump(spec, f)
            for old in (res, res + ".updates"):
                if os.path.exists(old):
                    os.unlink(old)
            env = {**os.environ, "WORLD_SIZE": "2", "RANK": str(rank), "LOCAL_RANK": "0",
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "PYTHONUNBUFFERED": "1"}
            log = os.path.join(tmp, f"mp_{name}_rank{rank}.log")
            with open(log, "w") as f:
                proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                         "--rank-child", res + ".spec"], cwd=ROOT, env=env,
                                        stdout=f, stderr=subprocess.STDOUT)
            _MP_PROCS.append(proc)
            self.procs.append(proc)
            self.results.append(res)
            self.logs.append(log)

    def tail(self, rank, n=3000):
        with open(self.logs[rank]) as f:
            return f.read()[-n:]

    def wait(self, rank, timeout):
        """The rank's exit code, or None if it still runs after ``timeout``."""
        try:
            return self.procs[rank].wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None

    def finish(self, timeout=600):
        """Both ranks' results; raises unless both exit 0."""
        for rank in range(2):
            rc = self.wait(rank, max(timeout - (time.time() - self.t0), 1))
            if rc != 0:
                raise AssertionError(f"phase 22 {self.name}: rank {rank} exit {rc}:\n"
                                     + self.tail(rank))
        self.seconds = time.time() - self.t0
        out = []
        for res in self.results:
            with open(res) as f:
                out.append(json.load(f))
        return out


def mp_sigterm_at_first_update(run):
    """22e: SIGTERM to rank 1 alone once it has applied its first update."""
    import signal

    cue = run.results[1] + ".updates"
    while run.procs[1].poll() is None:
        if os.path.exists(cue):
            run.procs[1].send_signal(signal.SIGTERM)
            run.sigterm_at = time.time() - run.t0
            return
        time.sleep(0.02)


def mp_stop_all():
    """Kill every rank of phase 22 still running."""
    for proc in _MP_PROCS:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def mp_rows_gap(a, b):
    """(rows equal bit for bit, of how many, max |a - b|) of two float16
    matrices, row by row."""
    same = sum(np.array_equal(x, y) for x, y in zip(a, b))
    return same, len(a), float(np.abs(a.astype(np.float32) - b.astype(np.float32)).max())


def mp_scan_print(card, label, results, run):
    for r in results:
        x = r["runs"][run]
        print(f"  {card}: {label} rank {r['rank']}: rows {x['row_range'][0]}:"
              f"{x['row_range'][1]}, {x['blocks']} row blocks scored, {x['pairs']} pairs "
              f"in {x['scan_seconds']:.3f}s = {x['pairs'] / max(x['scan_seconds'], 1e-9):.1f} "
              f"pairs/s (two ranks time-slice one card); launches {x['launches']}",
              flush=True)
        for name in MAIN_PATH:
            if x["launches"].get(name, 0) <= 0:
                raise AssertionError(f"rank {r['rank']} never launched {name}")


def mp_train_check(card, label, results, kernels):
    """Both ranks' updates: parameters bit-equal after every one, every
    kernel of ``kernels`` launched on every rank."""
    for r in results:
        x = r["runs"][0]
        missing = [k for k in kernels if x["launches"].get(k, 0) <= 0]
        print(f"  {card}: {label} rank {r['rank']}: {len(x['steps'])} updates, losses "
              f"{[round(s['loss'], 4) for s in x['steps']]}; ms per update (host clock "
              f"around the step, the ranks time-slice one card) "
              f"{[round(s['ms'], 1) for s in x['steps']]}, of it the gradient all-reduce "
              f"over gloo {[round(s['reduce_ms'], 1) for s in x['steps']]}; "
              f"{x['seconds']:.1f}s with model build, loader and validates; launches "
              f"{x['launches']}", flush=True)
        if missing:
            raise AssertionError(f"{label}: rank {r['rank']} never launched {missing}")
    d0 = [s["digest"] for s in results[0]["runs"][0]["steps"]]
    d1 = [s["digest"] for s in results[1]["runs"][0]["steps"]]
    print(f"  {label}: parameters bit-equal across the ranks after each update: "
          f"{[a == b for a, b in zip(d0, d1)]}", flush=True)
    if len(d0) < 3 or d0 != d1:
        raise AssertionError(f"{label}: the ranks' parameters differ or < 3 updates")


def mp_one_process(tmp, run, entry_name, argv, images):
    """The f32 update of both ranks' batches concatenated, in this process
    (rank 1's pair indices offset by the local batch), against rank 0's:
    the worst max |rank 0 - one process| / max |one process| over the
    parameters."""
    import importlib

    entry = importlib.import_module(f"vit_ed_tpu_torch.{entry_name}")
    cls = entry.HisfragTrainer if entry_name == "hisfrag" else entry.DefaultTrainer
    parts = [dict(np.load(res + ".f32batch.npz")) for res in run.results]
    if "gi" in parts[1]:
        for k in ("gi", "gj"):
            parts[1][k] = parts[1][k] + images
    batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    trainer = cls(entry.parse_option(argv))
    trainer.setup_training(1)
    trainer.train_step([batch])
    got = torch.load(run.results[0] + ".f32params.pt", weights_only=True)
    worst, at = 0.0, ""
    for name, p in trainer.model.named_parameters():
        ref = p.detach().cpu()
        gap = ((got[name] - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()
        if gap > worst:
            worst, at = gap, name
    del trainer
    torch.cuda.empty_cache()
    return worst, at


def mp_f32_argv(argv_fn, tag, batch):
    return argv_fn(tag) + ["--disable_amp", "--batch-size", str(batch), "--opts",
                           "MODEL.DROP_PATH_RATE", "0.1", "TRAIN.AUTO_RESUME", "False",
                           "TRAIN.WARMUP_EPOCHS", "0", "TRAIN.OPTIMIZER.NAME", "sgd"]


def mp_link_subset(src, dst, n_train, n_valid):
    for sub, n in (("DIV2K_train_HR", n_train), ("DIV2K_valid_HR", n_valid)):
        os.makedirs(os.path.join(dst, sub), exist_ok=True)
        for name in sorted(os.listdir(os.path.join(src, sub)))[:n]:
            os.link(os.path.join(src, sub, name), os.path.join(dst, sub, name))


def phase_nccl_one_rank(tmp, data):
    """22f: one DIV2K update through the all-reduce over NCCL (a group of one
    rank on the card, the default backend) against the plain update."""
    import torch.distributed as dist

    from vit_ed_tpu_torch.main import DefaultTrainer, parse_option
    from vit_ed_tpu_torch.parallel.mesh import CARD_BACKEND

    argv = puzzle_argv(data, os.path.join(tmp, "out"), "mp_nccl", "train",
                       "--batch-size", str(MP_DIV2K_BATCH), "--opts", "TRAIN.AUTO_RESUME",
                       "False", "TRAIN.WARMUP_EPOCHS", "0")
    samples, targets = mp_f32_batch("main", 0, MP_DIV2K_BATCH)
    batch = {"samples": samples, "targets": targets}
    states = {}
    calls = []
    all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        calls.append((tensor.device.type, tensor.numel()))
        return all_reduce(tensor, *args, **kwargs)

    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for mode in ("plain", "nccl"):
        if mode == "nccl":
            dist.init_process_group(CARD_BACKEND, init_method=f"tcp://127.0.0.1:{port}",
                                    world_size=1, rank=0)
            dist.all_reduce = counted
        try:
            trainer = DefaultTrainer(parse_option(argv))
            trainer.setup_training(1)
            loss, _ = trainer.train_step([batch])
            states[mode] = ({n: p.detach().clone() for n, p in trainer.model.named_parameters()},
                            loss.item(), trainer.data_parallel)
            del trainer
        finally:
            if mode == "nccl":
                dist.all_reduce = all_reduce
                backend = dist.get_backend()
                dist.destroy_process_group()
    torch.cuda.empty_cache()
    same = all(torch.equal(states["plain"][0][n], states["nccl"][0][n])
               for n in states["plain"][0])
    print(f"  {card_line()}: 22f: one rank, backend {backend}: all-reduce calls "
          f"{calls} (the step's gradients and loss, on the card, over NCCL); loss "
          f"{states['nccl'][1]:.6f} vs plain {states['plain'][1]:.6f}; parameters equal "
          f"the plain one-process update bit for bit {same}. NCCL across two cards is "
          f"unverified: this host has one card", flush=True)
    if not (same and states["nccl"][2] and not states["plain"][2]
            and states["nccl"][1] == states["plain"][1]
            and calls and all(d == "cuda" for d, _ in calls)):
        raise AssertionError("22f: the NCCL all-reduce step differs from the plain one")


def phase_multiprocess(tmp, scan5):
    """Phase 22: the port on two processes that share the card over gloo
    (each a child running the entry's own main(argv)), and one NCCL rank."""
    import glob
    import signal

    from vit_ed_tpu_torch.train.checkpoint import load_checkpoint

    card = card_line()
    t_phase = time.time()
    print("== phase 22: two processes (WORLD_SIZE 2, LOCAL_RANK 0, gloo) on one card, "
          "full width, seed 0; then one NCCL rank. Two ranks that time-slice one card "
          "check correctness: their times are no speedup", flush=True)
    data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
    scan_argv = lambda tag, *o: hisfrag_test_argv(data, out, tag, *MP_SCAN_OPTS, *o)  # noqa: E731
    tdata = os.path.join(tmp, "mp_train")
    write_corpus(tdata, writers=3, sub="train", seed=1)    # 8 train images: 3 updates of 8
    ddata, edata = os.path.join(tmp, "mp_div2k"), os.path.join(tmp, "div2k")
    mp_link_subset(edata, ddata, 77, 8)                      # 385 items: 3 updates of 2 x 64
    h_argv = lambda tag: train_argv(tdata, out, tag)          # noqa: E731
    d_argv = lambda tag: puzzle_argv(ddata, out, tag, "train")  # noqa: E731
    e_argv = lambda tag: puzzle_argv(edata, out, tag, "train")  # noqa: E731
    once = ("TRAIN.EPOCHS", "1", "TRAIN.WARMUP_EPOCHS", "0", "PRINT_FREQ", "1")
    try:
        # 22e first (its run, the SIGTERM and the rerun are the longest
        # chain), then 22a, 22b's killed scan and 22c
        e_run = [e_argv("mp_e") + ["--batch-size", str(MP_DIV2K_BATCH), "--opts", *once]]
        e = MpRun(tmp, "22e", "main", e_run)
        cue = threading.Thread(target=mp_sigterm_at_first_update, args=(e,), daemon=True)
        cue.start()
        a = MpRun(tmp, "22a", "hisfrag", [scan_argv("mp_a"), scan_argv("mp_s", *SHARDED_OPTS)])
        k = MpRun(tmp, "22b", "hisfrag", [scan_argv("mp_k", *SHARDED_OPTS)], kill_at_block=2)
        c = MpRun(tmp, "22c", "hisfrag",
                  [h_argv("mp_c") + ["--batch-size", str(MP_HISFRAG_BATCH), "--opts", *once]],
                  f32={"argv": mp_f32_argv(h_argv, "mp_c32", MP_F32["hisfrag"]),
                       "images": MP_F32["hisfrag"]})
        rc1 = k.wait(1, 600)
        t_kill = time.time()
        rc0 = k.wait(0, MP_TIMEOUT + 30)
        waited = time.time() - t_kill
        kdir = os.path.join(out, "hisfrag20_patch16_512", "mp_k")
        done = {r: len(glob.glob(os.path.join(kdir, f"test_rank{r}_rows*.done")))
                for r in range(2)}
        print(f"  22b: rank 1 killed itself at its second row block (exit {rc1}); rank 0 "
              f"exit {rc0} {waited:.1f}s later (group timeout {MP_TIMEOUT}s); .done "
              f"markers left {done}", flush=True)
        if rc1 != -signal.SIGKILL or rc0 in (None, 0) or done[1] != 1:
            raise AssertionError("22b: the killed scan did not stop as it should")
        # then the resumed scan and 22d, while 22a, 22c and 22e end
        k2 = MpRun(tmp, "22b_rerun", "hisfrag", [scan_argv("mp_k", *SHARDED_OPTS)])
        d = MpRun(tmp, "22d", "main",
                  [d_argv("mp_d") + ["--batch-size", str(MP_DIV2K_BATCH), "--opts", *once]],
                  f32={"argv": mp_f32_argv(d_argv, "mp_d32", MP_F32["main"]),
                       "images": MP_F32["main"]})

        re_ = e.finish()
        cue.join()
        print(f"== phase 22e: SIGTERM to rank 1 only during a DIV2K epoch "
              f"({e.seconds:.1f}s)", flush=True)
        edir = os.path.join(out, "div2k_erosion7_4bin_patch8_64", "mp_e")
        tree = load_checkpoint(os.path.join(edir, "checkpoint.ckpt"))
        said = [r["runs"][0] for r in re_]
        print(f"  SIGTERM to rank 1 {getattr(e, 'sigterm_at', float('nan')):.1f}s after the "
              f"launch, after its first update; both ranks preempted "
              f"{[s['preempted'] for s in said]} after update "
              f"{[s['step'] for s in said]} of {said[0]['steps_per_epoch']}; checkpoint "
              f"step {tree['step']}, in_epoch_opt_steps {tree['in_epoch_opt_steps']}",
              flush=True)
        if not (all(s["preempted"] for s in said) and said[0]["step"] == said[1]["step"]
                == tree["step"] == tree["in_epoch_opt_steps"]
                and 0 < tree["step"] < said[0]["steps_per_epoch"]):
            raise AssertionError("22e: the ranks did not save together mid-epoch")
        e2 = MpRun(tmp, "22e_rerun", "main", e_run)

        ra = a.finish()
        print(f"== phase 22a: python -m vit_ed_tpu_torch.hisfrag --mode test over 2 ranks, "
              f"N = {len(scan5['dm'])}, row blocks of 16 ({a.seconds:.1f}s for both runs)",
              flush=True)
        mp_scan_print(card, "assembled", ra, 0)
        mp_scan_print(card, "sharded, slab on disk", ra, 1)
        dm0, dm1 = (np.load(f"{res}.0.npy") for res in a.results)
        same, n_rows, gap = mp_rows_gap(dm0, scan5["dm"])
        print(f"  assembled: both ranks' matrices equal {np.array_equal(dm0, dm1)}; "
              f"against phase 5's (one process, one row block of 64): {same} of {n_rows} "
              f"rows bit-equal, max |distance gap| {gap:.3e} (tol 1e-2: cuBLAS may pick "
              f"another GEMM algorithm for another M)", flush=True)
        if not np.array_equal(dm0, dm1) or gap > 1e-2:
            raise AssertionError("22a: the merged matrix differs")
        m_a = ra[0]["runs"][0]["metrics"]
        for r in ra:
            lo, hi = r["runs"][1]["row_range"]
            rows = np.load(f"{a.results[r['rank']]}.1.npy")
            dist_rows = (1.0 - rows.astype(np.float32)).astype(np.float16)
            if not (np.array_equal(dist_rows, dm0[lo:hi]) and np.allclose(
                    r["runs"][1]["metrics"], m_a, rtol=1e-12, atol=0)):
                raise AssertionError(f"22a: rank {r['rank']}'s sharded rows or metrics differ")
        m19 = [float(m) for m in scan5["metrics"]]
        mgap = max(abs(x - y) for x, y in zip(m_a, m19))
        print(f"  sharded: each rank's rows equal the merged matrix's rows bit for bit, "
              f"its merged partials its metrics within rtol 1e-12; metrics {m_a} "
              f"(phase 19a: {m19}, max gap {mgap:.2e}; "
              f"{'rows equal phase 5' if same == n_rows else 'rows differ from phase 5 within 1e-2'})",
              flush=True)
        if (same == n_rows and mgap > 1e-12) or mgap > 2e-2:
            raise AssertionError("22a: the sharded metrics differ from phase 19a's")

        rc = c.finish()
        print(f"== phase 22c: python -m vit_ed_tpu_torch.hisfrag --mode train over 2 ranks, "
              f"2 x {MP_HISFRAG_BATCH} images, bf16, DropPath 0.1 ({c.seconds:.1f}s)",
              flush=True)
        mp_train_check(card, "22c", rc, MP_PAIR_KERNELS)
        worst, at = mp_one_process(tmp, c, "hisfrag", mp_f32_argv(
            h_argv, "mp_c1p", 2 * MP_F32["hisfrag"]), MP_F32["hisfrag"])
        print(f"  f32 update 1 (2 x {MP_F32['hisfrag']} images, DropPath 0.1, SGD) against "
              f"one process on the concatenated batch with offset pair indices: worst "
              f"max|gap|/max {worst:.3e} at {at} (tol 1e-4)", flush=True)
        if worst > 1e-4:
            raise AssertionError("22c: the two-rank update differs from one process's")

        rk = k2.finish()
        print(f"== phase 22b: the killed scan rerun ({k2.seconds:.1f}s)", flush=True)
        for r in rk:
            full = ra[r["rank"]]["runs"][1]["blocks"]
            redo = r["runs"][0]["blocks"]
            rows = np.load(f"{k2.results[r['rank']]}.0.npy")
            same_rows = np.array_equal(rows, np.load(f"{a.results[r['rank']]}.1.npy"))
            print(f"  rank {r['rank']}: {redo} of {full} row blocks scored again "
                  f"({done[r['rank']]} had a .done marker); rows equal 22a's bit for bit "
                  f"{same_rows}", flush=True)
            if redo != full - done[r["rank"]] or not same_rows:
                raise AssertionError("22b: the rerun rescored a finished block or differs")

        rd = d.finish()
        print(f"== phase 22d: python -m vit_ed_tpu_torch.main --mode train over 2 ranks, "
              f"pjs patch8_64, 2 x {MP_DIV2K_BATCH} pairs, bf16, DropPath 0.1 "
              f"({d.seconds:.1f}s)", flush=True)
        mp_train_check(card, "22d", rd, MP_HEADS_KERNELS)
        worst, at = mp_one_process(tmp, d, "main", mp_f32_argv(
            d_argv, "mp_d1p", 2 * MP_F32["main"]), MP_F32["main"])
        print(f"  f32 update 1 (2 x {MP_F32['main']} pairs, DropPath 0.1, SGD) against one "
              f"process on the concatenated batch: worst max|gap|/max {worst:.3e} at {at} "
              f"(tol 1e-4)", flush=True)
        if worst > 1e-4:
            raise AssertionError("22d: the two-rank update differs from one process's")

        re2 = e2.finish()
        total = [r["runs"][0]["step"] for r in re2]
        want = said[0]["steps_per_epoch"] * said[0]["epochs"]
        print(f"  22e rerun ({e2.seconds:.1f}s): updates {total} on the ranks, an uninterrupted "
              f"run's {want}; bit-equal ranks after its updates "
              f"{[s['digest'] for s in re2[0]['runs'][0]['steps']] == [s['digest'] for s in re2[1]['runs'][0]['steps']]}",
              flush=True)
        if total != [want, want] or (
                [s["digest"] for s in re2[0]["runs"][0]["steps"]]
                != [s["digest"] for s in re2[1]["runs"][0]["steps"]]):
            raise AssertionError("22e: the rerun did not finish the epoch as one")
    finally:
        mp_stop_all()

    print("== phase 22f: one rank with the default backend (cpu:gloo,cuda:nccl)", flush=True)
    phase_nccl_one_rank(tmp, ddata)
    print(f"  phase 22 took {time.time() - t_phase:.1f}s on {card}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    dev = resolve_device("cuda")
    card = card_line()
    print("== phase 1: the card", flush=True)
    print(f"  {card}")
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)
    t0 = time.time()
    _build.build_all()
    print(f"  kernels built in {time.time() - t0:.1f}s (nvcc, sm_90a): "
          + "; ".join(f"{s} {t:.1f}s" for s, t in _build.build_seconds.items()))
    for line in ptxas_lines(_build.build_log):
        print("   ", line)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = phase_kernels_vs_plain(gen)
    times = phase_times(gen)
    phase_model(gen)
    with tempfile.TemporaryDirectory() as tmp:
        phase_native(tmp)
        counts, scan5 = phase_main_path(tmp)
        bwd_err = phase_backward_vs_plain(gen)
        train_times = phase_backward_times(gen)
        phase_gradients(tmp)
        train_counts = phase_train_path(tmp)
        heads_err = phase_heads_vs_plain(gen)
        heads_times = phase_heads_times(gen)
        phase_puzzle_model(tmp)
        puzzle_shapes, puzzle_ckpt = phase_puzzle_path(tmp)
        scan32_shapes = phase_heads_scan(tmp)
        eval_shapes_run, eval_times, n_puzzles, eval15 = phase_puzzle_eval(
            tmp, puzzle_ckpt, gen)
        michigan_rows = phase_michigan(tmp, gen)
        vit_rows = phase_vit(tmp, gen)
        pajigsaw_rows, lrf_shapes = phase_pajigsaw(tmp, gen)
        phase_slice11(tmp, gen, scan5, eval15, puzzle_ckpt)
        phase_slice12(tmp, gen, scan5)
        phase_multiprocess(tmp, scan5)

    print(f"  off every main path, packed: {json.dumps(times['packed'])} "
          f"max_abs_err {err['packed']:.3e}; packed_bwd: "
          f"{json.dumps(train_times['packed_dq'])} {json.dumps(train_times['packed_dkv'])} "
          f"max_abs_err "
          f"{bwd_err['packed']:.3e}")
    # the scan's kernels carry phase 5's launches and phase 3's times; the
    # training path's carry phase 9's launches and phase 7's times
    kernels = [{
        "name": f"pair_attention_{name}",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[name],
        "launches": counts[name],
        "max_abs_err": err[name],
        **times[name],
    } for name in MAIN_PATH]
    kernels.append({
        "name": "pair_attention_kv", "route": "cuda", "source": SOURCE,
        "replaces": REPLACES["kv"], "launches": train_counts["kv"],
        "max_abs_err": err["kv"], **train_times["kv"]})
    # the pair route's backward is the 4-D dq + dkv kernels at head_dim 64
    kernels += [{
        "name": f"pair_attention_{name}",
        "route": "cuda",
        "source": HEADS_BWD_SOURCE,
        "replaces": BWD_REPLACES,
        "launches": train_counts[name],
        "max_abs_err": bwd_err[name.rsplit("_", 1)[0]],
        **train_times[name],
    } for name in TRAIN_PATH_BWD]
    print(f"  off every main path, 4-D route: fused_attention "
          f"{json.dumps(heads_times['bhsd@s65'])} / {json.dumps(heads_times['bhsd@s1025'])} "
          f"max_abs_err {heads_err['bhsd']:.3e}; fused_attention_flat "
          f"({HEADS_REPLACES['flat']}) {json.dumps(heads_times['flat@s65'])} / "
          f"{json.dumps(heads_times['flat@s1025'])} max_abs_err {heads_err['flat']:.3e}; "
          f"kv_shared at B={PUZZLE_BATCH}: {json.dumps(heads_times['kv_shared@s65'])}; "
          f"at B=64 S=1025: "
          + "; ".join(f"{k} {json.dumps(v)}" for k, v in heads_times.items()
                      if k.endswith("@s1025")
                      and k.split("@")[0] not in ("bhsd", "flat")))

    def launched(shapes, name, n_q, n_k):
        """Launches of one counter at one (Sq, Sk), every batch size."""
        return sum(n for key, n in shapes.items()
                   if key[0] == name and key[3:5] == (n_q, n_k))

    # one row per kernel, layout and shape of the puzzle path: ``launches`` is
    # --mode train's count at that (Sq, Sk) (10 steps at B=128, and for the
    # forward two validates of three batches), the times are phase 11's at
    # that shape and B=128. The encoder's self-attention (S=64, no CLS token),
    # the decoder's (S=65) and the last block's CLS-row cross-attention (Sq=1)
    # are rows of their own. The shared-kv forward
    # carries the head_dim 32 scan's launches at Sq=1025 and its time at the
    # scan's own chunk shape.
    # lr_finder (phase 18d) runs the same layouts at the same shapes: its
    # launches add to --mode train's
    for key, n in lrf_shapes.items():
        puzzle_shapes[key] = puzzle_shapes.get(key, 0) + n
    for name, tag, n_q, n_k in (("qkv", "s65", 65, 65), ("qkv", "s64", 64, 64),
                                ("qkv_cls", "s65", 1, 65), ("kv", "s65", 65, 64),
                                ("kv", "cls", 1, 64)):
        suffix = {"s64": "_encoder", "cls": "_cls_row"}.get(tag, "")
        for kind, source in (("", HEADS_SOURCE), ("_dq", HEADS_BWD_SOURCE),
                             ("_dkv", HEADS_BWD_SOURCE)):
            kernels.append({
                "name": f"heads_attention_{name}{kind}{suffix}", "route": "cuda",
                "source": source,
                "replaces": HEADS_REPLACES[kind[1:] or "forward"],
                "launches": launched(puzzle_shapes, f"heads_{name}{kind}", n_q, n_k),
                "max_abs_err": heads_err[name + ("_bwd" if kind else "")],
                **heads_times[f"{name}{kind}@{tag}"]})
    kernels.append({
        "name": "heads_attention_kv_shared", "route": "cuda", "source": HEADS_SOURCE,
        "replaces": HEADS_REPLACES["forward"],
        "launches": launched(scan32_shapes, "heads_kv_shared", 1025, 1024),
        "max_abs_err": heads_err["kv_shared"], **heads_times["kv_shared@scan"]})
    # the evaluation's forwards (phase 15): one row per shape, ``launches``
    # over all its puzzles at that (Sq, Sk), the times at B = PUZZLE_BATCH
    for tag, (layout, n_q, n_k, r) in eval_times.items():
        kernels.append({
            "name": f"heads_attention_{layout}_eval_{tag}", "route": "cuda",
            "source": HEADS_SOURCE, "replaces": HEADS_REPLACES["forward"],
            "launches": launched(eval_shapes_run, f"heads_{layout}", n_q, n_k), **r})
    print(f"  the evaluation's launches per puzzle by shape: " + "; ".join(
        f"{k['name']} {k['launches'] / n_puzzles:.0f}" for k in kernels[-len(eval_times):]))
    # the Michigan slice's pair kernels at S = 577 (phase 16)
    kernels += michigan_rows
    # the ViT baselines' kernels at their own shapes (phase 17)
    kernels += vit_rows
    # the Pajigsaw entry's pair kernels, training and score_dense (phase 18)
    kernels += pajigsaw_rows
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was launched no time on its main path")
    print(f"  total {time.time() - t_start:.1f}s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2]))
    sys.exit(main())
