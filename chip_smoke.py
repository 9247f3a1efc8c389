#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit_ed_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs one CUDA card, nvcc, and nothing
from the JAX package. Phases, each printing its own lines:

1. the card, its power limit, torch/CUDA versions; the kernels are built
   from vit_ed_tpu_torch/csrc with nvcc (one process per source);
2. kernel against plain: every pair-attention wrapper on the card at the
   flagship shapes (B=8, C=384, 6 heads, S=1024/1025, CLS Sq=1), bf16 and
   f32, against its plain PyTorch version; kv_shared must equal the
   materialised broadcast and CLS the full output's row 0 bit for bit;
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
   S=1024/1025, CLS Sq=1; f32 within 1e-4 of the gradient's max, bf16
   within 2e-2) against ``pair_attention_backward_plain``, and two launches
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
   is reloaded and one step is broken down with torch.profiler.

Any failure raises (exit code != 0). The second-to-last lines are the
card (``nvidia-smi`` name, power limit) and one JSON object with the
kernels' numbers; the last line is the result JSON.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

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

FLAGSHIP_CFG = os.path.join(ROOT, "configs", "hisfrag", "hisfrag20_patch16_512.yaml")
C, H, D = 384, 6, 64
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
SOURCE = "vit_ed_tpu_torch/csrc/pair_attention.cu"
BWD_SOURCE = "vit_ed_tpu_torch/csrc/pair_attention_bwd.cu"
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
TRAIN_PATH_BWD = ("qkv_bwd", "qkv_cls_bwd", "kv_bwd")
# launches of one optimizer step at depth 12 + 12 with the CLS short-circuit:
# 12 encoder self-attentions, 11 + 1 (CLS) decoder self-attentions and 12
# per-pair cross-attentions, each once forward and once backward
STEP_LAUNCHES = {"qkv": 23, "qkv_cls": 1, "kv": 12,
                 "qkv_bwd": 23, "qkv_cls_bwd": 1, "kv_bwd": 12}
TRAIN_BATCH, TRAIN_PAIRS = 16, 49
# launches of one score_tokens_row chunk with 12 decoder blocks: self-attn
# in blocks 1..10 (block 0's is hoisted, block 11's is CLS-only), one
# shared-kv cross-attention per block; phase 4 measures and checks it
CHUNK_LAUNCHES = {"qkv": 10, "kv_shared": 12, "qkv_cls": 1, "kv": 0, "packed": 0}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def rand(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda").to(dtype)


def heads(x):
    return x.unflatten(-1, (H, D)).transpose(1, 2).contiguous()


def cases(gen, dtype, b, s, sk):
    """wrapper -> (kernel call, plain call, SDPA call) on fresh inputs."""
    qkv = rand(gen, b, s, 3 * C, dtype=dtype)
    q = rand(gen, b, s, C, dtype=dtype)
    q1 = q[:, :1].contiguous()
    kv1 = rand(gen, 1, sk, 2 * C, dtype=dtype)
    kv = rand(gen, b, sk, 2 * C, dtype=dtype)
    k, v = kv.split(C, -1)
    k, v = k.contiguous(), v.contiguous()
    sc = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (heads(t) for t in qkv.split(C, -1))
    k1h, v1h = (heads(t.expand(b, -1, -1)) for t in kv1.split(C, -1))
    return {
        "qkv": (lambda: A.fused_attention_packed_qkv(qkv, H),
                lambda: A.pair_attention_plain(*qkv.split(C, -1), H, sc),
                lambda: sdpa(qh, kh, vh),
                {"qkv": qkv}),
        "kv_shared": (lambda: A.fused_attention_packed_kv_shared(q, kv1, H),
                      lambda: A.pair_attention_plain(q, *kv1.split(C, -1), H, sc),
                      lambda: sdpa(heads(q), k1h, v1h),
                      {"q": q, "kv1": kv1}),
        "kv_shared_cls": (lambda: A.fused_attention_packed_kv_shared(q1, kv1, H),
                          lambda: A.pair_attention_plain(q1, *kv1.split(C, -1), H, sc),
                          None, {}),
        "qkv_cls": (lambda: A.fused_attention_packed_qkv_cls(qkv, H),
                    lambda: A.pair_attention_plain(
                        *(t[:, :1] if i == 0 else t
                          for i, t in enumerate(qkv.split(C, -1))), H, sc),
                    lambda: sdpa(qh[:, :, :1], kh, vh),
                    {}),
        "kv": (lambda: A.fused_attention_packed_kv(q, kv, H),
               lambda: A.pair_attention_plain(q, k, v, H, sc),
               lambda: sdpa(heads(q), heads(k), heads(v)),
               {}),
        "packed": (lambda: A.fused_attention_packed(q, k, v, H),
                   lambda: A.pair_attention_plain(q, k, v, H, sc),
                   lambda: sdpa(heads(q), heads(k), heads(v)),
                   {}),
    }


def phase_kernels_vs_plain(gen):
    print("== phase 2: kernel against plain (B=8, C=384, H=6)", flush=True)
    err = {name: 0.0 for name in REPLACES}
    for dtype in (torch.float32, torch.bfloat16):
        for s in (1024, 1025):
            cs = cases(gen, dtype, 8, s, 1024)
            outs = {}
            for name, (kern, plain, _lib, _inp) in cs.items():
                out = kern()
                ref = plain()
                torch.cuda.synchronize()
                e = (out.float() - ref.float()).abs().max().item()
                ok = torch.allclose(out.float(), ref.float(), atol=TOL[dtype],
                                    rtol=TOL[dtype])
                print(f"  {name:14s} {str(dtype)[6:]:8s} S={s} "
                      f"max|kernel-plain|={e:.3e} tol={TOL[dtype]:g} "
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


def timed(fn, n=20, inner=5, warmup=3):
    """Median milliseconds per call of ``fn``: n timed runs (CUDA events)
    of ``inner`` back-to-back calls each, after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
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
    # kernel events only (aten ops carry their kernels' time again)
    rows = [(e.key, e.self_device_time_total / 3e3, e.count // 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  one 64-pair chunk: {ms:.2f} ms wall (CUDA events); profiler "
          f"device time {busy:.2f} ms/chunk" + ("" if rows else " (not measured:"
                                               " the profiler saw no device time)"))
    for key, t, cnt in rows[:12]:
        print(f"    {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}%  x{cnt:<4d} {key[:90]}")


def write_corpus(root, writers=16, pages=2, frags=2, seed=0, sub="test"):
    """Synthetic HisFrag split: writer-correlated noise textures as
    ``<sub>/w{W}_{P}_{F}.jpg``, ~600 x 700 px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, sub)
    os.makedirs(d, exist_ok=True)
    for w in range(writers):
        base = rng.integers(0, 256, size=(600 + 8 * w, 700, 3))
        for p in range(pages):
            for f in range(frags):
                arr = np.clip(base + rng.integers(-40, 40, base.shape), 0, 255)
                Image.fromarray(arr.astype(np.uint8)).save(
                    os.path.join(d, f"w{w:03d}_{p}_{f}.jpg"), quality=90)
    return writers * pages * frags


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

    # the scan's scores against direct pair forwards of the same model
    class Args:
        cfg = FLAGSHIP_CFG
        opts = None

    config = get_config(Args())
    torch.manual_seed(config.SEED)
    model = build_model(config, torch.device("cuda")).eval()
    ds = HisFrag20Test(data, Split.TEST, transform=OneImgEval(512, crop=True))
    # upper triangle only: the lower one mirrors (j, i), and the model is
    # not symmetric in its two images
    pairs = [(0, 0), (0, 5), (3, 17), (9, 20), (40, 63)]
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
    return counts


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
                    mx = r.float().abs().max().item()
                    rel = e / (mx if dtype == torch.float32 else max(mx, 1.0))
                    worst = max(worst, rel)
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


def phase_backward_times(gen):
    print(f"== phase 7: backward kernel times at the training shapes "
          f"(B={TRAIN_PAIRS} pairs, bf16)", flush=True)
    b, s, sk = TRAIN_PAIRS, 1025, 1024
    t = vjp_inputs(gen, torch.bfloat16, b, s, sk)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res = {}
    for name, (_fn, names) in VJP_WRAPPERS.items():
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
        res[name + "_bwd"] = r
        print(f"  {name + '_bwd':12s} kernel {r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms"
              f"  sdpa backward {r['library_ms']:.4f} ms  bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f}% of it); "
              f"{STEP_LAUNCHES.get(name + '_bwd', 0)} launches per train step", flush=True)
        del out, lib_out, q, k, v
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
    step_breakdown(trainer)
    host_input_cost(trainer)
    del trainer
    torch.cuda.empty_cache()
    return counts


def host_input_cost(trainer):
    """Host seconds to decode and augment one training image, one thread,
    nothing else running: what the loader's threads spend per batch while
    the step's Python thread competes with them for the interpreter."""
    ds = trainer.get_dataloader("train").dataset
    t0 = time.time()
    for i in range(8):
        ds[i]
    per = (time.time() - t0) / 8
    print(f"  host input: {per * 1e3:.0f} ms per image (JPEG decode + train "
          f"augmentation, numpy/PIL, one thread) = {per * TRAIN_BATCH:.2f} s of "
          f"host work per {TRAIN_BATCH}-image batch over "
          f"{trainer.config.DATA.NUM_WORKERS} loader threads", flush=True)


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
    rows = [(e.key, e.self_device_time_total / 2e3, e.count // 2)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"  profiler: device time {busy:.1f} ms/step of {wall:.1f} ms wall under "
          f"the profiler ({len(rows)} kernels, {sum(r[2] for r in rows)} launches/step)"
          + ("" if rows else " (not measured: the profiler saw no device time)"))
    for key, t, cnt in rows[:14]:
        print(f"    {t:8.3f} ms {100 * t / max(busy, 1e-9):5.1f}%  x{cnt:<4d} {key[:90]}")


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
    for line in "".join(_build.build_log.values()).splitlines():
        if "registers" in line or "spill" in line:
            print("   ", line.strip())

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    err = phase_kernels_vs_plain(gen)
    times = phase_times(gen)
    phase_model(gen)
    with tempfile.TemporaryDirectory() as tmp:
        counts = phase_main_path(tmp)
        bwd_err = phase_backward_vs_plain(gen)
        train_times = phase_backward_times(gen)
        phase_gradients(tmp)
        train_counts = phase_train_path(tmp)

    print(f"  off every main path, packed: {json.dumps(times['packed'])} "
          f"max_abs_err {err['packed']:.3e}; packed_bwd: "
          f"{json.dumps(train_times['packed_bwd'])} max_abs_err "
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
    kernels += [{
        "name": f"pair_attention_{name}",
        "route": "cuda",
        "source": BWD_SOURCE,
        "replaces": BWD_REPLACES,
        "launches": train_counts[name],
        "max_abs_err": bwd_err[name[:-4]],
        **train_times[name],
    } for name in TRAIN_PATH_BWD]
    print(f"  total {time.time() - t_start:.1f}s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
