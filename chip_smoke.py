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
5. the main path end to end: ``python -m vit_ed_tpu_torch.hisfrag --mode
   test`` (in process, bf16, configs/hisfrag/hisfrag20_patch16_512.yaml)
   on a synthetic corpus made from a seed, with every wrapper's launch
   count reset before and read after.

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
# wrapper -> the JAX function that reaches pl.pallas_call for it
REPLACES = {
    "qkv": "vit_ed_tpu/ops/attention.py:687",        # _pair_forward_qkv
    "kv_shared": "vit_ed_tpu/ops/attention.py:887",  # _pair_forward_q_kv_shared
    "qkv_cls": "vit_ed_tpu/ops/attention.py:794",    # _pair_forward_qkv_cls
    "kv": "vit_ed_tpu/ops/attention.py:740",         # _pair_forward_q_kv
    "packed": "vit_ed_tpu/ops/attention.py:500",     # _pair_forward
}
MAIN_PATH = ("qkv", "kv_shared", "qkv_cls")
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
    per_chunk = dict(A.launches)
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


def write_corpus(root, writers=16, pages=2, frags=2, seed=0):
    """Synthetic HisFrag test split: writer-correlated noise textures as
    ``test/w{W}_{P}_{F}.jpg``, ~600 x 700 px."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    d = os.path.join(root, "test")
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
    counts = dict(A.launches)
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

    for name in ("kv", "packed"):
        print(f"  off the main path, {name}: {json.dumps(times[name])} "
              f"max_abs_err {err[name]:.3e}")
    kernels = [{
        "name": f"pair_attention_{name}",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES[name],
        "launches": counts[name],
        "max_abs_err": err[name],
        **times[name],
    } for name in MAIN_PATH]
    print(f"  total {time.time() - t_start:.1f}s", flush=True)
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
