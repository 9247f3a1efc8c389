"""Profiling hook (``vit_ed_tpu/utils/profiler.py``): a ``torch.profiler``
trace behind the JAX package's interface, gated by ``TPU.PROFILE_DIR``."""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_trace(profile_dir: str, name: str = "trace"):
    """Context manager: a torch.profiler trace of the region (CPU and, on a
    card, CUDA activities) exported as ``<profile_dir>/<name>.json`` for
    chrome://tracing or Perfetto when ``profile_dir`` is set; a no-op
    otherwise."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, f"{name}.json"))
