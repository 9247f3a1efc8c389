"""vit_ed_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of vit_ed_tpu.

The JAX package ``vit_ed_tpu`` stays the reference; this package re-creates
its slices in PyTorch and replaces every Pallas TPU kernel with a kernel
written by hand for Hopper. It imports nothing from ``vit_ed_tpu`` (nor
jax/flax/optax): the framework-neutral pieces it needs (config, data,
metrics, utils) are its own copies.

This package today: the row-sharded O(N^2) writer-retrieval scoring path
of ViT-ED and its mined-pair training
(``python -m vit_ed_tpu_torch.hisfrag --mode train|eval|test``), the DIV2K
puzzle-pair entry (``python -m vit_ed_tpu_torch.main``), and their input
pipeline in native C++.

  device     -- ``resolve_device``: CUDA unless the caller asks for the CPU
  config     -- YAML config tree (same keys as vit_ed_tpu.config)
  ops        -- the attention CUDA kernels (pair and 4-D, forward and
                backward) + plain versions, bf16 GELU with its closed-form
                derivative, the pair gather with a fixed-order backward
  models     -- ViT-ED (timm key layout), JAX-param conversion, factory
  parallel   -- the single-process row-sharded pair scorer
  train      -- losses, schedules + optimizers, checkpoints, the Trainer
  data       -- HisFrag20 and DIV2K datasets, transforms, samplers, loader
  native     -- the input pipeline in C++ (g++ at first use, ctypes):
                decode, warps, jitter, blur, fused crop/resize/normalize
  metrics    -- wi19 retrieval and classification metrics
"""

__version__ = "0.1.0"
