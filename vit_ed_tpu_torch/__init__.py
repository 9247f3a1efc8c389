"""vit_ed_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of vit_ed_tpu.

The JAX package ``vit_ed_tpu`` stays the reference; this package re-creates
its slices in PyTorch and replaces every Pallas TPU kernel with a kernel
written by hand for Hopper. It imports nothing from ``vit_ed_tpu`` (nor
jax/flax/optax): the framework-neutral pieces it needs (config, data,
metrics, utils) are its own copies.

Slice 1 (this package today): the row-sharded O(N^2) writer-retrieval
scoring path of ViT-ED — ``python -m vit_ed_tpu_torch.hisfrag --mode test``.

  device     -- ``resolve_device``: CUDA unless the caller asks for the CPU
  config     -- YAML config tree (same keys as vit_ed_tpu.config)
  ops        -- the pair-attention CUDA kernel + plain versions, bf16 GELU
  models     -- ViT-ED (timm key layout), JAX-param conversion, factory
  parallel   -- the single-process row-sharded pair scorer
  data       -- HisFrag20 eval dataset and eval transforms
  metrics    -- wi19 retrieval metrics
"""

__version__ = "0.1.0"
