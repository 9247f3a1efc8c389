"""vit_ed_tpu_torch — the PyTorch / CUDA (NVIDIA H100) port of vit_ed_tpu.

The JAX package ``vit_ed_tpu`` stays the reference; this package re-creates
its slices in PyTorch and replaces every Pallas TPU kernel with a kernel
written by hand for Hopper. It imports nothing from ``vit_ed_tpu`` (nor
jax/flax/optax): the framework-neutral pieces it needs (config, data,
metrics, utils) are its own copies.

This package today: the row-sharded O(N^2) writer-retrieval scoring path
of ViT-ED and its mined-pair training
(``python -m vit_ed_tpu_torch.hisfrag --mode train|eval|test``), the DIV2K
puzzle-pair entry (``python -m vit_ed_tpu_torch.main``), puzzle evaluation
with the Paikin-Tal solver (``python -m vit_ed_tpu_torch.evaluation``), and
their input pipeline in native C++; every other root entry of the JAX
package (``michigan``, ``geshame_evaluation``, ``main_vit``,
``hisfrag_vit``, ``pajigsaw``, ``lr_finder``, ``solver_driver``) and the
two scripts that import it (``visualise_attentions``,
``visualise_dataset``).

  device     -- ``resolve_device``: CUDA unless the caller asks for the CPU
  config     -- YAML config tree (same keys as vit_ed_tpu.config)
  ops        -- the attention CUDA kernels (pair and 4-D, forward and
                backward) + plain versions, bf16 GELU with its closed-form
                derivative, the pair gather with a fixed-order backward,
                dynamic int8 GEMMs for scoring, attention explainability
  models     -- ViT-ED (timm key layout), JAX-param conversion, factory
  parallel   -- the pair scorer (row-sharded and mixed-chunk schedules,
                split over processes by rows, ``score_dense`` for puzzle
                pieces) and the ``torch.distributed`` rendezvous and host
                collectives (``mesh``)
  solver     -- the Paikin-Tal puzzle solver, its accuracies, and image
                reading / LAB conversion equal to OpenCV's without OpenCV
  train      -- losses, schedules + optimizers, checkpoints, the Trainer
  data       -- HisFrag20 and DIV2K datasets, puzzle pieces, transforms,
                samplers, loader
  native     -- C++ built with g++ at first use (ctypes): the input
                pipeline (decode, warps, jitter, blur, fused
                crop/resize/normalize) and the solver's placement core
  metrics    -- wi19 retrieval (whole or from row slabs) and
                classification metrics
"""

__version__ = "0.1.0"
