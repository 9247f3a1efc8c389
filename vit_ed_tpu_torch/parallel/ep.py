"""Expert parallelism of the MoE banks (``vit_ed_tpu/parallel/ep.py``).

The rule is the JAX package's, on the flax leaf a torch parameter converts
from: the bank leaves ``w1``, ``b1``, ``w2`` and ``b2`` of every ``mlp``
(models/moe.py, [E, ...]) split on dim 0 over the ``expert`` axis; the
router and everything else stay replicated.

As in JAX, where the batch is sharded over ``data`` only, the ``expert``
peers hold the same tokens: each routes them with the whole router, runs
its E/e experts on all of them, and the combine is summed over the
``expert`` group (``MoeMlp.expert_group``). Dispatch and capacity stay per
image. E must be a positive multiple of the axis size (the trainer checks).
"""

from __future__ import annotations

from typing import Dict, Optional

from torch import nn

from vit_ed_tpu_torch.models.convert import flax_leaf
from vit_ed_tpu_torch.models.moe import MoeMlp
from vit_ed_tpu_torch.parallel.mesh import Spec

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def ep_param_specs(model: nn.Module, axis: str = "expert") -> Dict[str, Optional[Spec]]:
    """{parameter name: Spec or None}: the bank leaves split on dim 0."""
    specs = {}
    for name, p in model.named_parameters():
        view = flax_leaf(name, p.shape)
        specs[name] = (Spec(axis, view.torch_dims[0])
                       if view.parent == "mlp" and view.leaf in EXPERT_LEAVES
                       and len(view.shape) >= 2 else None)
    return specs


def apply_ep(model: nn.Module, group, n: int, i: int) -> None:
    """Give every bank of ``model`` (its leaves already this rank's shards)
    its experts' range and the ``expert`` group."""
    for m in model.modules():
        if isinstance(m, MoeMlp):
            per = m.num_experts // n
            m.expert_group, m.expert_range = group, (i * per, (i + 1) * per)
