"""Mixture-of-Experts MLP (``vit_ed_tpu/models/moe.py``): Switch top-1 or
GShard top-k routing with a static capacity and one-hot dispatch.

Beyond the reference, whose model family is dense, as in the JAX package:

- the router runs in float32 on the float32 input (a Linear without bias);
  top-k of its softmax picks each token's experts (ties go to the lower
  index, as ``jax.lax.top_k``), and with k > 1 the k gates are
  renormalised to sum to 1;
- every expert takes at most ``C = ceil(T / E * capacity)`` tokens of each
  sample; slots are claimed in k-major order (every token's first choice
  before any second choice, then in token order); a token past capacity is
  dropped for that choice (its residual passes through unchanged);
- dispatch and combine are one-hot [B, T, E, C] tensors and the bank is
  three einsums in the compute dtype (matrix work that the JAX package
  does in XLA, outside any Pallas kernel, so plain torch here);
- the aux terms, each a float32 scalar: the load balance ``E * sum_e f_e *
  P_e`` on the first choice (Switch eq. 4; 1.0 when perfectly balanced) and
  the router z-loss ``mean(logsumexp(logits)^2)`` (ST-MoE eq. 5). The JAX
  module sows them into a ``moe_aux`` collection; here ``forward`` returns
  them beside its output, as a [2] tensor, so that a recomputed block
  (``TRAIN.USE_CHECKPOINT``) cannot count them twice;
- the router-input jitter of training (``x * U(1 - j, 1 + j)``, Switch
  §2.2) draws from the model-owned generator (``layers.seed_generators``),
  in training mode only. Data-parallel (``layers.shard_draws`` sets
  ``shard``), it draws the global batch's noise and keeps this rank's rows,
  as DropPath does;
- several processes in training mode (a process group of more than one
  rank) give the aux terms of the global batch's tokens, as the JAX module
  under jit over the global mesh does: ``f``, ``P`` and the z term's mean
  are one all-reduce (``parallel.mesh.all_reduce_sum``, its gradient
  reaching ``P`` and z) over the ranks' equal token counts, divided by the
  world size; the load balance is their product, not a mean of each
  rank's own. Dispatch and capacity stay per sequence;
- expert-parallel (``parallel/ep.py``): the bank holds experts
  ``expert_range`` of E and the router all E. Every ``expert`` peer routes
  the same tokens, runs its experts on them, and the combine is summed over
  the ``expert_group`` (``mesh.reduce_group``); the tokens and the gates
  enter the group with ``mesh.enter_group``, so that their gradients are
  summed over the peers' experts.

Parameters (the flax leaves' layout except the router, a torch Linear
weight): ``router.weight`` [E, D], ``w1`` [E, D, H], ``b1`` [E, H], ``w2``
[E, H, D], ``b2`` [E, D].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ed_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vit_ed_tpu_torch.parallel.mesh import (
    all_reduce_sum,
    enter_group,
    group_world,
    reduce_group,
)


def collect_moe_aux(aux: torch.Tensor, balance_weight: float,
                    z_weight: float = 0.0) -> torch.Tensor:
    """Weighted sum of the aux terms of a training forward (``aux`` [n, 2]:
    one (load balance, router z) row per expert bank, as ``ViTED.encode(...,
    with_aux=True)`` returns them): ``balance_weight`` (Switch's alpha) times
    the load-balance terms plus ``z_weight`` (ST-MoE's c_z) times the z
    terms, a float32 scalar (0 for no bank)."""
    aux = aux.float()
    return balance_weight * aux[:, 0].sum() + z_weight * aux[:, 1].sum()


class MoeMlp(nn.Module):
    """Drop-in for ``layers.Mlp`` that returns ``(y, aux)``."""

    def __init__(self, dim: int, hidden_dim: int, num_experts: int,
                 capacity_factor: float = 1.25, fast_gelu: bool = False,
                 route_k: int = 1, jitter: float = 0.0):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.route_k = route_k
        self.jitter = jitter
        self.act = gelu_tanh if fast_gelu else gelu_exact
        self.generator: Optional[torch.Generator] = None
        self.shard = (0, 1)   # (rank, world) of the rows x holds
        self.expert_group = None        # expert-parallel: the peers' group
        self.expert_range = (0, num_experts)   # the experts this bank holds
        e = num_experts
        self.router = nn.Linear(dim, e, bias=False)
        self.w1 = nn.Parameter(torch.empty(e, dim, hidden_dim))
        self.b1 = nn.Parameter(torch.zeros(e, hidden_dim))
        self.w2 = nn.Parameter(torch.empty(e, hidden_dim, dim))
        self.b2 = nn.Parameter(torch.zeros(e, dim))
        for w in (self.router.weight, self.w1, self.w2):
            nn.init.trunc_normal_(w, std=0.02)

    def capacity(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.num_experts * self.capacity_factor))

    def route(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(dispatch, combine) [B, T, E, C] float32 and the aux terms [2]."""
        b, t, _ = x.shape
        e, k = self.num_experts, self.route_k
        c = self.capacity(t)
        xr = x.float()
        if self.training and self.jitter > 0.0:
            if self.generator is None:
                raise RuntimeError(
                    "MoeMlp's router jitter in training mode needs a seeded "
                    "generator: call the model's seed_drop_path(seed) after "
                    "moving the model to its device")
            rank, world = self.shard
            noise = torch.rand((b * world,) + xr.shape[1:], generator=self.generator,
                               dtype=torch.float32, device=xr.device)
            if world > 1:
                noise = noise[rank * b:(rank + 1) * b]
            xr = xr * (noise * (2.0 * self.jitter) + (1.0 - self.jitter))
        logits = F.linear(xr, self.router.weight)
        probs = torch.softmax(logits, dim=-1)
        # stable sort: equal probabilities keep the lower expert first
        top_i = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
        top_p = torch.gather(probs, -1, top_i)                   # [B, T, k]
        oh = F.one_hot(top_i, e).float()                         # [B, T, k, E]
        gates = top_p if k == 1 else top_p / top_p.sum(-1, keepdim=True)
        gates = enter_group(gates, self.expert_group)

        frac = oh[:, :, 0, :].mean(dim=(0, 1))                   # [E]
        mean_p = probs.mean(dim=(0, 1))
        z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
        world = group_world() if self.training else 1
        if world > 1:
            means = all_reduce_sum(torch.cat([frac, mean_p, z[None]])) / world
            frac, mean_p, z = means[:e], means[e:2 * e], means[2 * e]
        aux = torch.stack([e * (frac * mean_p).sum(), z])

        dispatch = x.new_zeros((b, t, e, c), dtype=torch.float32)
        combine = torch.zeros_like(dispatch)
        prev = x.new_zeros((b, 1, e), dtype=torch.float32)       # slots claimed
        for kk in range(k):
            ohk = oh[:, :, kk, :]                                # [B, T, E]
            pos = (torch.cumsum(ohk, dim=1) - 1.0 + prev) * ohk
            keep = (ohk > 0) & (pos >= 0) & (pos < c)
            # jax.nn.one_hot gives a zero row for a position >= c; torch's
            # raises, so clamp and mask with keep
            pos_oh = F.one_hot(pos.long().clamp(0, c - 1), c).float()
            dk = pos_oh * keep[..., None]
            dispatch = dispatch + dk
            combine = combine + dk * gates[:, :, kk, None, None]
            prev = prev + ohk.sum(dim=1, keepdim=True)
        return dispatch, combine, aux

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        dispatch, combine, aux = self.route(x)
        cdt = x.dtype
        e0, e1 = self.expert_range
        if (e0, e1) != (0, self.num_experts):
            dispatch, combine = dispatch[:, :, e0:e1], combine[:, :, e0:e1]
        x = enter_group(x, self.expert_group)
        expert_in = torch.einsum("btec,btd->ebcd", dispatch.to(cdt), x)
        h = torch.einsum("ebcd,edh->ebch", expert_in, self.w1.to(cdt))
        h = self.act(h + self.b1.to(cdt)[:, None, None, :])
        out = torch.einsum("ebch,ehd->ebcd", h, self.w2.to(cdt))
        out = out + self.b2.to(cdt)[:, None, None, :]
        y = torch.einsum("btec,ebcd->btd", combine.to(cdt), out)
        return reduce_group(y, self.expert_group), aux
