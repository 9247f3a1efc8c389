"""ViT building blocks of the port (``vit_ed_tpu/models/layers.py``).

Module and parameter names follow the reference timm layout
(``blocks.0.attn.qkv.weight``, ``cross_blocks.3.cross_attn.kv.bias``, ...),
so converted JAX params and reference ``.pth`` files load with
``strict=True``.

Numerics follow flax with a compute dtype, which is what the JAX package
runs. Parameters stay float32 and are cast to the activation dtype at
use; the chosen rounding points, on bf16 activations:

- ``Linear``: ``round(round(x @ W) + round(b))`` — flax ``Dense`` rounds
  the product and then adds the bias in bf16 (``F.linear`` with a bias
  would round once);
- ``LayerNorm``: statistics, normalisation, scale and bias in float32,
  one rounding at the end (flax computes its statistics in f32);
- ``PatchEmbed``: the conv in bf16 (f32 accumulate), then the bf16 bias;
- GELU: the bf16 chains of ops/gelu.py (the exact one, or the tanh one
  under ``TPU.FAST_GELU``);
- residual adds and LayerScale in bf16, as flax does on bf16 streams.

In float32 every one of these is the plain float32 computation.

Three switches of the JAX package's layers are ported:

- the int8 route of ``Linear`` (``ops/quant.py``), which a scorer turns on
  for the blocks of its model while it scores (``TPU.INT8_SCORE``);
- ``keep_attn`` of the attention modules (``MODEL.PJS.KEEP_ATTN``): the
  explicit probabilities of ``ops.attention.attention_probs`` instead of the
  fused kernels, each call's [B, H, Sq, Sk] map kept in the module's
  ``attn_map`` (flax sows it into ``intermediates``);
- the expert bank of ``Block`` (``models/moe.py``, ``MODEL.PJS.MOE``),
  whose aux terms ``Block.forward_aux`` returns beside the block's output.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_ed_tpu_torch.ops.attention import (
    attention_probs,
    fused_attention_packed_kv,
    fused_attention_packed_kv_shared,
    fused_attention_packed_qkv,
    fused_attention_packed_qkv_cls,
)
from vit_ed_tpu_torch.models.moe import MoeMlp
from vit_ed_tpu_torch.ops.gelu import gelu_exact, gelu_tanh
from vit_ed_tpu_torch.ops.quant import int8_linear
from vit_ed_tpu_torch.parallel.mesh import enter_group, reduce_group


class Linear(nn.Module):
    """Dense layer with flax's bf16 rounding (see module docstring). While
    ``int8_weight`` holds the quantized weight
    (``ops.quant.int8_gemms``), the layer is the dynamic int8 GEMM.

    Tensor-parallel (``parallel/tp.py``): a column-parallel layer's input
    enters its ``enter_group``; a row-parallel layer's product is summed
    over its ``reduce_group`` before the bias is added once."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None
        nn.init.trunc_normal_(self.weight, std=0.02)
        self.int8_weight: Optional[Tuple[torch.Tensor, ...]] = None
        self.enter_group = None
        self.reduce_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8_weight is not None:
            return int8_linear(x, *self.int8_weight, self.bias)
        y = F.linear(enter_group(x, self.enter_group), self.weight.to(x.dtype))
        y = reduce_group(y, self.reduce_group)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """LayerNorm computed in float32 and rounded once to the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__(dim, eps=eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm DropPath semantics): in training
    mode one Bernoulli(1 - rate) draw per sample, ``x / keep`` where kept
    and zero elsewhere; the identity in eval mode or at rate 0.

    The draws come from ``generator``, an explicit ``torch.Generator`` on
    the activations' device that the model owns and the trainer seeds
    (``ViTED.seed_drop_path``); the global RNG is never touched.

    Data-parallel over several processes (``shard_draws``), x holds rank
    ``r``'s rows of a global batch of ``world`` equal local batches: the
    module draws the global batch's mask from the generator, whose state
    is alike on every rank, and keeps rows [r x B, (r + 1) x B), so that
    the ranks together draw what one process on the global batch draws."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.shard = (0, 1)   # (rank, world) of the rows x holds

    def mask_shape(self, x: torch.Tensor):
        return (x.shape[0],) + (1,) * (x.ndim - 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError(
                f"{type(self).__name__} in training mode needs a seeded "
                f"generator: call the model's seed_drop_path(seed) after "
                f"moving the model to its device")
        keep = 1.0 - self.rate
        rank, world = self.shard
        shape = self.mask_shape(x)
        mask = torch.bernoulli(
            torch.full((shape[0] * world,) + tuple(shape[1:]), keep,
                       dtype=torch.float32, device=x.device),
            generator=self.generator)
        if world > 1:
            mask = mask[rank * shape[0]:(rank + 1) * shape[0]]
        return torch.where(mask.bool(), x / keep, torch.zeros_like(x))


class Dropout(DropPath):
    """Element-wise dropout (flax ``nn.Dropout``): DropPath with one draw per
    element, from the same model-owned generator."""

    def mask_shape(self, x: torch.Tensor):
        return x.shape


def shard_draws(model: nn.Module, rank: int, world: int) -> None:
    """Make every module of ``model`` that draws per sample (DropPath,
    Dropout, the MoE router's jitter: each with a ``shard`` attribute) draw
    share ``rank``'s rows of the draws of a global batch of ``world`` equal
    shares. The trainer passes the mesh's data index and data size: the
    ``model`` and ``expert`` peers of one data index draw the same rows."""
    for m in model.modules():
        if hasattr(m, "shard"):
            m.shard = (rank, world)


def normalize_images(x: torch.Tensor) -> torch.Tensor:
    """uint8 images -> float32 with the canonical (x/255 - 0.5)/0.5 (the u8
    wire of ``TPU.DEVICE_NORMALIZE``); float images pass through."""
    if x.dtype == torch.uint8:
        return (x.float() / 255.0 - 0.5) / 0.5
    return x


def seed_generators(model: nn.Module, seed: int) -> torch.Generator:
    """Create one generator on the device of ``model``'s parameters, seed
    it with ``seed`` and hand it to every module of the model that draws
    (DropPath, Dropout and the MoE router's jitter: each module with a
    ``generator`` attribute); returns it (its state goes into
    checkpoints)."""
    gen = torch.Generator(device=next(model.parameters()).device)
    gen.manual_seed(seed)
    for m in model.modules():
        if hasattr(m, "generator"):
            m.generator = gen
    return gen


class PatchEmbed(nn.Module):
    """Conv patch embedding: NHWC image [B, H, W, 3] -> tokens [B, T, D]."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768):
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.proj.weight.to(x.dtype)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, stride=self.proj.stride)
        y = y + self.proj.bias.to(x.dtype)[:, None, None]
        return y.flatten(2).transpose(1, 2)


class Mlp(nn.Module):
    """fc1 -> GELU (exact, or tanh with ``fast_gelu``) -> fc2 (timm Mlp; its
    dropouts take the projection dropout rate, which no config of the repo
    reaches, see ViTBase)."""

    def __init__(self, dim: int, hidden_dim: int, fast_gelu: bool = False):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)
        self.act = gelu_tanh if fast_gelu else gelu_exact

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class LayerScale(nn.Module):
    """Learned per-channel residual scaling."""

    def __init__(self, dim: int, init_values: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


def _scale(dim: int, init_values: Optional[float]) -> nn.Module:
    return LayerScale(dim, init_values) if init_values else nn.Identity()


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).transpose(1, 2)


def _explicit_attention(mod: nn.Module, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """The JAX package's explicit path on the packed layout: float32
    probabilities (kept in ``mod.attn_map``), rounded to the value dtype
    for the PV product; [B, Sq, C] out."""
    qh, kh, vh = (_split_heads(t, mod.num_heads) for t in (q, k, v))
    attn = attention_probs(qh, kh)
    mod.attn_map = attn
    out = torch.matmul(attn.to(vh.dtype), vh)
    b, h, n, d = out.shape
    return out.transpose(1, 2).reshape(b, n, h * d)


class Attention(nn.Module):
    """Multi-head self-attention on the fused qkv projection; with
    ``keep_attn`` on the explicit probabilities (module docstring).
    ``route_dim`` is the unsharded width that picks the kernels' route
    (None: this module's own; tensor-parallel modules hold a share of the
    heads, ``parallel/tp.py``)."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 keep_attn: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.route_dim: Optional[int] = None
        self.keep_attn = keep_attn
        self.attn_map: Optional[torch.Tensor] = None
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, cls_only: bool = False) -> torch.Tensor:
        """``cls_only=True`` returns the output of the FIRST (CLS) query row
        only, [B, 1, C]; its keys and values still cover the whole
        sequence (the pair scan's last-decoder-block short-circuit)."""
        qkv = self.qkv(x)
        if self.keep_attn:
            out = _explicit_attention(self, *qkv.chunk(3, dim=-1))
            if cls_only:
                out = out[:, :1]
        elif cls_only:
            out = fused_attention_packed_qkv_cls(qkv, self.num_heads, width=self.route_dim)
        else:
            out = fused_attention_packed_qkv(qkv, self.num_heads, width=self.route_dim)
        return self.proj(out)


class CrossAttention(nn.Module):
    """Q from the decoder stream, K/V from the encoder context, split into
    ``kv_for`` (the context-only fused K/V projection, computed once per
    x1 row by the pair scan) and ``attend_kv`` / ``attend_kv_shared``."""

    def __init__(self, dim: int, num_heads: int = 8, qkv_bias: bool = False,
                 keep_attn: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.route_dim: Optional[int] = None     # as Attention's
        self.keep_attn = keep_attn
        self.attn_map: Optional[torch.Tensor] = None
        self.q = Linear(dim, dim, bias=qkv_bias)
        self.kv = Linear(dim, dim * 2, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def kv_for(self, context: torch.Tensor) -> torch.Tensor:
        return self.kv(context)

    def attend_kv(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """Attention against a per-pair precomputed kv [B, Sk, 2C]."""
        if self.keep_attn:
            return self.proj(_explicit_attention(self, self.q(x), *kv.chunk(2, dim=-1)))
        return self.proj(fused_attention_packed_kv(self.q(x), kv, self.num_heads,
                                                   width=self.route_dim))

    def attend_kv_shared(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """``attend_kv`` where ONE context kv [1, Sk, 2C] serves the whole
        batch (the row-sharded O(N^2) scan chunk); with ``keep_attn`` the
        explicit path on the broadcast kv, as in the JAX package."""
        if self.keep_attn:
            return self.attend_kv(x, kv.expand(x.shape[0], -1, -1))
        return self.proj(fused_attention_packed_kv_shared(self.q(x), kv, self.num_heads,
                                                          width=self.route_dim))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return self.attend_kv(x, self.kv_for(context))


class Block(nn.Module):
    """Pre-LN transformer encoder block. ``moe`` (the keyword arguments of
    ``models.moe.MoeMlp`` past its widths: ``num_experts``,
    ``capacity_factor``, ``route_k``, ``jitter``) swaps the MLP for an
    expert bank."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, init_values: Optional[float] = None,
                 drop_path: float = 0.0, fast_gelu: bool = False,
                 keep_attn: bool = False, moe: Optional[dict] = None):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, keep_attn)
        self.ls1 = _scale(dim, init_values)
        self.drop_path1 = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        if moe:
            self.mlp = MoeMlp(dim, int(dim * mlp_ratio), fast_gelu=fast_gelu, **moe)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), fast_gelu)
        self.ls2 = _scale(dim, init_values)
        self.drop_path2 = DropPath(drop_path)

    def forward_aux(self, x: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The block and its expert bank's aux terms [2] (None for a
        dense MLP), both values of the call."""
        x = x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))
        y, aux = self.mlp(self.norm2(x)), None
        if isinstance(y, tuple):
            y, aux = y
        return x + self.drop_path2(self.ls2(y)), aux

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_aux(x)[0]


class CrossBlock(nn.Module):
    """Decoder block: self-attn -> cross-attn(context) -> MLP, split into
    the parts the O(N^2) pair scan schedules separately."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = False, init_values: Optional[float] = None,
                 drop_path: float = 0.0, fast_gelu: bool = False,
                 keep_attn: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, qkv_bias, keep_attn)
        self.ls1 = _scale(dim, init_values)
        self.drop_path1 = DropPath(drop_path)
        self.norm_cross = LayerNorm(dim)
        self.norm_context = LayerNorm(dim)
        self.cross_attn = CrossAttention(dim, num_heads, qkv_bias, keep_attn)
        self.ls_cross = _scale(dim, init_values)
        self.drop_path_cross = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), fast_gelu)
        self.ls2 = _scale(dim, init_values)
        self.drop_path2 = DropPath(drop_path)

    def self_part(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop_path1(self.ls1(self.attn(self.norm1(x))))

    def context_kv(self, context: torch.Tensor) -> torch.Tensor:
        """norm_context + fused K/V projection: depends on the encoder
        features only, so the scan computes it once per x1 row."""
        return self.cross_attn.kv_for(self.norm_context(context))

    def _mlp(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_path_cross(self.ls_cross(y))
        return x + self.drop_path2(self.ls2(self.mlp(self.norm2(x))))

    def cross_mlp_kv(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """cross-attention + MLP with a precomputed ``context_kv``."""
        return self._mlp(x, self.cross_attn.attend_kv(self.norm_cross(x), kv))

    def cross_mlp_kv_shared(self, x: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        """``cross_mlp_kv`` with ONE shared ``context_kv`` row [1, Sk, 2C]."""
        return self._mlp(
            x, self.cross_attn.attend_kv_shared(self.norm_cross(x), kv))

    def cls_self_part(self, x: torch.Tensor) -> torch.Tensor:
        """``self_part`` producing only the CLS row [B, 1, C] — valid for
        the LAST decoder block of a scoring pass, whose other rows feed
        nothing."""
        y = self.attn(self.norm1(x), cls_only=True)
        return x[:, :1] + self.drop_path1(self.ls1(y))

    def cross_mlp(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return self.cross_mlp_kv(x, self.context_kv(context))

    def cls_call(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        """Whole block producing only the CLS row [B, 1, C]."""
        return self.cross_mlp(self.cls_self_part(x), context)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        return self.cross_mlp(self.self_part(x), context)


class ViTBase(nn.Module):
    """What the port's transformers (``ViTED``, ``ViT``) share in training:
    the compute dtype, the model-owned generator of DropPath and the head
    dropout, block recomputation under ``use_checkpoint`` and the image
    embedding. ``dropouts`` are the position, projection and attention
    dropout rates: no config key reaches them (the JAX factory passes
    ``MODEL.DROP_RATE`` to the head dropout only), they are taken as
    arguments, and training with a non-zero one raises (ROADMAP queue A
    item 8)."""

    def __init__(self, dtype: torch.dtype, use_checkpoint: bool, **dropouts: float):
        super().__init__()
        self.dtype = dtype
        self.use_checkpoint = use_checkpoint
        self.dropouts = dropouts
        self.drop_path_generator: Optional[torch.Generator] = None

    def seed_drop_path(self, seed: int) -> torch.Generator:
        """Seed the generator of every DropPath and Dropout
        (``seed_generators``); returns it."""
        self.drop_path_generator = seed_generators(self, seed)
        return self.drop_path_generator

    def _run(self, fn, *args: torch.Tensor) -> torch.Tensor:
        """``fn(*args)``, recomputed in the backward pass when
        ``use_checkpoint`` is set and a graph is being recorded. The
        recomputation rewinds the DropPath generator to where the first
        run found it (and puts it back after), so both runs draw the same
        masks."""
        if not (self.use_checkpoint and self.training
                and torch.is_grad_enabled()):
            return fn(*args)
        gen = self.drop_path_generator
        before = None if gen is None else gen.get_state()
        first = [True]

        def run(*a):
            if first[0] or gen is None:
                first[0] = False
                return fn(*a)
            after = gen.get_state()
            gen.set_state(before)
            try:
                return fn(*a)
            finally:
                gen.set_state(after)

        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 images normalize on the device with the canonical
        (x/255 - 0.5)/0.5 in float32, before the cast to the compute
        dtype (as ``_embed`` of the JAX models)."""
        if self.training and any(self.dropouts.values()):
            on = sorted(k for k, v in self.dropouts.items() if v)
            raise NotImplementedError(
                f"training with non-zero {on} is not ported yet (ROADMAP queue A "
                f"item 8); no config key reaches them")
        return self.patch_embed(normalize_images(x).to(self.dtype))
