"""ViT-ED ("pjs"): two-stream ViT encoder-decoder for pair scoring
(``vit_ed_tpu/models/vit_ed.py``).

The calling modes of the reference forward are separate methods, as in the
JAX package: ``encode`` (stream 1 through the encoder, no CLS),
``prepare_x2`` (stream 2 patch-embedded with CLS + the full pos table),
``cross_part`` / ``cross_part_cls`` (the decoder), and the O(N^2) scan
decomposition ``prepare_x2_scan`` + ``context_kv_cache`` +
``score_tokens_row``. Images are NHWC [B, H, W, 3] float32 or uint8
(uint8 is normalized on the device); pairs stack on axis 1.

``dtype`` is the compute dtype (bfloat16 under AMP): images are cast to it
before the patch embedding and every activation stays in it; the
parameters stay float32 and are cast at use, as flax does.

Every method is differentiable except the shared-row scan op
``score_tokens_row`` (its kernel launch is eval-only, as in the JAX
package). The attention calls dispatch by geometry and then by device,
forward and backward alike (ops/attention.py): head_dim 64 with C % 128 == 0
takes the pair route, every other supported head_dim (16, 32, 64, 128) the
4-D route; CPU tensors run the route's plain versions, CUDA tensors launch
its kernels or raise. In training mode stochastic depth draws from
``drop_path_generator`` (seed it with ``seed_drop_path``), and with
``use_checkpoint`` every block is recomputed in the backward pass
(``TRAIN.USE_CHECKPOINT``, flax ``remat`` in the JAX package) with the
generator rewound so that the recomputed masks are the same. The other
dropouts are 0 in every config of the repo; they are taken as arguments
and training with a non-zero one raises (ROADMAP queue A item 8).

``keep_attn`` (``MODEL.PJS.KEEP_ATTN``) runs every attention on explicit
probabilities and keeps each module's map (``attention_maps``), as the JAX
model sows them; it also turns the CLS short-circuit off, since the maps
cover every row.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_ed_tpu_torch.models.layers import (
    Block,
    CrossBlock,
    Dropout,
    LayerNorm,
    Linear,
    PatchEmbed,
    ViTBase,
)


class ViTED(ViTBase):
    """Vision Transformer Encoder-Decoder (model type "pjs")."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, c_depth: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0, cls_shortcut: bool = True,
                 dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False, drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, fast_gelu: bool = False,
                 keep_attn: bool = False):
        super().__init__(dtype, use_checkpoint, pos_drop_rate=pos_drop_rate,
                         proj_drop_rate=proj_drop_rate,
                         attn_drop_rate=attn_drop_rate)
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.c_depth = c_depth
        self.num_heads = num_heads
        # CLS short-circuit: head-scoring paths compute only the CLS row of
        # the last decoder block (the same function; False re-runs the
        # full last block, as the JAX TPU.CLS_SHORTCUT switch does)
        self.cls_shortcut = cls_shortcut
        self.keep_attn = keep_attn

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 1e-6)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, self.num_patches + 1, embed_dim),
                                  std=0.02))
        dpr = torch.linspace(0, drop_path_rate, depth).tolist()
        dpr_cross = torch.linspace(0, drop_path_rate, c_depth).tolist()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values, dpr[i],
                  fast_gelu, keep_attn)
            for i in range(depth))
        self.cross_blocks = nn.ModuleList(
            CrossBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values,
                       dpr_cross[i], fast_gelu, keep_attn)
            for i in range(c_depth))
        self.norm = LayerNorm(embed_dim)
        self.head_drop = Dropout(drop_rate)
        self.head = Linear(embed_dim, num_classes)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    # ---------------------------------------------------------------- stream 1
    def encode(self, x1: torch.Tensor) -> torch.Tensor:
        """Encoder over image 1 without CLS -> [B, T, C]."""
        x = self._embed(x1)
        x = x + self.pos_embed[:, 1:].to(x.dtype)
        for blk in self.blocks:
            x = self._run(blk, x)
        return x

    # ---------------------------------------------------------------- stream 2
    def prepare_x2(self, x2: torch.Tensor) -> torch.Tensor:
        """Patch-embed image 2 WITH CLS + the full pos table -> [B, T+1, C]."""
        x = self._embed(x2)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1)
        return x + self.pos_embed.to(x.dtype)

    def cross_part(self, x1_feats: torch.Tensor, x2_tokens: torch.Tensor) -> torch.Tensor:
        """Decoder cross blocks + final norm."""
        for blk in self.cross_blocks:
            x2_tokens = self._run(blk, x2_tokens, x1_feats)
        return self.norm(x2_tokens)

    def cross_part_cls(self, x1_feats: torch.Tensor, x2_tokens: torch.Tensor) -> torch.Tensor:
        """``cross_part`` computing only the CLS row of the LAST block,
        [B, 1, C] — the head's sole input."""
        for blk in self.cross_blocks[:-1]:
            x2_tokens = self._run(blk, x2_tokens, x1_feats)
        return self.norm(self._run(self.cross_blocks[-1].cls_call, x2_tokens,
                                   x1_feats))

    @property
    def _cls_last(self) -> bool:
        """The last decoder block computes its CLS row only (not under
        ``keep_attn``, whose maps cover every row)."""
        return self.cls_shortcut and not self.keep_attn

    def attention_maps(self) -> dict:
        """{module name: its last [B, H, Sq, Sk] map} under ``keep_attn``
        (``blocks.i.attn``, ``cross_blocks.i.attn``,
        ``cross_blocks.i.cross_attn``)."""
        return {name: m.attn_map for name, m in self.named_modules()
                if getattr(m, "attn_map", None) is not None}

    def _head_scores(self, x1_feats: torch.Tensor, x2_tokens: torch.Tensor) -> torch.Tensor:
        part = self.cross_part_cls if self._cls_last else self.cross_part
        return self.forward_head(part(x1_feats, x2_tokens))

    # ---------------------------------------------------------------- heads
    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """CLS-token head, behind the head dropout in training."""
        return self.head(self.head_drop(x[:, 0]))

    def decode_head(self, x1_feats: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        """Pair logits from precomputed encoder features and raw image 2."""
        return self._head_scores(x1_feats, self.prepare_x2(x2))

    def score_tokens(self, x1_feats: torch.Tensor, x2_tokens: torch.Tensor) -> torch.Tensor:
        """Pair logits from encoder features and ``prepare_x2`` tokens."""
        return self._head_scores(x1_feats, x2_tokens)

    # -------------------------------------------------- O(N^2) scan methods
    def prepare_x2_scan(self, x2: torch.Tensor) -> torch.Tensor:
        """``prepare_x2`` advanced through decoder block 0's self-attention,
        which depends only on stream 2 (once per x2 batch, not per pair)."""
        return self.cross_blocks[0].self_part(self.prepare_x2(x2))

    def _scan_ladder(self, x: torch.Tensor, cross_fn) -> torch.Tensor:
        """Decoder ladder of the score_tokens_* variants: block 0's
        self-attention is hoisted into ``prepare_x2_scan``; the last block
        is CLS-only under the short-circuit. ``cross_fn(blk, i, x)`` is
        block i's cross-attention + MLP."""
        blocks = self.cross_blocks
        for i, blk in enumerate(blocks):
            last = i == len(blocks) - 1 and self._cls_last
            if i > 0:
                x = blk.cls_self_part(x) if last else blk.self_part(x)
            elif last:
                x = x[:, :1]
            x = cross_fn(blk, i, x)
        return x

    def score_tokens_scan(self, x1_feats: torch.Tensor, x2_advanced: torch.Tensor) -> torch.Tensor:
        """Pair logits from ``prepare_x2_scan`` outputs and per-pair
        encoder features."""
        x = self._scan_ladder(x2_advanced,
                              lambda blk, i, x: blk.cross_mlp(x, x1_feats))
        return self.forward_head(self.norm(x))

    def context_kv_cache(self, x1_feats: torch.Tensor) -> torch.Tensor:
        """Per-cross-block K/V projections of the encoder features, stacked
        [c_depth, B, Sk, 2C]: the work of the decoder that depends on x1
        only, done once per x1 row block."""
        return torch.stack([blk.context_kv(x1_feats) for blk in self.cross_blocks])

    def score_tokens_kv(self, kv_cache: torch.Tensor, x2_advanced: torch.Tensor) -> torch.Tensor:
        """Pair logits from per-pair ``context_kv_cache`` slices
        [c_depth, B, Sk, 2C] and ``prepare_x2_scan`` outputs."""
        x = self._scan_ladder(
            x2_advanced, lambda blk, i, x: blk.cross_mlp_kv(x, kv_cache[i]))
        return self.forward_head(self.norm(x))

    def score_tokens_row(self, kv_cache_row: torch.Tensor, x2_advanced: torch.Tensor) -> torch.Tensor:
        """Pair logits for a chunk of pairs that share ONE x1 row:
        ``kv_cache_row`` is ``context_kv_cache`` of a single encoder row
        [c_depth, 1, Sk, 2C], ``x2_advanced`` a ``prepare_x2_scan`` batch
        [B, Sq, C]. The row-sharded O(N^2) scan's inner op."""
        x = self._scan_ladder(
            x2_advanced,
            lambda blk, i, x: blk.cross_mlp_kv_shared(x, kv_cache_row[i]))
        return self.forward_head(self.norm(x))

    def forward(self, x: torch.Tensor, x2: Optional[torch.Tensor] = None,
                forward_first_part: bool = False) -> torch.Tensor:
        """Reference forward dispatch:

        - ``forward_first_part=True``: x is a batch of images -> encoder feats
        - ``x2 is not None``: x is encoder feats, x2 raw images -> pair logits
        - else: x is a stacked pair [B, 2, H, W, 3] -> pair logits
        """
        if forward_first_part:
            return self.encode(x)
        if x2 is not None:
            return self.decode_head(x, x2)
        return self.decode_head(self.encode(x[:, 0]), x[:, 1])
