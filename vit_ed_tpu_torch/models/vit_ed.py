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
package). The attention calls dispatch by device, forward and backward
alike (ops/attention.py): CPU tensors run the plain versions, CUDA tensors
launch the kernels or raise. In training mode stochastic depth draws from
``drop_path_generator`` (seed it with ``seed_drop_path``), and with
``use_checkpoint`` every block is recomputed in the backward pass
(``TRAIN.USE_CHECKPOINT``, flax ``remat`` in the JAX package) with the
generator rewound so that the recomputed masks are the same. The other
dropouts are 0 in every config of the repo; they are taken as arguments
and training with a non-zero one raises (ROADMAP).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vit_ed_tpu_torch.models.layers import (
    Block,
    CrossBlock,
    DropPath,
    LayerNorm,
    Linear,
    PatchEmbed,
)


class ViTED(nn.Module):
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
                 attn_drop_rate: float = 0.0):
        super().__init__()
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.c_depth = c_depth
        self.num_heads = num_heads
        # CLS short-circuit: head-scoring paths compute only the CLS row of
        # the last decoder block (the same function; False re-runs the
        # full last block, as the JAX TPU.CLS_SHORTCUT switch does)
        self.cls_shortcut = cls_shortcut
        self.dtype = dtype
        self.use_checkpoint = use_checkpoint
        self.dropouts = {"drop_rate": drop_rate, "pos_drop_rate": pos_drop_rate,
                         "proj_drop_rate": proj_drop_rate,
                         "attn_drop_rate": attn_drop_rate}
        self.drop_path_generator: Optional[torch.Generator] = None

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 1e-6)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, self.num_patches + 1, embed_dim),
                                  std=0.02))
        dpr = torch.linspace(0, drop_path_rate, depth).tolist()
        dpr_cross = torch.linspace(0, drop_path_rate, c_depth).tolist()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values, dpr[i])
            for i in range(depth))
        self.cross_blocks = nn.ModuleList(
            CrossBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values,
                       dpr_cross[i])
            for i in range(c_depth))
        self.norm = LayerNorm(embed_dim)
        self.head = Linear(embed_dim, num_classes)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    # ---------------------------------------------------------------- training
    def seed_drop_path(self, seed: int) -> torch.Generator:
        """Create the stochastic-depth generator on the model's device,
        seed it and hand it to every DropPath; returns it (its state goes
        into checkpoints)."""
        gen = torch.Generator(device=self.pos_embed.device)
        gen.manual_seed(seed)
        self.drop_path_generator = gen
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = gen
        return gen

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
        dtype (as ViTED._embed of the JAX package)."""
        if self.training and any(self.dropouts.values()):
            on = sorted(k for k, v in self.dropouts.items() if v)
            raise NotImplementedError(
                f"training with non-zero {on} is not ported yet (ROADMAP: "
                f"what the training slice left out); every config of the repo keeps "
                f"them at 0")
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - 0.5) / 0.5
        return self.patch_embed(x.to(self.dtype))

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

    def _head_scores(self, x1_feats: torch.Tensor, x2_tokens: torch.Tensor) -> torch.Tensor:
        part = self.cross_part_cls if self.cls_shortcut else self.cross_part
        return self.forward_head(part(x1_feats, x2_tokens))

    # ---------------------------------------------------------------- heads
    def forward_head(self, x: torch.Tensor) -> torch.Tensor:
        """CLS-token head."""
        return self.head(x[:, 0])

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
            last = i == len(blocks) - 1 and self.cls_shortcut
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
