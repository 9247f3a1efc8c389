"""Plain ViT ("vit"): the embedding model of the triplet baselines
(``vit_ed_tpu/models/vit.py``), the timm VisionTransformer with
``NUM_CLASSES`` as the embedding width.

Images are NHWC [B, H, W, 3] float32 or uint8 (uint8 is normalized on the
device, the u8 wire of ``TPU.DEVICE_NORMALIZE``). The CLS token and the
patch tokens run through ``depth`` encoder blocks (``models/layers.py``),
the final LayerNorm, and the head on the CLS row. Numerics, the compute
dtype, stochastic depth from the model-owned generator and recomputation
under ``use_checkpoint`` are those of ``ViTED`` (``ViTBase``). Attention
goes through ``Attention``'s dispatch: head_dim 64 with C % 128 == 0 takes
the pair route (``csrc/pair_attention.cu``), every other supported
head_dim the 4-D route (``csrc/heads_attention.cu``); the backward is
``csrc/heads_attention_bwd.cu`` on both.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vit_ed_tpu_torch.models.layers import (
    Block,
    LayerNorm,
    Linear,
    PatchEmbed,
    ViTBase,
)


class ViT(ViTBase):
    """Vision Transformer embedding model (model type "vit")."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_chans: int = 3, num_classes: int = 1000,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 init_values: Optional[float] = None,
                 drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False, drop_rate: float = 0.0,
                 pos_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, fast_gelu: bool = False):
        # drop_rate (MODEL.DROP_RATE) is taken and unused: the JAX ViT
        # builds no head dropout
        super().__init__(dtype, use_checkpoint, pos_drop_rate=pos_drop_rate,
                         proj_drop_rate=proj_drop_rate,
                         attn_drop_rate=attn_drop_rate)
        self.img_size = img_size
        self.patch_size = patch_size
        self.embed_dim = embed_dim
        self.num_heads = num_heads

        self.patch_embed = PatchEmbed(patch_size, in_chans, embed_dim)
        self.cls_token = nn.Parameter(torch.randn(1, 1, embed_dim) * 1e-6)
        self.pos_embed = nn.Parameter(
            nn.init.trunc_normal_(torch.empty(1, self.num_patches + 1, embed_dim),
                                  std=0.02))
        # the JAX model's float64 linspace
        dpr = np.linspace(0, drop_path_rate, depth).tolist()
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio, qkv_bias, init_values, dpr[i],
                  fast_gelu)
            for i in range(depth))
        self.norm = LayerNorm(embed_dim)
        self.head = Linear(embed_dim, num_classes)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    def forward_features(self, x: torch.Tensor) -> torch.Tensor:
        """CLS + patch tokens through the blocks and the final norm ->
        [B, T+1, C]."""
        x = self._embed(x)
        cls = self.cls_token.to(x.dtype).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = self._run(blk, x)
        return self.norm(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Embeddings [B, num_classes] from the CLS row."""
        return self.head(self.forward_features(x)[:, 0])
