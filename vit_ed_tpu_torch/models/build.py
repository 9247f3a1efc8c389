"""Model factory keyed on MODEL.TYPE (``vit_ed_tpu/models/build.py``).

Builds the pjs ViT-ED (the pair scorer of every pair path) and the plain
ViT (the embedding model of the triplet baselines). Other model types and
the options not ported yet raise NotImplementedError naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

from typing import Union

import torch

from vit_ed_tpu_torch.models.vit import ViT
from vit_ed_tpu_torch.models.vit_ed import ViTED

BUILT_TYPES = ("pjs", "vit")


def compute_dtype(config) -> torch.dtype:
    return torch.bfloat16 if config.AMP_ENABLE else torch.float32


def _unported(config):
    """(switched-on option, ROADMAP item) pairs this slice does not run."""
    pjs, tpu = config.MODEL.PJS, config.TPU
    checks = [
        (pjs.KEEP_ATTN, "MODEL.PJS.KEEP_ATTN", "queue A item 10 (ops/explain.py)"),
        (pjs.MOE.EXPERTS > 0, "MODEL.PJS.MOE.EXPERTS", "queue A item 12"),
        (tpu.INT8_SCORE, "TPU.INT8_SCORE", "queue A item 9 (ops/quant.py)"),
        (tpu.SEQ_PARALLEL, "TPU.SEQ_PARALLEL", "queue A item 12"),
        (tpu.RING_ATTN, "TPU.RING_ATTN", "queue A item 12"),
        (tpu.FSDP, "TPU.FSDP", "queue A item 12"),
        (tpu.TENSOR_PARALLEL, "TPU.TENSOR_PARALLEL", "queue A item 12"),
        (tpu.EXPERT_PARALLEL, "TPU.EXPERT_PARALLEL", "queue A item 12"),
        (tpu.PIPELINE_STAGES > 1, "TPU.PIPELINE_STAGES", "queue A item 12"),
        (tpu.FAST_GELU, "TPU.FAST_GELU", "slice 1 leftovers: the tanh GELU"),
        (not tpu.USE_PALLAS_ATTENTION, "TPU.USE_PALLAS_ATTENTION False",
         "none: the port always runs its attention kernel on the card"),
    ]
    return [(name, item) for on, name, item in checks if on]


def build_model(config, device=None) -> Union[ViTED, ViT]:
    """Build the MODEL.TYPE model on ``device`` (float32 parameters; the
    compute dtype follows AMP_ENABLE)."""
    if config.MODEL.TYPE not in BUILT_TYPES:
        raise NotImplementedError(
            f"MODEL.TYPE {config.MODEL.TYPE!r} is not ported yet "
            f"(ROADMAP queue A item 8); {' and '.join(map(repr, BUILT_TYPES))} are")
    unported = _unported(config)
    if unported:
        name, item = unported[0]
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP {item})")
    if config.MODEL.TYPE == "vit":
        vit = config.MODEL.VIT
        model = ViT(
            img_size=config.DATA.IMG_SIZE,
            patch_size=vit.PATCH_SIZE,
            in_chans=vit.IN_CHANS,
            num_classes=config.MODEL.NUM_CLASSES,
            embed_dim=vit.EMBED_DIM,
            depth=vit.DEPTH,
            num_heads=vit.NUM_HEADS,
            mlp_ratio=vit.MLP_RATIO,
            qkv_bias=vit.QKV_BIAS,
            drop_path_rate=config.MODEL.DROP_PATH_RATE,
            dtype=compute_dtype(config),
            use_checkpoint=config.TRAIN.USE_CHECKPOINT,
            drop_rate=config.MODEL.DROP_RATE,
        )
        return model.to(device) if device is not None else model
    pjs = config.MODEL.PJS
    model = ViTED(
        img_size=config.DATA.IMG_SIZE,
        patch_size=pjs.PATCH_SIZE,
        in_chans=pjs.IN_CHANS,
        num_classes=config.MODEL.NUM_CLASSES,
        embed_dim=pjs.EMBED_DIM,
        depth=pjs.DEPTH,
        c_depth=pjs.C_DEPTH,
        num_heads=pjs.NUM_HEADS,
        mlp_ratio=pjs.MLP_RATIO,
        qkv_bias=pjs.QKV_BIAS,
        drop_path_rate=config.MODEL.DROP_PATH_RATE,
        cls_shortcut=config.TPU.CLS_SHORTCUT,
        dtype=compute_dtype(config),
        use_checkpoint=config.TRAIN.USE_CHECKPOINT,
        # the JAX factory feeds MODEL.DROP_RATE to the head dropout only
        drop_rate=config.MODEL.DROP_RATE,
    )
    return model.to(device) if device is not None else model
