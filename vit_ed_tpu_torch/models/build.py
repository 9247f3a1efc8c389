"""Model factory keyed on MODEL.TYPE (``vit_ed_tpu/models/build.py``).

Builds every type of the JAX factory: the pjs ViT-ED (the pair scorer of
every pair path), the plain ViT (the embedding model of the triplet
baselines), and the BatchNorm baselines ``ss`` / ``ss2`` / ``ss2ce``
(SimSiam, models/simsiam.py) and ``resnet`` / ``mixconv``
(models/resnet.py); ``MODEL.PJS.MOE`` gives the pjs model its encoder
expert banks (models/moe.py; the other types build dense, as in the JAX
factory). ``TPU.FSDP``, ``TENSOR_PARALLEL`` and ``EXPERT_PARALLEL`` build
the whole model, which the trainer shards (``parallel/compose.py``);
``SEQ_PARALLEL`` and ``RING_ATTN`` raise NotImplementedError naming ROADMAP
queue A item 12b part 2, ``PIPELINE_STAGES > 1`` part 3. ``TPU.INT8_SCORE`` is a
scoring switch, read by the entries that score (the scorer quantizes the
blocks' GEMMs while it scores), and builds the same model.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_ed_tpu_torch.models.resnet import build_resnet_model
from vit_ed_tpu_torch.models.simsiam import build_simsiam
from vit_ed_tpu_torch.models.vit import ViT
from vit_ed_tpu_torch.models.vit_ed import ViTED

BUILT_TYPES = ("pjs", "vit", "ss", "ss2", "ss2ce", "resnet", "mixconv")


def compute_dtype(config) -> torch.dtype:
    return torch.bfloat16 if config.AMP_ENABLE else torch.float32


def _unported(config):
    """(switched-on option, ROADMAP item) pairs the port does not run."""
    tpu = config.TPU
    checks = [
        (tpu.SEQ_PARALLEL, "TPU.SEQ_PARALLEL", "queue A item 12b part 2"),
        (tpu.RING_ATTN, "TPU.RING_ATTN", "queue A item 12b part 2"),
        (tpu.PIPELINE_STAGES > 1, "TPU.PIPELINE_STAGES", "queue A item 12b part 3"),
        (not tpu.USE_PALLAS_ATTENTION, "TPU.USE_PALLAS_ATTENTION False",
         "none: the port always runs its attention kernel on the card"),
    ]
    return [(name, item) for on, name, item in checks if on]


def build_model(config, device=None) -> nn.Module:
    """Build the MODEL.TYPE model on ``device`` (float32 parameters; the
    compute dtype follows AMP_ENABLE)."""
    model_type = config.MODEL.TYPE
    if model_type not in BUILT_TYPES:
        raise NotImplementedError(f"Unknown model: {model_type}")
    unported = _unported(config)
    if unported:
        name, item = unported[0]
        raise NotImplementedError(
            f"{name} is not ported yet (ROADMAP {item})")
    if model_type in ("ss", "ss2", "ss2ce"):
        model = build_simsiam(config, model_type, compute_dtype(config))
        return model.to(device) if device is not None else model
    if model_type in ("resnet", "mixconv"):
        model = build_resnet_model(config, model_type, compute_dtype(config))
        return model.to(device) if device is not None else model
    if model_type == "vit":
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
            fast_gelu=config.TPU.FAST_GELU,
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
        fast_gelu=config.TPU.FAST_GELU,
        keep_attn=pjs.KEEP_ATTN,
        moe_experts=pjs.MOE.EXPERTS,
        moe_interval=pjs.MOE.INTERVAL,
        moe_capacity=pjs.MOE.CAPACITY,
        moe_route_k=pjs.MOE.ROUTE_K,
        moe_jitter=pjs.MOE.JITTER,
    )
    return model.to(device) if device is not None else model
