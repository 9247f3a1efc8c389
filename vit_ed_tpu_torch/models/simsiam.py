"""SimSiam self-supervised baselines (``vit_ed_tpu/models/simsiam.py``): a
ResNet encoder, a 3-layer projector ending in an affine-free BatchNorm and a
2-layer predictor. ``SimSiam`` (type ``ss``) takes two views
[B, 2, H, W, 3], ``SimSiamV2`` (``ss2``) one view [B, H, W, 3], and
``SimSiamV2CE`` (``ss2ce``) adds a classifier head on the pooled features.

Names are the flax ones (``encoder``, ``projector`` — ``fc`` in
``SimSiamV2CE`` —, ``predictor``, ``cls_fc1`` ...), so converted flax
variables load with ``strict=True`` (``models/convert.py``). The layers and
their numerics are those of ``models/resnet.py``; the dropouts draw from
the model-owned generator (``seed_drop_path``) and ``stop_gradient``
becomes ``detach``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_ed_tpu_torch.models.layers import Dropout
from vit_ed_tpu_torch.models.resnet import ARCHS, BatchNorm, ConvModel, Dense, ResNet


class Projector(nn.Module):
    """fc1 -> BN -> ReLU -> dropout -> fc2 -> BN -> ReLU -> fc3 -> BN
    without scale or bias."""

    def __init__(self, dim: int, prev_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(prev_dim, prev_dim, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(prev_dim)
        self.drop = Dropout(dropout)
        self.fc2 = Dense(prev_dim, prev_dim, bias=False, dtype=dtype)
        self.bn2 = BatchNorm(prev_dim)
        self.fc3 = Dense(prev_dim, dim, dtype=dtype)
        self.bn3 = BatchNorm(dim, affine=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.drop(F.relu(self.bn1(self.fc1(x))))
        x = F.relu(self.bn2(self.fc2(x)))
        return self.bn3(self.fc3(x))


class Predictor(nn.Module):
    """fc1 -> BN -> ReLU -> fc2."""

    def __init__(self, dim: int, pred_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, pred_dim, bias=False, dtype=dtype)
        self.bn1 = BatchNorm(pred_dim)
        self.fc2 = Dense(pred_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.relu(self.bn1(self.fc1(x))))


class SimSiam(ConvModel):
    """Two-view SimSiam: [B, 2, H, W, 3] -> (p1, p2, z1.detach(),
    z2.detach())."""

    projector_name = "projector"

    def __init__(self, arch: str = "resnet34", dim: int = 2048, pred_dim: int = 512,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.prev_dim = ARCHS[arch][2]
        self.encoder = ResNet(arch, (), dtype)
        self.add_module(self.projector_name,
                        Projector(dim, self.prev_dim, dropout, dtype))
        self.predictor = Predictor(dim, pred_dim, dtype)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """Globally pooled encoder features [B, prev_dim]."""
        return self.encoder(x).mean(dim=(2, 3))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return getattr(self, self.projector_name)(self.features(x))

    def forward(self, x: torch.Tensor):
        z1 = self.encode(x[:, 0])
        z2 = self.encode(x[:, 1])
        return self.predictor(z1), self.predictor(z2), z1.detach(), z2.detach()


class SimSiamV2(SimSiam):
    """Single view: [B, H, W, 3] -> (p1, z1.detach())."""

    def forward(self, x: torch.Tensor):
        z1 = self.encode(x)
        return self.predictor(z1), z1.detach()


class SimSiamV2CE(SimSiam):
    """``SimSiamV2`` plus a classifier on the pooled features:
    [B, H, W, 3] -> (p1, z1.detach(), class logits)."""

    projector_name = "fc"

    def __init__(self, arch: str = "resnet34", n_classes: int = 0, dim: int = 2048,
                 pred_dim: int = 512, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__(arch, dim, pred_dim, dropout, dtype)
        prev = self.prev_dim
        self.cls_fc1 = Dense(prev, prev, bias=False, dtype=dtype)
        self.cls_bn1 = BatchNorm(prev)
        self.cls_drop = Dropout(dropout)
        self.cls_fc2 = Dense(prev, prev // 2, bias=False, dtype=dtype)
        self.cls_bn2 = BatchNorm(prev // 2)
        self.cls_fc3 = Dense(prev // 2, n_classes, dtype=dtype)

    def forward(self, x: torch.Tensor):
        f = self.features(x)
        z1 = self.fc(f)
        c = self.cls_drop(F.relu(self.cls_bn1(self.cls_fc1(f))))
        c = self.cls_fc3(F.relu(self.cls_bn2(self.cls_fc2(c))))
        return self.predictor(z1), z1.detach(), c


def build_simsiam(config, model_type: str, dtype: torch.dtype) -> SimSiam:
    ss = config.MODEL.SS
    kwargs = dict(arch=ss.ARCH, dim=ss.EMBED_DIM, pred_dim=ss.PRED_DIM,
                  dropout=ss.DROPOUT, dtype=dtype)
    if model_type == "ss":
        return SimSiam(**kwargs)
    if model_type == "ss2":
        return SimSiamV2(**kwargs)
    if model_type == "ss2ce":
        return SimSiamV2CE(n_classes=ss.N_CLASSES, **kwargs)
    raise NotImplementedError(model_type)
