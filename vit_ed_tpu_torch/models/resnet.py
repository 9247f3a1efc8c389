"""ResNet backbones and the MixConv aggregation baseline
(``vit_ed_tpu/models/resnet.py``), with flax's BatchNorm.

Module and parameter names are the flax ones (``conv1``, ``bn1``,
``layer2_0.downsample_conv``, ``agg.mix_0.token_mixer.dwconv``, ...), so
``models/convert.py::flax_variables_to_state_dict`` maps a flax
``params`` + ``batch_stats`` pair onto this tree by a fixed rule and it
loads with ``strict=True``.

Layout: images come in NHWC [B, H, W, 3] (float32, or uint8 normalized on
the device as the ViTs do); the backbone runs NCHW (``F.conv2d``, cuDNN on
the card) and the MixPool head NHWC, as the JAX modules do. The
convolutions and products are XLA ops in the JAX package, not Pallas
kernels, so they stay library calls here.

Numerics follow flax with a compute dtype:

- ``Conv2d`` and ``Dense`` cast their input and weight to the compute dtype
  (flax ``promote_dtype``); ``Dense`` rounds the product before adding the
  bias, as ``layers.Linear`` does;
- ``BatchNorm`` is flax's ``nn.BatchNorm``, not torch's: the statistics are
  computed in float32 (float64 for float64 input) from the input cast to
  it, the variance is the
  biased ``max(0, mean(x^2) - mean(x)^2)``, the normalisation
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` runs in float32 and is
  rounded once to the input's dtype; in training the running statistics
  become ``0.99 * old + 0.01 * batch``: the JAX modules build
  ``nn.BatchNorm`` with flax's default momentum, 0.99, the weight of the
  old value (``torch.nn.BatchNorm2d`` would take 0.1 of the batch and keep
  the unbiased variance);
- several processes (a process group of more than one rank) normalise by
  the global batch's statistics, as flax under jit over the global mesh
  does (SyncBN): one all-reduce per layer of ``[sum x, sum x^2, n]`` in the
  statistics dtype, with its gradient (``parallel.mesh.all_reduce_sum``),
  then ``mean = sum x / N`` and the biased variance ``max(0, sum x^2 / N -
  mean^2)``; the running statistics move by these global values, so they
  stay equal on every rank. Eval mode reads the running statistics alone;
- ``StarReLU`` squares in the input dtype and scales by its float32
  scalars, so its output is float32 (JAX's promotion, which torch's
  matches), as is the MetaFormer residual stream after the first
  LayerScale; ``LayerNorm`` rounds to the compute dtype.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vit_ed_tpu_torch.models.layers import Linear, normalize_images, seed_generators
from vit_ed_tpu_torch.parallel.mesh import all_reduce_sum, group_world

# arch -> (block, blocks per stage, channels out of the last stage)
ARCHS = {
    "resnet18": ("basic", (2, 2, 2, 2), 512),
    "resnet34": ("basic", (3, 4, 6, 3), 512),
    "resnet50": ("bottleneck", (3, 4, 6, 3), 2048),
    "resnet101": ("bottleneck", (3, 4, 23, 3), 2048),
    "resnet152": ("bottleneck", (3, 8, 36, 3), 2048),
}


def conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def backbone_size(img_size: int, model_name: str,
                  layers_to_crop: Sequence[int] = ()) -> int:
    """Side of the backbone's output map for a square ``img_size`` input:
    the stride-2 stem, the stride-2 max pool, and a stride-2 first block in
    every kept stage after the first."""
    s = conv_out(conv_out(img_size, 7, 2, 3), 3, 2, 1)
    for stage in range(1, len(ARCHS[model_name][1])):
        if stage + 1 not in layers_to_crop:
            s = conv_out(s, 3, 2, 1)
    return s


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """``x / max(||x||, 1e-12)`` over the last axis."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=1e-12)


class ConvModel(nn.Module):
    """What the BatchNorm model types share: ``dtype``, the compute dtype,
    and ``seed_drop_path``, the trainer's hook that seeds the model-owned
    generator of its dropouts (``layers.seed_generators``)."""

    def __init__(self, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype

    def seed_drop_path(self, seed: int) -> torch.Generator:
        return seed_generators(self, seed)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over axis 1 (the channels of NCHW maps and of
    [B, C] features); see the module docstring for its arithmetic."""

    def __init__(self, num_features: int, affine: bool = True,
                 momentum: float = 0.99, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_features)) if affine else None
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            dims = [0] + list(range(2, x.ndim))
            if group_world() > 1:
                c = xf.shape[1]
                sums = all_reduce_sum(torch.cat([
                    xf.sum(dims), (xf * xf).sum(dims),
                    xf.new_full((1,), xf.numel() // c)]))
                mean = sums[:c] / sums[2 * c]
                var = torch.clamp(sums[c:2 * c] / sums[2 * c] - mean * mean, min=0.0)
            else:
                mean = xf.mean(dims)
                var = torch.clamp((xf * xf).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.copy_(self.momentum * self.running_mean
                                        + (1 - self.momentum) * mean)
                self.running_var.copy_(self.momentum * self.running_var
                                       + (1 - self.momentum) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps)
        if self.weight is not None:
            mul = mul * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        if self.bias is not None:
            y = y + self.bias.reshape(shape)
        return y.to(x.dtype)


class Conv2d(nn.Module):
    """Bias-free NCHW convolution in the compute dtype (flax ``nn.Conv``
    with ``use_bias=False``); the weight is OIHW."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups, self.dtype = stride, padding, groups, dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, kernel, kernel))
        nn.init.kaiming_normal_(self.weight, mode="fan_out", nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), None,
                        self.stride, self.padding, 1, self.groups)


class Dense(Linear):
    """``layers.Linear`` with the input cast to the compute dtype first
    (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(dtype=...)``: float32 statistics, one rounding to
    the compute dtype (whatever the input's dtype)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, eps: float = 1e-6):
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        return F.layer_norm(xf, self.normalized_shape, self.weight.to(xf.dtype),
                            self.bias.to(xf.dtype), self.eps).to(self.dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_ch, filters, 3, stride, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, 1, 1, dtype=dtype)
        self.bn2 = BatchNorm(filters)
        # the JAX block adds the projection where the residual's shape
        # differs from the output's: a stride or a change of width
        if stride != 1 or in_ch != filters:
            self.downsample_conv = Conv2d(in_ch, filters, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = filters * 4
        self.conv1 = Conv2d(in_ch, filters, 1, dtype=dtype)
        self.bn1 = BatchNorm(filters)
        self.conv2 = Conv2d(filters, filters, 3, stride, 1, dtype=dtype)
        self.bn2 = BatchNorm(filters)
        self.conv3 = Conv2d(filters, out, 1, dtype=dtype)
        self.bn3 = BatchNorm(out)
        if stride != 1 or in_ch != out:
            self.downsample_conv = Conv2d(in_ch, out, 1, stride, dtype=dtype)
            self.downsample_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + residual)


class ResNet(nn.Module):
    """Feature-map backbone: NHWC images -> NCHW map [B, C, h, w] in the
    compute dtype, C = ``feature_channels``. ``layers_to_crop`` removes
    residual stages (1-based)."""

    def __init__(self, model_name: str = "resnet50",
                 layers_to_crop: Sequence[int] = (),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        kind, stage_sizes, _ = ARCHS[model_name]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = Conv2d(3, 64, 7, 2, 3, dtype=dtype)
        self.bn1 = BatchNorm(64)
        self.block_names: List[str] = []
        in_ch = 64
        for stage, n_blocks in enumerate(stage_sizes):
            if stage + 1 in layers_to_crop:
                continue
            for b in range(n_blocks):
                stride = 2 if stage > 0 and b == 0 else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block_cls(in_ch, 64 * 2 ** stage, stride, dtype))
                self.block_names.append(name)
                in_ch = 64 * 2 ** stage * block_cls.expansion
        self.feature_channels = in_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize_images(x).permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x


class ResNetWrapper(ConvModel):
    """Global average pool + L2-normalised embedding (model type
    ``resnet``)."""

    def __init__(self, backbone: str = "resnet34", dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.model = ResNet(backbone, (), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.model(x).mean(dim=(2, 3)))


class StarReLU(nn.Module):
    """``s * relu(x)^2 + b`` with float32 scalars s, b (flax's ``scale`` and
    ``bias``; ``weight`` here, as for the norms)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.weight * F.relu(x).square() + self.bias


class SepConv(nn.Module):
    """Inverted separable conv token mixer, NHWC in and out: pointwise
    Dense, StarReLU, a depthwise 7 x 7 conv (padding 3, one group per
    channel), pointwise Dense."""

    def __init__(self, dim: int, expansion_ratio: float = 2, kernel_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        med = int(expansion_ratio * dim)
        self.pwconv1 = Dense(dim, med, bias=False, dtype=dtype)
        self.act1 = StarReLU()
        self.dwconv = Conv2d(med, med, kernel_size, 1, 3, groups=med, dtype=dtype)
        self.pwconv2 = Dense(med, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.act1(self.pwconv1(x))
        x = self.dwconv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.pwconv2(x)


class MetaFormerMlp(nn.Module):
    def __init__(self, dim: int, mlp_ratio: float = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(dim, int(mlp_ratio * dim), bias=False, dtype=dtype)
        self.act = StarReLU()
        self.fc2 = Dense(int(mlp_ratio * dim), dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


class MetaFormerBlock(nn.Module):
    """SepConv token mixing and a StarReLU MLP, each behind a LayerNorm and
    a LayerScale (init 1e-5), NHWC."""

    def __init__(self, dim: int, layer_scale_init_value: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype)
        self.token_mixer = SepConv(dim, dtype=dtype)
        self.layer_scale1 = nn.Parameter(torch.full((dim,), layer_scale_init_value))
        self.norm2 = LayerNorm(dim, dtype)
        self.mlp = MetaFormerMlp(dim, dtype=dtype)
        self.layer_scale2 = nn.Parameter(torch.full((dim,), layer_scale_init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.token_mixer(self.norm1(x)) * self.layer_scale1
        return x + self.mlp(self.norm2(x)) * self.layer_scale2


class MixPool(nn.Module):
    """MetaFormer token-mixing aggregation: NHWC map [B, h, w, C] ->
    ``mix_depth`` blocks -> [B, h*w, C] (row-major over h, w) -> Dense to
    ``out_channels`` -> transpose -> Dense over the h*w positions to
    ``out_rows`` -> L2-normalised [B, out_channels * out_rows]."""

    def __init__(self, in_h: int, in_w: int, in_channels: int, out_channels: int = 512,
                 mix_depth: int = 4, out_rows: int = 2, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mix_depth = mix_depth
        for i in range(mix_depth):
            self.add_module(f"mix_{i}", MetaFormerBlock(in_channels, dtype=dtype))
        self.channel_proj = Dense(in_channels, out_channels, dtype=dtype)
        self.row_proj = Dense(in_h * in_w, out_rows, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.mix_depth):
            x = getattr(self, f"mix_{i}")(x)
        b = x.shape[0]
        x = self.channel_proj(x.reshape(b, -1, x.shape[-1]))
        x = self.row_proj(x.transpose(1, 2))
        return l2_normalize(x.reshape(b, -1))


class ResNet32MixConv(ConvModel):
    """ResNet backbone + MixPool aggregation (model type ``mixconv``)."""

    def __init__(self, img_size: Tuple[int, int] = (512, 512), backbone: str = "resnet34",
                 out_channels: int = 512, mix_depth: int = 4, out_rows: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.backbone = ResNet(backbone, (), dtype)
        h = backbone_size(img_size[0], backbone)
        w = backbone_size(img_size[1], backbone)
        self.agg = MixPool(h, w, self.backbone.feature_channels, out_channels,
                           mix_depth, out_rows, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.agg(self.backbone(x).permute(0, 2, 3, 1)))


def build_resnet_model(config, model_type: str, dtype: torch.dtype) -> nn.Module:
    if model_type == "resnet":
        return ResNetWrapper(backbone=config.MODEL.RES.ARCH, dtype=dtype)
    if model_type == "mixconv":
        mix = config.MODEL.MIXCONV
        return ResNet32MixConv(
            img_size=(config.DATA.IMG_SIZE, config.DATA.IMG_SIZE), backbone=mix.ARCH,
            out_channels=mix.OUT_CHANNELS, mix_depth=mix.MIX_DEPTH,
            out_rows=mix.OUT_ROWS, dtype=dtype)
    raise NotImplementedError(model_type)
