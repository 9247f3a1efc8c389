"""Model FLOPs of a train step, counted from the model's geometry (the pjs
ViT-ED's pairs, the plain ViT's images, the BatchNorm models' convolutions
and Dense layers), and the card's peak for the trainer's MFU line.

The attention kernels are ctypes launches that ``torch.utils.flop_counter``
does not see, so the count is analytic. It counts the matrix products the
model's function needs, two FLOPs per multiply-add:

- the patch embedding of every image (twice in the pjs model: the
  encoder's stream and the decoder's ``prepare_x2`` stream);
- every Linear (qkv, proj, the cross-attention's q and kv, fc1, fc2, head
  on the CLS row);
- Q K^T and P V of every attention, at the rows it computes (the last pjs
  decoder block computes the CLS row only under the CLS short-circuit, but
  projects qkv over every row);
- an expert bank (models/moe.py) as its router and, for each token, the
  MLP of each of its ``route_k`` experts (what a gather would compute; the
  one-hot dispatch and combine products and the capacity's empty slots are
  a schedule's choice, like the recomputations below);
- the backward as twice the forward: the gradient of each product's two
  operands, except the patch embedding's input (the images need none).

Not counted: the elementwise work (LayerNorm, GELU, softmax, the loss), the
recomputation of the attention probabilities in the backward kernels and
of whole blocks under ``TRAIN.USE_CHECKPOINT``, and the pair gather's
backward product: they are work a kernel or a schedule chooses, not work
the model needs. So the count is *model* FLOPs, and the MFU it gives is
model-FLOP utilisation.

The BatchNorm model types (``models/resnet.py``, ``models/simsiam.py``)
are counted by ``layer_step_flops``: one forward of the model on the meta
device (no memory, no arithmetic) with a hook on every ``Conv2d`` and
``Linear`` that counts two FLOPs per multiply-add at the layer's output
size (a convolution's output elements x its input channels per group x
its kernel area; a Dense's output elements x its input features); the
backward is twice the forward less the stems' input gradient (the images
need none). The norms, activations, pooling and the loss are not counted.

The JAX trainer reports XLA's ``cost_analysis``
instead: the FLOPs its compiled program executes, which include its pair
kernels' doubled products, an upper bound on the model-FLOP number.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

# dense bf16 tensor-core peaks, TFLOP/s, by torch.cuda.get_device_name();
# the SXM5 H100's 989.4 is NVIDIA's H100 datasheet figure without sparsity
BF16_DENSE_PEAK_TFLOPS = {"NVIDIA H100 80GB HBM3": 989.4}


def pjs_step_flops(model, n_images: int, n_pairs: int) -> Tuple[int, int]:
    """(forward, backward) model FLOPs of one step of ``model`` (a ViTED)
    that encodes ``n_images`` images, prepares the decoder stream of the
    same images and decodes ``n_pairs`` pairs: the hisfrag / Michigan loss
    (mined pairs) and the stacked-pair forward (``n_pairs == n_images``)."""
    c = model.embed_dim
    p = model.patch_size
    s_e = model.num_patches          # encoder tokens (no CLS)
    s_d = s_e + 1                    # decoder tokens
    hid = model.cross_blocks[0].mlp.fc1.weight.shape[0]   # MLP width
    k = model.head.weight.shape[0]
    in_chans = model.patch_embed.proj.weight.shape[1]

    def attn(n_q, n_k):              # Q K^T and P V
        return 4 * n_q * n_k * c

    embed = 2 * s_e * in_chans * p * p * c

    def mlp(blk):                    # fc1 + fc2, or the router + k experts
        bank = getattr(blk.mlp, "num_experts", 0)
        return (s_e * c * (2 * bank + 4 * hid * blk.mlp.route_k) if bank
                else 4 * s_e * c * hid)

    enc = sum(8 * s_e * c * c + mlp(blk) + attn(s_e, s_e) for blk in model.blocks)
    # decoder block: self (qkv, proj), cross (q, kv over the context, proj), MLP
    dec = (s_d * c * (12 * c + 4 * hid) + 4 * s_e * c * c
           + attn(s_d, s_d) + attn(s_d, s_e))
    # the last block's CLS row: qkv over every row, one query row after it
    dec_cls = (6 * s_d * c * c + 6 * c * c + 4 * c * hid + 4 * s_e * c * c
               + attn(1, s_d) + attn(1, s_e))
    n_full = model.c_depth - (1 if model.cls_shortcut else 0)
    per_pair = n_full * dec + (dec_cls if model.cls_shortcut else 0) + 2 * c * k
    forward = (n_images * (2 * embed + enc)
               + n_pairs * per_pair)
    backward = 2 * forward - n_images * 2 * embed
    return forward, backward


def vit_step_flops(model, n_images: int) -> Tuple[int, int]:
    """(forward, backward) model FLOPs of one step of ``model`` (a ViT) that
    embeds ``n_images`` images: the patch embedding, ``depth`` blocks over
    the CLS and patch tokens, and the head on the CLS row."""
    c = model.embed_dim
    p = model.patch_size
    s = model.num_patches + 1        # CLS + patch tokens
    hid = model.blocks[0].mlp.fc1.weight.shape[0]
    k = model.head.weight.shape[0]
    in_chans = model.patch_embed.proj.weight.shape[1]
    embed = 2 * (s - 1) * in_chans * p * p * c
    block = s * c * (8 * c + 4 * hid) + 4 * s * s * c
    forward = n_images * (embed + len(model.blocks) * block + 2 * c * k)
    backward = 2 * forward - n_images * embed
    return forward, backward


def layer_step_flops(model: nn.Module, sample_shape: Sequence[int]) -> Tuple[int, int]:
    """(forward, backward) model FLOPs of one step of a BatchNorm model type
    on a batch of ``sample_shape`` (e.g. [B, 2, H, W, 3] for ``ss``): every
    ``Conv2d`` and ``Linear`` at its output size, counted on the meta
    device; the backward twice the forward less the stems' input
    gradient."""
    from vit_ed_tpu_torch.models.layers import Linear
    from vit_ed_tpu_torch.models.resnet import Conv2d, ResNet

    stems = {id(m.conv1) for m in model.modules() if isinstance(m, ResNet)}
    total, stem = [0], [0]

    def hook(mod, _inputs, out):
        per_out = mod.weight[0].numel() if isinstance(mod, Conv2d) else mod.weight.shape[1]
        n = 2 * out.numel() * per_out
        total[0] += n
        if id(mod) in stems:
            stem[0] += n

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (Conv2d, Linear))]
    tensors = {k: torch.empty_like(v, device="meta")
               for k, v in list(model.named_parameters()) + list(model.named_buffers())}
    training = model.training
    model.eval()
    try:
        torch.func.functional_call(
            model, tensors, (torch.empty(tuple(sample_shape), device="meta"),))
    finally:
        model.train(training)
        for h in handles:
            h.remove()
    return total[0], 2 * total[0] - stem[0]


def bf16_peak_tflops(device: torch.device, dtype: torch.dtype,
                     configured: float = 0.0) -> Tuple[Optional[float], str]:
    """(peak TFLOP/s or None, the device's name) for the MFU line: a
    ``configured`` value > 0 (TPU.PEAK_TFLOPS set in a YAML or --opts) wins;
    else the card's dense bf16 peak from the table, for bf16 compute on a
    card in it; else None (unknown: the line prints no percentage)."""
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    if configured and configured > 0:
        return float(configured), name
    if device.type == "cuda" and dtype == torch.bfloat16:
        return BF16_DENSE_PEAK_TFLOPS.get(name), name
    return None, name
