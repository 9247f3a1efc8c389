"""Device selection for every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); without a card they raise instead of
carrying on quietly on the CPU.

Under a launch of several processes (``WORLD_SIZE`` > 1) a rank's card is
``cuda:{LOCAL_RANK}`` (``SLURM_LOCALID`` under SLURM, else 0). An entry
that runs several processes joins the process group first
(``parallel.mesh.maybe_init_distributed``); one that does not is refused
here, so that two ranks never run as two independent copies writing one
output directory. Two ranks of one host may name the same card only over
gloo: NCCL refuses that, and the check says so before it does.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Union

import torch
import torch.distributed as dist

from vit_ed_tpu_torch.parallel import mesh


def resolve_device(arg: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for.

    Also pins float32 math to full float32: cuBLAS matmuls and cuDNN
    convolutions (the PatchEmbed conv, the BatchNorm models' convs) would
    otherwise be free to run in TF32, which keeps about three decimal
    digits; and makes cuDNN pick deterministic convolution algorithms (its
    backward ones otherwise include atomics-based ones, and two steps from
    one state would differ)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    world = mesh.env_world_size()
    if world > 1 and not dist.is_initialized():
        raise NotImplementedError(
            f"WORLD_SIZE {world}: this entry runs in one process; several "
            f"processes run the trainers' entries only (ROADMAP A7c)")
    dev = torch.device("cuda" if arg is None else arg)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
        if world > 1 and dev.index is None:
            dev = _rank_card()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use cuda or cpu")
    return dev


def _rank_card() -> torch.device:
    """``cuda:{LOCAL_RANK}`` of this rank, checked against the other ranks:
    a card that does not exist raises, and so do two ranks of one host on
    one card unless the group's backend is gloo."""
    local = int(os.environ.get("LOCAL_RANK", os.environ.get("SLURM_LOCALID", "0")))
    if local >= torch.cuda.device_count():
        raise RuntimeError(
            f"LOCAL_RANK {local} has no card: this host has "
            f"{torch.cuda.device_count()}")
    torch.cuda.set_device(local)
    cards = [None] * dist.get_world_size()
    dist.all_gather_object(cards, (socket.gethostname(), local),
                           group=mesh._host_group())
    if len(set(cards)) < len(cards) and dist.get_backend() != "gloo":
        raise RuntimeError(
            f"two ranks on one card ({cards}) need the gloo backend; NCCL "
            f"refuses them: give each rank its own LOCAL_RANK")
    return torch.device("cuda", local)
