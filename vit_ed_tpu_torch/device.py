"""Device selection for every entry point of the port.

Entry points run on the CUDA card unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); without a card they raise instead of
carrying on quietly on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(arg: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only when asked for.

    Also pins float32 math to full float32: cuBLAS matmuls and cuDNN
    convolutions (the PatchEmbed conv) would otherwise be free to run in
    TF32, which keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if arg is None else arg)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' "
                "(--device cpu on the command line) to run on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev!s}: use cuda or cpu")
    return dev
