"""Where the codec's entry points run, and the numerics they pin there."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The entry points' device: "cuda" unless the caller asks otherwise;
    a CUDA request on a machine without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def pin_numerics() -> None:
    """Fix the convolution algorithms and keep fp32 convs and matmuls in
    full fp32 (no TF32), so an encode and a later decode on the card pick
    the same algorithms and round the same way."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def check_model(model: torch.nn.Module, dev: torch.device) -> None:
    """Raise unless ``model``'s parameters live on ``dev``."""
    pdev = next(model.parameters()).device
    if pdev.type != dev.type or (dev.index is not None
                                 and pdev.index != dev.index):
        raise ValueError(f"model lives on {pdev}, the codec runs on {dev}; "
                         f"load it with load_model(..., device={str(dev)!r})")
