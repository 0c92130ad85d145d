"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = DEFAULT_DEVICE
                   ) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. A CUDA device without a usable GPU raises — the port never
    moves to the CPU on its own."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA GPU is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev
