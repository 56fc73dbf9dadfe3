"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; a CUDA device raises when there is none.

    The CPU is used only when the caller asks for it (`device="cpu"`), so a
    run that meant to measure the card can never fall back silently."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is present; pass device='cpu' to run on the CPU")
    return device
