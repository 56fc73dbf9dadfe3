"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; it raises when there is none.

    The CPU is used only when the caller asks for it (`device="cpu"`), so a
    run that meant to measure the card can never fall back silently."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
