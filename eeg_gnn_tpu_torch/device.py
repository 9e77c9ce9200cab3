"""The device rule of the port's entry points: ``None`` means the CUDA
card, and the CPU runs only when the caller asks for it."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``"cuda"``. Raises
    (naming the entry point ``who``) when CUDA is asked for and absent."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return device
