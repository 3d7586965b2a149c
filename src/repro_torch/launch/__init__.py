"""Command-line entry points of the port."""

from __future__ import annotations

import torch


def resolve_device(name="cuda") -> torch.device:
    """The requested device; a CUDA request with no card is an error, never
    a silent fall back to the CPU."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' "
                           "(--device cpu) to run the plain versions on the "
                           "CPU")
    return device
