"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device="cuda"`` on a host without a usable GPU raises instead of quietly
falling back, so a CPU run is never mistaken for a GPU one.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent GPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return dev
