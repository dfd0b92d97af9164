"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``device="cuda"`` on a host without a usable GPU raises instead of quietly
falling back, so a CPU run is never mistaken for a GPU one.

Resolving a CUDA device also switches TF32 off for matrix products and
cuDNN convolutions: the reference computes in full f32, and cuDNN's default
(``torch.backends.cudnn.allow_tf32 = True``) would run the convolutions in
TF32 on the card.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names an absent GPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
