"""Architecture registry, the port of ``repro.configs``: one module per
ported architecture. ``ARCH_IDS`` lists what is ported; the reference's
other architectures raise in :func:`get` and name the ROADMAP item that
ports them."""
from __future__ import annotations

import importlib

from .base import ModelConfig, reduced

ARCH_IDS = ["tinyllama_1_1b"]

# the reference's other architectures (repro/configs/__init__.py)
_NOT_PORTED = ("deepseek_67b", "granite_3_8b", "minicpm3_4b", "llava_next_mistral_7b",
               "mamba2_1_3b", "mixtral_8x7b", "granite_moe_3b_a800m",
               "recurrentgemma_2b", "whisper_medium")


def get(name: str) -> ModelConfig:
    name = name.replace("-", "_")
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet (ROADMAP §1 item 8, the other "
            "LM families); ported: " + ", ".join(ARCH_IDS))
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {name!r}; ported: {', '.join(ARCH_IDS)}")
    return importlib.import_module(f".{name}", __package__).CONFIG


__all__ = ["ARCH_IDS", "ModelConfig", "get", "reduced"]
