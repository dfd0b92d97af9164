"""Uniform model API over the LM families, the port of
``repro.models.registry.get_model`` for the dense family.

``get_model(cfg)`` returns a :class:`Model` with ``init(seed, device)`` and
``train_loss(params, batch, qcfg)``. Prefill and decode come with
``launch/serve.py`` (ROADMAP §1 item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from . import transformer
from ..configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable          # (seed | Generator, device="cuda") -> params
    train_loss: Callable    # (params, batch, qcfg) -> scalar


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"get_model: family {cfg.family!r} ({cfg.name}) is not ported yet "
            "(ROADMAP §1 item 8, the other LM families); ported: 'dense'")
    return Model(
        cfg=cfg,
        init=lambda seed, device="cuda": transformer.init_lm(seed, cfg, device),
        train_loss=lambda params, batch, qcfg: transformer.train_loss(params, batch, cfg,
                                                                      qcfg),
    )
