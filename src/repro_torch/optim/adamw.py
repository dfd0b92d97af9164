"""AdamW with decoupled weight decay, the port of ``repro.optim.adamw`` (the
paper's keyword-spotting optimizer).

The step counter ``t`` starts at 1 (``step + 1``, ``step`` counted from 0
by the local update), the bias corrections ``1 - b^t`` are taken in f32 as
the reference does, and ``trust_mask`` leaves (the FP8 clip values) have
their update clamped to ``trust_frac * |param|``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .base import Optimizer
from ..tree import tree_map

Tree = Any


class AdamWState(NamedTuple):
    mu: Tree
    nu: Tree


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    wd_mask: Tree | None = None,
    trust_mask: Tree | None = None,
    trust_frac: float = 0.02,
) -> Optimizer:

    def init(params):
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return AdamWState(mu=z, nu=tree_map(torch.zeros_like, z))

    def update(grads, state, params, step):
        # f32 host scalars, so no device tensor is made per step
        t = np.float32(float(step) + 1.0)
        bc1 = float(np.float32(1.0) - np.power(np.float32(b1), t))
        bc2 = float(np.float32(1.0) - np.power(np.float32(b2), t))
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu, grads)
        mask = wd_mask if wd_mask is not None else tree_map(lambda _: True, params)
        tmask = trust_mask if trust_mask is not None else tree_map(lambda _: False, params)

        def upd(m, v, p, msk, is_clip):
            mh, vh = m / bc1, v / bc2
            step_ = mh / (torch.sqrt(vh) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p * (1.0 if msk else 0.0)
            u = -lr * step_
            if is_clip:
                lim = trust_frac * torch.clamp(torch.abs(p), min=1e-8)
                u = torch.minimum(torch.maximum(u, -lim), lim)
            return u

        return tree_map(upd, mu, nu, params, mask, tmask), AdamWState(mu, nu)

    return Optimizer(init=init, update=update)
