"""SGD with weight decay and a clip-value trust region, the port of
``repro.optim.sgd`` (its momentum-free form, the one the paper's image
tasks run).

The signature is the reference's, positional order included, so a call
written for one package means the same in the other. Momentum and Nesterov
are not ported yet: a nonzero ``momentum`` or ``nesterov=True`` raises
instead of running a different optimizer.
"""
from __future__ import annotations

from typing import Any

import torch

from .base import Optimizer
from ..tree import tree_map

Tree = Any


def sgd(
    lr: float,
    momentum: float = 0.0,
    weight_decay: float = 0.0,
    wd_mask: Tree | None = None,
    nesterov: bool = False,
    trust_mask: Tree | None = None,
    trust_frac: float = 0.02,
) -> Optimizer:
    """``trust_mask`` marks leaves (FP8 clip values) whose per-step update
    is clamped to ``trust_frac * |param|`` — range-learning stability."""
    if momentum != 0.0 or nesterov:
        raise NotImplementedError(
            f"sgd(momentum={momentum}, nesterov={nesterov}): momentum SGD is not "
            "ported yet; only momentum=0.0 without nesterov runs")

    def _trust(u, p, is_clip):
        if not is_clip:
            return u
        lim = trust_frac * torch.clamp(torch.abs(p), min=1e-8)
        return torch.minimum(torch.maximum(u, -lim), lim)

    def init(params):
        return ()

    def update(grads, state, params, step):
        def decayed(g, p, m):
            return g + weight_decay * p if (weight_decay and m) else g

        mask = wd_mask if wd_mask is not None else tree_map(lambda _: True, params)
        g = tree_map(decayed, grads, params, mask)
        tmask = trust_mask if trust_mask is not None else tree_map(lambda _: False, params)
        upd = tree_map(lambda gi: -lr * gi, g)
        return tree_map(_trust, upd, params, tmask), ()

    return Optimizer(init=init, update=update)
