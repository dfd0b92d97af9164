"""SGD with optional momentum (heavy-ball or Nesterov), decoupled weight
decay and a clip-value trust region, the port of ``repro.optim.sgd`` (the
paper's image-task optimizer; the one-device trainer's ``kind="sgd"`` runs it
at momentum 0.9).

The signature is the reference's, positional order included, so a call
written for one package means the same in the other. The learning rate is a
float (the reference's schedules, ``optim/schedules.py``, are not ported
yet). The momentum buffer has each parameter's dtype, as the reference's
``zeros_like``.
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

    def _trust(u, p, is_clip):
        if not is_clip:
            return u
        lim = trust_frac * torch.clamp(torch.abs(p), min=1e-8)
        return torch.minimum(torch.maximum(u, -lim), lim)

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params, step):
        def decayed(g, p, m):
            return g + weight_decay * p if (weight_decay and m) else g

        mask = wd_mask if wd_mask is not None else tree_map(lambda _: True, params)
        g = tree_map(decayed, grads, params, mask)
        tmask = trust_mask if trust_mask is not None else tree_map(lambda _: False, params)
        if momentum == 0.0:
            upd = tree_map(lambda gi: -lr * gi, g)
            return tree_map(_trust, upd, params, tmask), ()
        new_m = tree_map(lambda mi, gi: momentum * mi + gi, state, g)
        if nesterov:
            upd = tree_map(lambda mi, gi: -lr * (momentum * mi + gi), new_m, g)
        else:
            upd = tree_map(lambda mi: -lr * mi, new_m)
        return tree_map(_trust, upd, params, tmask), new_m

    return Optimizer(init=init, update=update)
