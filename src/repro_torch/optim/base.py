"""Minimal optimizer interface, the port of ``repro.optim.base``.

An :class:`Optimizer` is a pair of functions over param trees::

    state = opt.init(params)
    updates, state = opt.update(grads, state, params, step)
    params = apply_updates(params, updates)

``update`` returns the *delta* to add to the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..tree import tree_map

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]  # (grads, state, params, step)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
