"""Nested-dict parameter trees, flattened in JAX's pytree order.

The reference keeps params as nested dicts and flattens them with
``jax.tree_util``, which visits dict keys in SORTED order (not insertion
order). The wire's flat leaf order, and hence its byte layout, follows that
order, so the port flattens the same way here.
"""
from __future__ import annotations

from typing import Any, Callable

Tree = Any


def flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``[(dotted_name, leaf), ...]`` in sorted-key (pytree) order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten(tree[k], f"{prefix}{k}."))
        return out
    return [(prefix[:-1], tree)]


def unflatten(names: list[str], leaves: list) -> dict:
    """Inverse of :func:`flatten` for dotted names."""
    out: dict = {}
    for name, leaf in zip(names, leaves):
        *path, last = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf
    return out


def leaves(tree: Tree) -> list:
    return [leaf for _, leaf in flatten(tree)]


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)
