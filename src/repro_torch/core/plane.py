"""Tile helpers of the ``(rows, LANE)`` layout, from ``repro.core.plane``.

This slice ports only what the wire codec builds on: the lane width, the
per-piece row tiling and element counts. The tiled parameter plane itself
(``PlaneSpec``, quantize-once, the UQ+ server planes) comes with UQ+.
"""
from __future__ import annotations

import torch

from ..kernels.ref import LANE


def f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def tiles(pieces: list[torch.Tensor], fill) -> torch.Tensor:
    """Stack 1-D pieces into the (rows, LANE) tile layout.

    Each piece is padded with ``fill`` to a whole number of LANE-wide rows
    and the rows are concatenated; padding never reaches consumers, which
    slice rows back to exact element counts.
    """
    rows = [-(-p.numel() // LANE) for p in pieces]
    out = torch.full((sum(rows), LANE), fill, dtype=pieces[0].dtype,
                     device=pieces[0].device)
    flat = out.view(-1)
    r0 = 0
    for p, r in zip(pieces, rows):
        flat[r0 * LANE:r0 * LANE + p.numel()] = p
        r0 += r
    return out


def nelem(shape: tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n
