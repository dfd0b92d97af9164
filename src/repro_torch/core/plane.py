"""Tiled parameter plane — one ``(rows, LANE)`` view of a param tree, the
port of ``repro.core.plane``.

The plane is built at **alpha-segment** granularity: one segment per
clipping *scalar*, i.e. one per quantized tensor, or one per layer slab for
a stacked weight whose clipping value has shape ``(L, 1, ..., 1)``. Each
segment is zero-padded to a whole number of ``LANE``-wide rows, so every row
belongs to exactly one clipping value and the kernels take alpha as a
``(n_rows, 1)`` per-row column (``alpha_column``). The UQ+ server optimizer
(``core.server_opt``) runs on this layout: one ``fake_quant_tiles`` launch
per gradient-descent step or grid point covers the whole tree.

Quantized leaves are visited in sorted dotted-name order, the order of the
reference's ``sorted(quantized_leaf_names(...))`` and of the port's wire.
``tiles``/``nelem`` are also the wire codec's tile helpers.
"""
from __future__ import annotations

import dataclasses

import torch

from . import fp8, qat
from .. import tree
from ..kernels.ref import LANE


def f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def tiles(pieces: list[torch.Tensor], fill, width: int = LANE) -> torch.Tensor:
    """Stack 1-D pieces into the (rows, width) tile layout.

    Each piece is padded with ``fill`` to a whole number of ``width``-wide
    rows and the rows are concatenated; padding never reaches consumers,
    which slice rows back to exact element counts.
    """
    rows = [-(-p.numel() // width) for p in pieces]
    out = torch.full((sum(rows), width), fill, dtype=pieces[0].dtype,
                     device=pieces[0].device)
    flat = out.view(-1)
    r0 = 0
    for p, r in zip(pieces, rows):
        flat[r0 * width:r0 * width + p.numel()] = p
        r0 += r
    return out


def nelem(shape: tuple[int, ...]) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


@dataclasses.dataclass(frozen=True)
class PlaneSpec:
    """Static description of a param tree's tiled parameter plane."""

    names: tuple[str, ...]             # dotted name of every flat leaf
    q_slots: tuple[int, ...]           # flat-leaf index of each quantized leaf
    q_names: tuple[str, ...]           # dotted names (same order as q_slots)
    q_shapes: tuple[tuple[int, ...], ...]
    alpha_slots: tuple[int, ...]       # flat-leaf index of each leaf's alpha
    alpha_shapes: tuple[tuple[int, ...], ...]
    leaf_segs: tuple[int, ...]         # segments per leaf (1, or L if stacked)
    leaf_seg0: tuple[int, ...]         # first segment id of each leaf
    seg_sizes: tuple[int, ...]         # real elements per segment
    seg_rows: tuple[int, ...]          # rows per segment
    seg_row0: tuple[int, ...]          # first row of each segment
    n_rows: int                        # total rows of the (n_rows, LANE) plane
    n_seg: int                         # total segments == total alpha scalars
    row_seg: tuple[int, ...]           # (n_rows,): row -> segment id

    def row_seg_ids(self, device) -> torch.Tensor:
        return torch.tensor(self.row_seg, dtype=torch.int64, device=device)


def make_plane_spec(params: dict) -> PlaneSpec:
    """Build the static plane layout for a param tree."""
    flat = tree.flatten(params)
    names = [n for n, _ in flat]
    index = {name: i for i, name in enumerate(names)}
    q_slots, q_shapes, alpha_slots, alpha_shapes = [], [], [], []
    leaf_segs, leaf_seg0, seg_sizes, seg_rows, seg_row0 = [], [], [], [], []
    row_seg: list[int] = []
    qnames = sorted(qat.quantized_leaf_names(params))
    row0 = seg0 = 0
    for name in qnames:
        leaf = flat[index[name]][1]
        a_leaf = flat[index[name + qat.QA_SUFFIX]][1]
        n_seg_leaf = a_leaf.numel()
        if n_seg_leaf > 1 and leaf.shape[0] != n_seg_leaf:
            # stacked alpha (L, 1, ..., 1) pairs the layer slabs of (L, ...)
            raise ValueError(f"{name}: stacked alpha {tuple(a_leaf.shape)} does not "
                             f"pair leading axis of weight {tuple(leaf.shape)}")
        size = leaf.numel() // n_seg_leaf
        q_slots.append(index[name])
        q_shapes.append(tuple(leaf.shape))
        alpha_slots.append(index[name + qat.QA_SUFFIX])
        alpha_shapes.append(tuple(a_leaf.shape))
        leaf_segs.append(n_seg_leaf)
        leaf_seg0.append(seg0)
        for _ in range(n_seg_leaf):
            rows = -(-size // LANE)
            seg_sizes.append(size)
            seg_rows.append(rows)
            seg_row0.append(row0)
            row_seg.extend([seg0] * rows)
            row0 += rows
            seg0 += 1
    return PlaneSpec(
        names=tuple(names), q_slots=tuple(q_slots), q_names=tuple(qnames),
        q_shapes=tuple(q_shapes), alpha_slots=tuple(alpha_slots),
        alpha_shapes=tuple(alpha_shapes), leaf_segs=tuple(leaf_segs),
        leaf_seg0=tuple(leaf_seg0), seg_sizes=tuple(seg_sizes),
        seg_rows=tuple(seg_rows), seg_row0=tuple(seg_row0), n_rows=row0,
        n_seg=seg0, row_seg=tuple(row_seg),
    )


def pack_tiles(params: dict, spec: PlaneSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Params -> ``(x2 (n_rows, LANE) f32, alphas (n_seg,) f32)``; alphas
    floored at ``fp8._ALPHA_FLOOR`` as every quantizer does."""
    leaves = tree.leaves(params)
    pieces = []
    for qi, slot in enumerate(spec.q_slots):
        f = f32(leaves[slot]).reshape(-1)
        per = spec.seg_sizes[spec.leaf_seg0[qi]]
        pieces.extend(f[l * per:(l + 1) * per] for l in range(spec.leaf_segs[qi]))
    x2 = tiles(pieces, 0.0)
    alphas = torch.cat([f32(leaves[s]).reshape(-1) for s in spec.alpha_slots])
    return x2, torch.clamp(alphas, min=fp8._ALPHA_FLOOR)


def alpha_column(alphas: torch.Tensor, spec: PlaneSpec,
                 seg_ids: torch.Tensor | None = None) -> torch.Tensor:
    """``(n_seg,)`` alphas -> ``(n_rows, 1)`` per-row column; ``seg_ids`` is
    ``spec.row_seg_ids`` on the alphas' device, made once by a caller that
    builds many columns (each build copies it from the host)."""
    if seg_ids is None:
        seg_ids = spec.row_seg_ids(alphas.device)
    return alphas[seg_ids][:, None]


def leaf_from_tiles(vals2: torch.Tensor, spec: PlaneSpec, qi: int) -> torch.Tensor:
    """Slice quantized leaf ``qi`` back out of a plane buffer."""
    seg0 = spec.leaf_seg0[qi]
    slabs = [vals2[spec.seg_row0[si]:spec.seg_row0[si] + spec.seg_rows[si]]
             .reshape(-1)[:spec.seg_sizes[si]]
             for si in range(seg0, seg0 + spec.leaf_segs[qi])]
    return torch.cat(slabs).reshape(spec.q_shapes[qi])
