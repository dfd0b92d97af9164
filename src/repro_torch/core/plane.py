"""Tiled parameter plane — one ``(rows, LANE)`` view of a param tree, the
port of ``repro.core.plane``.

The plane is built at **alpha-segment** granularity: one segment per
clipping *scalar*, i.e. one per quantized tensor, or one per layer slab for
a stacked weight whose clipping value has shape ``(L, 1, ..., 1)``. Each
segment is zero-padded to a whole number of ``LANE``-wide rows, so every row
belongs to exactly one clipping value and the kernels take alpha as a
``(n_rows, 1)`` per-row column (``alpha_column``). The UQ+ server optimizer
(``core.server_opt``) runs on this layout: one ``fake_quant_tiles`` launch
per gradient-descent step or grid point covers the whole tree. So does the
trainer's once-a-step weight fake-quant (:func:`quantize_det`, called by
``launch.steps.quantize_params_once``): one B7 launch forward and one
backward for the whole tree.

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
from .fp8 import E4M3, FP8Format


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


# bytes of stacked f32 tiles one batched launch takes (a cohort's wire
# planes, or one plane's UQ+ grid points); more go in chunks of this
STACK_TILE_BYTES = 256 << 20


def stack_chunk(rows: int) -> int:
    """``(rows, LANE)`` f32 planes a batched launch takes: as many as fit in
    ``STACK_TILE_BYTES``, at least one."""
    return max(1, STACK_TILE_BYTES // max(1, 4 * rows * LANE))


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
    _ids: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def row_seg_ids(self, device) -> torch.Tensor:
        """``row_seg`` as an int64 tensor on ``device``, made once per device
        (at full-width TinyLlama-1.1B it has 1,074,176 entries)."""
        key = str(torch.device(device))
        if key not in self._ids:
            self._ids[key] = torch.tensor(self.row_seg, dtype=torch.int64, device=device)
        return self._ids[key]


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


def _segments(spec: PlaneSpec, qi: int, t: torch.Tensor) -> list[torch.Tensor]:
    """Quantized leaf ``qi`` (or its cotangent) cut into its segments, flat."""
    f = t.reshape(-1)
    per = spec.seg_sizes[spec.leaf_seg0[qi]]
    return [f[l * per:(l + 1) * per] for l in range(spec.leaf_segs[qi])]


def _pack(ws: list[torch.Tensor], als: list[torch.Tensor], spec: PlaneSpec):
    pieces = [p for qi, w in enumerate(ws) for p in _segments(spec, qi, f32(w))]
    alphas = torch.cat([f32(a).reshape(-1) for a in als])
    return tiles(pieces, 0.0), torch.clamp(alphas, min=fp8._ALPHA_FLOOR)


def pack_tiles(params: dict, spec: PlaneSpec) -> tuple[torch.Tensor, torch.Tensor]:
    """Params -> ``(x2 (n_rows, LANE) f32, alphas (n_seg,) f32)``; alphas
    floored at ``fp8._ALPHA_FLOOR`` as every quantizer does."""
    leaves = tree.leaves(params)
    return _pack([leaves[s] for s in spec.q_slots], [leaves[s] for s in spec.alpha_slots],
                 spec)


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


def _leaf_rows(vals2: torch.Tensor, spec: PlaneSpec, qi: int) -> torch.Tensor:
    """Leaf ``qi`` out of a plane buffer, a view where its segments fill
    whole rows (every TinyLlama leaf does), else a copy."""
    seg0, n = spec.leaf_seg0[qi], spec.leaf_segs[qi]
    r0, rows, size = spec.seg_row0[seg0], spec.seg_rows[seg0], spec.seg_sizes[seg0]
    if n == 1 or size == rows * LANE:
        return vals2[r0:r0 + n * rows].reshape(-1)[:n * size].view(spec.q_shapes[qi])
    return leaf_from_tiles(vals2, spec, qi)


def segment_sum(col: torch.Tensor, spec: PlaneSpec) -> torch.Tensor:
    """``(n_rows, 1)`` per-row values -> ``(n_seg,)`` per-segment sums, the
    transpose of :func:`alpha_column`. Each segment's rows are contiguous and
    a stacked leaf's segments have equal rows, so this is one fixed-order
    ``torch.sum`` per leaf: the same bits on every run (a scatter-add,
    ``alphas[seg_ids]``'s autograd transpose, uses atomics on the card)."""
    sums = []
    for qi in range(len(spec.q_slots)):
        seg0, n = spec.leaf_seg0[qi], spec.leaf_segs[qi]
        r0, rows = spec.seg_row0[seg0], spec.seg_rows[seg0]
        sums.append(col[r0:r0 + n * rows].reshape(n, rows).sum(dim=1))
    return torch.cat(sums)


class _PlaneIn(torch.autograd.Function):
    """:func:`pack_tiles` and :func:`alpha_column` as one op: the quantized
    leaves and their clips -> ``(x2, a_col)``. Its backward hands each leaf
    its rows of the plane cotangent (views, no copy) and each clip the
    :func:`segment_sum` of the column cotangent, where the floor passed it.
    Autograd through slices and a gather would instead allocate a
    plane-sized cotangent per leaf and scatter-add with atomics."""

    @staticmethod
    def forward(ctx, spec, seg_ids, *ts):
        n = len(spec.q_slots)
        x2, alphas = _pack(list(ts[:n]), list(ts[n:]), spec)
        ctx.spec = spec
        ctx.shapes = [(t.shape, t.dtype) for t in ts]
        ctx.save_for_backward(alphas)
        return x2, alphas[seg_ids][:, None]

    @staticmethod
    def backward(ctx, g_x2, g_col):
        spec = ctx.spec
        n = len(spec.q_slots)
        (alphas,) = ctx.saved_tensors
        need = ctx.needs_input_grad[2:]
        g_w = [_leaf_rows(g_x2, spec, qi).to(ctx.shapes[qi][1]) if need[qi] else None
               for qi in range(n)]
        g_a = [None] * n
        if any(need[n:]):
            ga = segment_sum(g_col, spec) * (alphas > fp8._ALPHA_FLOOR).to(torch.float32)
            i = 0
            for k, (shape, dtype) in enumerate(ctx.shapes[n:]):
                m = nelem(tuple(shape))
                g_a[k] = ga[i:i + m].reshape(shape).to(dtype)
                i += m
        return (None, None, *g_w, *g_a)


class _PlaneOut(torch.autograd.Function):
    """The quantized plane -> each quantized leaf in its output dtype. Its
    backward lays the leaves' cotangents into one f32 plane (one copy each;
    zeros in the padding and for a leaf with no cotangent)."""

    @staticmethod
    def forward(ctx, spec, dtypes, q2):
        ctx.spec = spec
        ctx.set_materialize_grads(False)
        return tuple(_leaf_rows(q2, spec, qi).to(dt, copy=True)
                     for qi, dt in enumerate(dtypes))

    @staticmethod
    def backward(ctx, *gs):
        spec = ctx.spec
        ref = next(g for g in gs if g is not None)
        g2 = torch.zeros((spec.n_rows, LANE), dtype=torch.float32, device=ref.device)
        flat = g2.view(-1)
        for qi, g in enumerate(gs):
            if g is None:
                continue
            for si, piece in enumerate(_segments(spec, qi, g), start=spec.leaf_seg0[qi]):
                r0 = spec.seg_row0[si] * LANE
                flat[r0:r0 + piece.numel()].copy_(piece)
        return None, None, g2


def quantize_det(params: dict, fmt: FP8Format = E4M3, spec: PlaneSpec | None = None,
                 out_dtype: torch.dtype | None = None) -> dict:
    """Fake-quantize every quantized weight leaf in one B7 launch, the port
    of ``repro.core.plane.quantize_det``.

    Values and STE gradients of the per-leaf ``fp8.quantize_det`` loop: the
    clip mask to each weight, the clip routing plus the ``(q - y) * s /
    alpha`` scale term summed back to each leaf's scalar (or stacked
    per-layer) alpha, with no LSQ gradient scale (the reference's plane path
    applies none). Forward and backward are one launch each, whatever the
    number of tensors. ``out_dtype`` (the compute dtype, for the trainer's
    pre-quantization) applies to the quantized leaves only; every other
    leaf passes through untouched. ``spec`` built once by the caller saves
    rebuilding it, and its device row ids, on every call.
    """
    from ..kernels import dispatch  # kernels imports core modules

    if spec is None:
        spec = make_plane_spec(params)
    if not spec.q_slots:
        return params
    leaves = tree.leaves(params)
    ws = [leaves[s] for s in spec.q_slots]
    x2, a_col = _PlaneIn.apply(spec, spec.row_seg_ids(ws[0].device), *ws,
                               *(leaves[s] for s in spec.alpha_slots))
    q2 = dispatch.quant_det_plane(x2, a_col, fmt)
    outs = _PlaneOut.apply(spec, tuple(out_dtype or w.dtype for w in ws), q2)
    for slot, q in zip(spec.q_slots, outs):
        leaves[slot] = q
    return tree.unflatten(list(spec.names), leaves)
