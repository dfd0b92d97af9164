"""Flat-buffer FP8 wire codec, the port of ``repro.core.wire``.

Every weight tensor that carries a paired clipping value is laid into ONE
``(rows, LANE)`` f32 tile buffer (each leaf starting on a row boundary),
quantized + bit-packed by one ``quant_pack_tiles`` launch into a uint8
payload — the bytes that cross the federated wire — and decoded by one
``unpack_tiles`` launch on receipt.

``payload = {"codes": u8[total], "other": (leaf, ...)}``: ``codes`` holds
exactly one byte per quantized element (tile padding sliced off); ``other``
holds every non-quantized leaf (biases, norms, the clipping values) in flat
order, transmitted FP32.

Flat order is JAX's pytree order (dict keys sorted; ``tree.flatten``), so
``WireSpec`` and the payload bytes line up with the reference's. Where the
reference draws the stochastic-rounding key words from a ``jax.random`` key
(``key_data(key)[:2]``), the port takes the two u32 words directly.
"""
from __future__ import annotations

import dataclasses

import torch

from . import fp8, qat
from .fp8 import E4M3, FP8Format
from .plane import LANE, f32, nelem, tiles
from .. import tree
from ..kernels import dispatch


@dataclasses.dataclass(frozen=True)
class WireSpec:
    """Static description of how a param tree maps onto the wire buffer."""

    names: tuple[str, ...]             # dotted name of every flat leaf
    q_slots: tuple[int, ...]           # flat-leaf index of each quantized leaf
    q_names: tuple[str, ...]
    q_shapes: tuple[tuple[int, ...], ...]
    q_offsets: tuple[int, ...]         # start offset of each leaf in the codes
    total: int                         # quantized element count == code bytes
    q_rows: tuple[int, ...]            # per-leaf row count in the tile layout
    q_row_offsets: tuple[int, ...]     # per-leaf starting row in the tile layout
    n_rows: int
    other_slots: tuple[int, ...]       # flat-leaf index of each FP32 rider
    alpha_pos: tuple[int, ...]         # index into `other` of each leaf's alpha
    n_other_elems: int
    alpha_cols_ok: bool = False        # every alpha scalar -> (R, 1) column

    @property
    def n_leaves(self) -> int:
        return len(self.names)


def make_wire_spec(params: dict) -> WireSpec:
    """Build the static wire layout for a param tree."""
    flat = tree.flatten(params)
    names = [n for n, _ in flat]
    qnames = qat.quantized_leaf_names(params)
    q = sorted((name, i) for i, name in enumerate(names) if name in qnames)
    other_slots = tuple(i for i, name in enumerate(names) if name not in qnames)
    other_index = {names[slot]: oi for oi, slot in enumerate(other_slots)}
    q_slots, q_names, q_shapes, q_offsets, alpha_pos = [], [], [], [], []
    q_rows, q_row_offsets = [], []
    off = row_off = 0
    for name, i in q:
        leaf = flat[i][1]
        q_slots.append(i)
        q_names.append(name)
        q_shapes.append(tuple(leaf.shape))
        q_offsets.append(off)
        off += leaf.numel()
        rows = -(-leaf.numel() // LANE)
        q_rows.append(rows)
        q_row_offsets.append(row_off)
        row_off += rows
        alpha_pos.append(other_index[name + qat.QA_SUFFIX])
    return WireSpec(
        names=tuple(names),
        q_slots=tuple(q_slots),
        q_names=tuple(q_names),
        q_shapes=tuple(q_shapes),
        q_offsets=tuple(q_offsets),
        total=off,
        q_rows=tuple(q_rows),
        q_row_offsets=tuple(q_row_offsets),
        n_rows=row_off,
        other_slots=other_slots,
        alpha_pos=tuple(alpha_pos),
        n_other_elems=sum(flat[i][1].numel() for i in other_slots),
        alpha_cols_ok=all(flat[other_slots[ai]][1].numel() == 1 for ai in alpha_pos),
    )


def _alpha_tiles(other: tuple, spec: WireSpec) -> torch.Tensor:
    """Floored clipping values for the tile layout: a per-ROW ``(n_rows, 1)``
    column when every alpha is a scalar, else per-element ``(n_rows, LANE)``."""
    if spec.alpha_cols_ok:
        a = torch.stack([f32(other[ai]).reshape(()) for ai in spec.alpha_pos])
        a = torch.clamp(a, min=fp8._ALPHA_FLOOR)
        rows = torch.tensor(spec.q_rows, device=a.device)
        return torch.repeat_interleave(a, rows).reshape(-1, 1)
    parts = [
        torch.clamp(f32(other[ai]), min=fp8._ALPHA_FLOOR).expand(shape).reshape(-1)
        for shape, ai in zip(spec.q_shapes, spec.alpha_pos)
    ]
    return tiles(parts, 1.0)


def encode(params: dict, spec: WireSpec, key2: torch.Tensor | None,
           fmt: FP8Format = E4M3, mode: str = "rand") -> dict:
    """Quantize+pack a model copy into its wire payload (one kernel launch).

    ``mode='rand'`` is the paper's unbiased quantizer, seeded by the ``(2,)``
    u32 ``key2``; ``'det'`` the biased Table-2 ablation (``key2`` unused).
    """
    leaves = tree.leaves(params)
    other = tuple(leaves[i] for i in spec.other_slots)
    if not spec.q_slots:
        return {"codes": torch.zeros(0, dtype=torch.uint8, device=leaves[0].device),
                "other": other}
    x2 = tiles([f32(leaves[i]).reshape(-1) for i in spec.q_slots], 0.0)
    a2 = _alpha_tiles(other, spec)
    codes2 = dispatch.quant_pack_tiles(x2, a2, key2 if mode == "rand" else None,
                                       fmt=fmt)
    codes = torch.cat([
        codes2[r0:r0 + rows].reshape(-1)[:nelem(shape)]
        for r0, rows, shape in zip(spec.q_row_offsets, spec.q_rows, spec.q_shapes)
    ])
    return {"codes": codes, "other": other}


def decode_tiles(codes: torch.Tensor, other: tuple, spec: WireSpec,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Exact codes -> dequantized values in the (n_rows, LANE) tile layout."""
    c2 = tiles([codes[off:off + nelem(shape)]
                for off, shape in zip(spec.q_offsets, spec.q_shapes)], 0)
    return dispatch.unpack_tiles(c2, _alpha_tiles(other, spec), fmt=fmt)


def tiles_to_leaf(vals2: torch.Tensor, spec: WireSpec, qi: int) -> torch.Tensor:
    """Slice quantized leaf ``qi`` out of a decoded tile buffer."""
    r0, rows, shape = spec.q_row_offsets[qi], spec.q_rows[qi], spec.q_shapes[qi]
    return vals2[r0:r0 + rows].reshape(-1)[:nelem(shape)].reshape(shape)


def decode(payload: dict, spec: WireSpec, fmt: FP8Format = E4M3) -> dict:
    """Unpack a wire payload back into the full param tree (one kernel launch)."""
    other = tuple(payload["other"])
    out: list = [None] * spec.n_leaves
    for slot, leaf in zip(spec.other_slots, other):
        out[slot] = leaf
    if spec.q_slots:
        vals2 = decode_tiles(payload["codes"], other, spec, fmt)
        for qi, slot in enumerate(spec.q_slots):
            out[slot] = tiles_to_leaf(vals2, spec, qi)
    return tree.unflatten(list(spec.names), out)


def payload_nbytes(spec: WireSpec) -> int:
    """Exact wire bytes of one encoded model copy (u8 codes + FP32 riders)."""
    return spec.total * 1 + spec.n_other_elems * 4
