"""Flat-buffer wire codec, the port of ``repro.core.wire``.

Every weight tensor that carries a paired clipping value is laid into ONE
``(rows, LANE)`` f32 tile buffer (each leaf starting on a row boundary),
quantized + bit-packed by one encode launch into a uint8 payload — the
bytes that cross the federated wire — and decoded by one launch on receipt.
The format picks the kernels: an 8-bit format packs 1 code per byte
(``quant_pack_tiles`` / ``unpack_tiles``), a sub-byte one ``8 // bits``
(FP4: ``quant_pack_sub_tiles`` / ``unpack_sub_tiles``).

``payload = {"codes": u8[n], "other": (leaf, ...)}``: ``codes`` holds each
quantized leaf's ``ceil(elements / codes_per_byte)`` bytes (tile padding
sliced off); ``other`` holds every non-quantized leaf (biases, norms, the
clipping values) in flat order, transmitted FP32.

Flat order is JAX's pytree order (dict keys sorted; ``tree.flatten``), so
``WireSpec`` and the payload bytes line up with the reference's. Where the
reference draws the stochastic-rounding key words from a ``jax.random`` key
(``key_data(key)[:2]``), the port takes the two u32 words directly.

The codecs of ``core.codec`` compose the tile-level steps below
(:func:`pack`, :func:`assemble`) with their own clip columns: explicit
scales for ``core.scaling``, the residual's clips for the delta codec. A
cohort's uplink takes the batched steps (:func:`encode_many`,
:func:`encode_amax_many`, :func:`assemble_many`): one launch for a chunk of
``plane.stack_chunk`` clients, bitwise the single steps of each.
"""
from __future__ import annotations

import dataclasses
import itertools

import torch

from . import fp8, plane, qat
from .fp8 import E4M3, FP8Format
from .plane import LANE, f32, nelem, tiles
from .. import tree
from ..kernels import dispatch
from ..kernels.ref import codes_per_byte


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
    alpha_shapes: tuple = ()           # per-leaf alpha shape (frozen splice-back)

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
        alpha_shapes=tuple(tuple(flat[other_slots[ai]][1].shape) for ai in alpha_pos),
    )


def alpha_column(alphas: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    """``(n_q,)`` per-leaf clipping scalars -> floored ``(n_rows, 1)`` column."""
    return alpha_columns(f32(alphas).reshape(1, -1), spec)[0]


def alpha_columns(alphas: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    """A cohort's ``(P, n_q)`` per-leaf clipping scalars -> floored ``(P,
    n_rows, 1)`` columns, each client's :func:`alpha_column`."""
    a = torch.clamp(f32(alphas), min=fp8._ALPHA_FLOOR)
    return torch.repeat_interleave(a, torch.tensor(spec.q_rows, device=a.device),
                                   dim=1)[..., None]


def alpha_tiles(other: tuple, spec: WireSpec) -> torch.Tensor:
    """Floored clipping values for the tile layout: a per-ROW ``(n_rows, 1)``
    column when every alpha is a scalar, else per-element ``(n_rows, LANE)``."""
    if spec.alpha_cols_ok:
        return alpha_column(torch.stack([f32(other[ai]).reshape(())
                                         for ai in spec.alpha_pos]), spec)
    parts = [
        torch.clamp(f32(other[ai]), min=fp8._ALPHA_FLOOR).expand(shape).reshape(-1)
        for shape, ai in zip(spec.q_shapes, spec.alpha_pos)
    ]
    return tiles(parts, 1.0)


def alpha_tiles_many(others: list, spec: WireSpec) -> torch.Tensor:
    """Each client's :func:`alpha_tiles` from its riders, stacked: ``(P,
    n_rows, 1 | LANE)``."""
    if spec.alpha_cols_ok:
        a = torch.stack([f32(o[ai]).reshape(()) for o in others for ai in spec.alpha_pos])
        return alpha_columns(a.reshape(len(others), -1), spec)
    return torch.stack([alpha_tiles(o, spec) for o in others])


def code_sizes(spec: WireSpec, fmt: FP8Format = E4M3) -> list[int]:
    """Payload bytes of each quantized leaf: ``ceil(elements / codes_per_byte)``."""
    k = codes_per_byte(fmt)
    return [-(-nelem(s) // k) for s in spec.q_shapes]


def payload_nbytes(spec: WireSpec, fmt: FP8Format = E4M3) -> int:
    """Exact wire bytes of one encoded model copy (u8 codes + FP32 riders)."""
    return sum(code_sizes(spec, fmt)) + 4 * spec.n_other_elems


def weight_tiles(leaves: list, spec: WireSpec) -> torch.Tensor:
    """The quantized leaves in the ``(n_rows, LANE)`` tile layout, zero-filled."""
    return tiles([f32(leaves[i]).reshape(-1) for i in spec.q_slots], 0.0)


def segment_amax(rowmax: torch.Tensor, spec: WireSpec) -> torch.Tensor:
    """Per-row ``|x|`` maxima -> per-quantized-leaf ``(n_q,)`` amax; a
    cohort's ``(P, n_rows, 1)`` -> ``(P, n_q)``. Equal to a per-leaf flat
    max: the zero fill never exceeds a row's abs-max and float max is exact
    in any order."""
    rm = rowmax.reshape(rowmax.shape[0], -1) if rowmax.dim() == 3 else rowmax.reshape(-1)
    return torch.stack([torch.amax(rm[..., r0:r0 + rows], dim=-1)
                        for r0, rows in zip(spec.q_row_offsets, spec.q_rows)], dim=-1)


def pack(x2: torch.Tensor, a2: torch.Tensor, key2: torch.Tensor | None,
         spec: WireSpec, fmt: FP8Format) -> torch.Tensor:
    """Tiles -> the flat payload codes, one encode launch (``key2`` None is
    deterministic rounding)."""
    kern = dispatch.quant_pack_sub_tiles if codes_per_byte(fmt) > 1 else dispatch.quant_pack_tiles
    return _payload_codes(kern(x2, a2, key2, fmt=fmt)[None], spec, fmt)[0]


def _payload_codes(codes3: torch.Tensor, spec: WireSpec, fmt: FP8Format) -> list:
    """Each client's payload codes out of a stack of code tiles."""
    sizes = code_sizes(spec, fmt)
    return [torch.cat([c2[r0:r0 + rows].reshape(-1)[:n] for r0, rows, n
                       in zip(spec.q_row_offsets, spec.q_rows, sizes)]) for c2 in codes3]


def code_tiles(codes: torch.Tensor, spec: WireSpec, fmt: FP8Format) -> torch.Tensor:
    """A stack of ``(P, n)`` payload codes -> their ``(P, n_rows, LANE //
    k)`` code tiles, zero-filled (the tile padding; an FP4 pad nibble is
    already 0): one slice copy a quantized leaf."""
    width = LANE // codes_per_byte(fmt)
    c3 = torch.zeros((codes.shape[0], spec.n_rows * width), dtype=torch.uint8,
                     device=codes.device)
    for r0, off, n in zip(spec.q_row_offsets, itertools.accumulate(
            code_sizes(spec, fmt), initial=0), code_sizes(spec, fmt)):
        c3[:, r0 * width:r0 * width + n] = codes[:, off:off + n]
    return c3.view(codes.shape[0], spec.n_rows, width)


def pack_many(x3: torch.Tensor, a3: torch.Tensor, keys: torch.Tensor | None,
              spec: WireSpec, fmt: FP8Format) -> list[torch.Tensor]:
    """A cohort's stacked ``(P, R, LANE)`` tiles -> each client's payload
    codes, one sub-byte encode launch (``quant_pack_sub_many``; ``keys`` the
    ``(P, 2)`` words, None deterministic); bitwise :func:`pack` of each."""
    return _payload_codes(dispatch.quant_pack_sub_many(x3, a3, keys, fmt=fmt), spec, fmt)


def encode_amax_many(x3: torch.Tensor, a3: torch.Tensor, keys: torch.Tensor | None,
                     spec: WireSpec, fmt: FP8Format):
    """A chunk of clients' stacked ``(P, R, LANE)`` tiles at clip tiles
    ``a3`` (one slice expanded over P is taken as it is) -> ``(each
    client's payload codes, their per-leaf raw amax (P, n_q))``, one amax
    encode launch (``quant_pack_amax_many``); each client's codes bitwise
    its :func:`pack`'s, its amax the per-leaf max of its raw tiles."""
    codes3, rowmax = dispatch.quant_pack_amax_many(x3, a3, keys, fmt=fmt)
    return _payload_codes(codes3, spec, fmt), segment_amax(rowmax, spec)


def encode_many(tiles_alphas, spec: WireSpec, keys: torch.Tensor | None,
                fmt: FP8Format) -> list[torch.Tensor]:
    """Payload codes of a cohort's planes at a sub-byte ``fmt``:
    ``tiles_alphas`` yields each client's ``(x2, a2)`` (its tiles and clip
    tiles), ``keys`` the ``(P, 2)`` words (None: det). One
    :func:`pack_many` launch a chunk of ``plane.stack_chunk`` clients, so at
    most ``plane.STACK_TILE_BYTES`` of tiles are stacked at once; a chunked encode
    is bitwise an unchunked one, and each client's codes are its
    :func:`pack`'s."""
    it, out = iter(tiles_alphas), []
    step = plane.stack_chunk(spec.n_rows)
    while chunk := list(itertools.islice(it, step)):
        x3 = torch.stack([x2 for x2, _ in chunk])
        a3 = torch.stack([a2 for _, a2 in chunk])
        del chunk
        ks = None if keys is None else keys[len(out):len(out) + x3.shape[0]]
        out += pack_many(x3, a3, ks, spec, fmt)
        del x3, a3
    return out


def assemble(codes: torch.Tensor, other: tuple, a2: torch.Tensor | None,
             spec: WireSpec, fmt: FP8Format, ref: dict | None = None) -> dict:
    """Payload codes + FP32 riders -> the full param tree, one decode launch
    at clip tiles ``a2`` (a sub-byte ``fmt``: :func:`assemble_many` of one
    client). With ``ref`` the codes are a residual: each decoded leaf is
    added to ``ref``'s."""
    if not spec.q_slots:
        return _tree(other, [], spec)
    if codes_per_byte(fmt) > 1:
        return assemble_many([{"codes": codes, "other": other}],
                             lambda chunk: ([other], a2[None]), spec, fmt, ref=ref)[0]
    vals2 = dispatch.unpack_tiles(code_tiles(codes[None], spec, fmt)[0], a2, fmt=fmt)
    rleaves = None if ref is None else tree.leaves(ref)
    q = []
    for qi, slot in enumerate(spec.q_slots):
        v = tiles_to_leaf(vals2, spec, qi)
        q.append(v if rleaves is None else f32(rleaves[slot]) + v)
    return _tree(other, q, spec)


def _tree(other: tuple, q: list, spec: WireSpec) -> dict:
    """The param tree of FP32 riders ``other`` and decoded quantized leaves ``q``."""
    out: list = [None] * spec.n_leaves
    for slot, leaf in zip(spec.other_slots, other):
        out[slot] = leaf
    for slot, leaf in zip(spec.q_slots, q):
        out[slot] = leaf
    return tree.unflatten(list(spec.names), out)


def assemble_many(payloads: list[dict], clips, spec: WireSpec, fmt: FP8Format,
                  ref: dict | None = None, codes: torch.Tensor | None = None) -> list[dict]:
    """A cohort's payloads at a sub-byte ``fmt`` -> their param trees: one
    ``unpack_sub_many`` launch a chunk of ``plane.stack_chunk`` clients,
    each client's trees bitwise its :func:`assemble`'s. ``clips(chunk)``
    gives a chunk of payloads' FP32 riders and their ``(p, n_rows, 1 |
    LANE)`` clip tiles; ``codes``, where the caller holds them so, is the
    payloads' codes as one ``(P, n)`` stack. The chunk's code tiles are
    :func:`code_tiles` of its codes. With ``ref`` the codes are residuals:
    each decoded leaf is added to ``ref``'s."""
    out: list[dict] = []
    step = plane.stack_chunk(spec.n_rows)
    rleaves = None if ref is None else tree.leaves(ref)
    for lo in range(0, len(payloads), step):
        chunk = payloads[lo:lo + step]
        c = (torch.stack([pl["codes"] for pl in chunk]) if codes is None
             else codes[lo:lo + step])
        others, a3 = clips(chunk)
        vals3 = dispatch.unpack_sub_many(code_tiles(c, spec, fmt), a3, fmt=fmt)
        q = []
        for qi, slot in enumerate(spec.q_slots):
            r0, rows, shape = spec.q_row_offsets[qi], spec.q_rows[qi], spec.q_shapes[qi]
            v = vals3[:, r0:r0 + rows].reshape(len(chunk), -1)[:, :nelem(shape)].reshape(
                len(chunk), *shape)
            q.append(v if rleaves is None else f32(rleaves[slot]) + v)
        out += [_tree(o, [v[i] for v in q], spec) for i, o in enumerate(others)]
    return out


def tiles_to_leaf(vals2: torch.Tensor, spec: WireSpec, qi: int) -> torch.Tensor:
    """Slice quantized leaf ``qi`` out of a decoded tile buffer."""
    r0, rows, shape = spec.q_row_offsets[qi], spec.q_rows[qi], spec.q_shapes[qi]
    return vals2[r0:r0 + rows].reshape(-1)[:nelem(shape)].reshape(shape)


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
    codes = pack(weight_tiles(leaves, spec), alpha_tiles(other, spec),
                 key2 if mode == "rand" else None, spec, fmt)
    return {"codes": codes, "other": other}


def decode(payload: dict, spec: WireSpec, fmt: FP8Format = E4M3) -> dict:
    """Unpack a wire payload back into the full param tree (one kernel launch)."""
    other = tuple(payload["other"])
    a2 = alpha_tiles(other, spec) if spec.q_slots else None
    return assemble(payload["codes"], other, a2, spec, fmt)
