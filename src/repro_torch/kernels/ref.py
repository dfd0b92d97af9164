"""Plain PyTorch twins of the hand-written CUDA kernels.

Each function here repeats, op for op, the arithmetic of one kernel body in
``repro.kernels.fp8_quant`` (and of its CUDA port under ``csrc/``). The
wrappers in ``kernels.fp8_quant`` take a twin only for a tensor that lies on
the CPU; on the card ``chip_smoke.py`` compares each kernel with its twin on
the same inputs.

f32 throughout; the exponent bias is evaluated left to right as the kernels
do: ``((2^e - log2(a)) + log2(2 - 2^-m)) - 1``. ``torch.round`` rounds half to
even like ``jnp.round`` (and CUDA's ``rintf``).

The counter RNG (murmur3 finalizer over the element index and two u32 key
words) runs in int64 masked to 32 bits after every step: torch's CPU backend
has no uint32 multiply. Each 32x32-bit product is split into two 16-bit
halves of the constant so no intermediate exceeds 2^49.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core.fp8 import _ALPHA_FLOOR, E4M3, FP8Format

LANE = 1024        # lane width of the (rows, LANE) wire tile layout
_M32 = 0xFFFFFFFF
_INV_2_32 = 1.0 / 4294967296.0


def _bias(a: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    return 2.0 ** fmt.exp - torch.log2(a) + fmt.mant_const - 1.0


def _clip(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.maximum(x, -a), a)


def _scale_p(xc: torch.Tensor, b: torch.Tensor, fmt: FP8Format,
             saturate: bool = False):
    p = torch.floor(torch.log2(torch.abs(xc)) + b)
    p = torch.where(p > 1.0, p, 1.0)
    if saturate:
        p = torch.clamp(p, max=float(fmt.max_exp_code))
    return p, torch.exp2(p - b - fmt.mant)


def quant_det(x: torch.Tensor, alpha: torch.Tensor,
              fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``_quant_det_kernel``: Q_det with a per-tensor scalar alpha.
    ``x`` is f32 or bf16: read in its own dtype, computed in f32, written
    back in ``x.dtype``, as the reference kernel does (``out_shape`` x's)."""
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    xc = _clip(x.to(torch.float32), a)
    _, s = _scale_p(xc, b, fmt)
    return (s * torch.round(xc / s)).to(x.dtype)


def _ste(x: torch.Tensor, a: torch.Tensor, g: torch.Tensor, fmt: FP8Format):
    """The STE backward's elementwise terms, f32 ``x``, ``a`` and ``g``:
    ``(gx, route)`` with ``gx = g * 1{|x| <= a}`` and the clip cotangent's
    terms ``g * (sign(x) * 1{|x| > a} + (q - y) * s / a)``."""
    b = _bias(a, fmt)
    inside = (torch.abs(x) <= a).to(torch.float32)
    xc = _clip(x, a)
    _, s = _scale_p(xc, b, fmt)
    y = xc / s
    q = torch.round(y)
    return g * inside, g * (torch.sign(x) * (1.0 - inside) + (q - y) * s / a)


def quant_det_bwd(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor,
                  fmt: FP8Format = E4M3):
    """Twin of ``_quant_bwd_kernel``: ``(gx, g_alpha)`` of the STE backward.

    ``gx = g * 1{|x| <= a}`` in ``x.dtype`` and the f32 scalar
    ``g_alpha = sum g * (sign(x) * 1{|x| > a} + (q - y) * s / a)``; ``x`` and
    ``g`` (f32 or bf16) are read as f32, as the reference kernel reads them.
    """
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    gx, route = _ste(x.to(torch.float32), a, g.to(torch.float32), fmt)
    return gx.to(x.dtype), torch.sum(route)


def quant_det_clip_f64(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor,
                       fmt: FP8Format = E4M3) -> tuple[float, float]:
    """``(clip64, mag)``: :func:`quant_det_bwd`'s ``g_alpha`` with its terms
    (each the f64 product of ``g`` and the f32 route factor of ``_ste``)
    summed in f64, and the sum of their absolute values."""
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    xf = x.to(torch.float32)
    terms = g.double() * _ste(xf, a, torch.ones_like(xf), fmt)[1].double()
    return float(terms.sum()), float(terms.abs().sum())


_TOP = 0x7F7FFFFF          # FLT_MAX's bit pattern
_TAB_MAX, _THR_MAX = 40, 32   # csrc/fp8_common.cuh kTabMax, kThrMax


def _f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def _bits(v: torch.Tensor) -> torch.Tensor:
    return v.to(torch.float32).view(torch.int32).to(torch.int64)


def _p_raw(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """floor(log2(v) + b) in f32: ``_scale_p``'s p without its max."""
    return torch.floor(torch.log2(v) + b)


def scale_thresholds(alpha: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """The thresholds of ``csrc/fp8_common.cuh::find_thresholds`` for k = 2
    .. P: the least positive f32 v with floor(log2(v) + b) >= k, with this
    device's log2. Found here by bisection over f32 bit patterns from a
    +-256 ULP bracket around 2^(k - b) (every positive pattern where the
    bracket fails), as the kernels' slow path ``threshold`` does; their fast
    path probes 32 ULP around 2^(k - b) (then wider) and finds the same
    least v wherever log2 is non-decreasing."""
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    p_top = int(torch.clamp(_p_raw(a, b), min=1.0))
    k = torch.arange(2, p_top + 1, dtype=torch.float32, device=a.device)
    c = _bits(torch.clamp(torch.exp2(k - b), max=_f32(torch.tensor(_TOP))))
    lo = torch.where(c > 256, c - 256, 0)
    hi = torch.where(c < _TOP - 256, c + 256, _TOP)
    held = (_p_raw(_f32(lo), b) < k) & (_p_raw(_f32(hi), b) >= k)
    lo, hi = torch.where(held, lo, 0), torch.where(held, hi, _TOP)
    while bool((hi - lo > 1).any()):
        mid = lo + (hi - lo) // 2
        up = (_p_raw(_f32(mid), b) >= k) & (hi - lo > 1)
        down = ~up & (hi - lo > 1)
        hi, lo = torch.where(up, mid, hi), torch.where(down, mid, lo)
    return _f32(hi)


def scale_table(alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """Twin of ``csrc/fp8_common.cuh::scale_table_build``: ``(base, thr,
    p_lo, ok)``, a row per binade of |xc| from T_2's binade less one up to
    alpha's (exponent fields base, base + 1, ...): the threshold inside it
    (+inf if none) and p below it (the kernels keep s = 2^(p - b - m) below
    and at or above it); ``ok`` False where the kernels fall back to
    det_code."""
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    thr = scale_thresholds(alpha, fmt)
    ea = int(_bits(a)) >> 23
    base = (int(_bits(thr[0])) >> 23 if thr.numel() else ea) - 1
    n = ea - base + 1
    ok = base >= 0 and n <= _TAB_MAX and thr.numel() <= _THR_MAX
    e = torch.arange(base, base + n, dtype=torch.int64, device=a.device).clamp(min=0)
    lo = torch.where(e == 0, 0.0, _f32(e << 23))
    hi = _f32((e + 1) << 23)
    below = (thr[None, :] <= lo[:, None]).sum(dim=1)
    inside = (thr[None, :] > lo[:, None]) & (thr[None, :] < hi[:, None])
    ok = ok and bool((inside.sum(dim=1) <= 1).all())
    t_in = torch.where(inside, thr[None, :], torch.inf).amin(dim=1) if thr.numel() \
        else torch.full((n,), torch.inf, device=a.device)
    return base, t_in, (1 + below).to(torch.float32), ok


def table_p(xc: torch.Tensor, table) -> torch.Tensor:
    """det_code's p at the clipped ``xc`` from a ``scale_table``, looked up
    as ``csrc/fp8_common.cuh::table_scale`` looks up its s."""
    base, thr, p_lo, _ = table
    m = _bits(xc) & 0x7FFFFFFF
    i = ((m >> 23) - base).clamp(0, thr.numel() - 1)
    return p_lo[i] + (_f32(m) >= thr[i]).to(torch.float32)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2^32`` for 0 <= h, c < 2^32 without int64 overflow."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def counter_bits(idx: torch.Tensor, k0: int | torch.Tensor,
                 k1: int | torch.Tensor) -> torch.Tensor:
    """Per-element u32 (held in int64) from a counter and two u32 key words."""
    return _fmix32(_fmix32((idx & _M32) ^ k0) ^ k1)


def tile_counter_bits(shape: tuple[int, int], key2: torch.Tensor,
                      row0: int = 0) -> torch.Tensor:
    """counter_bits over a ``(rows, LANE)`` tile buffer whose first row is
    absolute row ``row0``: the global element index ``row * LANE + col``
    mixed with the two key words."""
    k = key2.to(torch.int64)
    idx = torch.arange(row0 * shape[1], (row0 + shape[0]) * shape[1],
                       dtype=torch.int64, device=key2.device).reshape(shape)
    return counter_bits(idx, k[0], k[1])


SITE_MIX = 0x9E3779B9     # a weight site's number times this goes into its first key word


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> the same bits as uint32 (through
    int32 and a same-width view, which every device supports)."""
    return t.to(torch.int32).view(torch.uint32)


@dataclasses.dataclass(frozen=True)
class CounterKey:
    """One weight site's stochastic-rounding bits, as a key: the counter RNG
    over the element index of the site's weight, keyed by ``key2`` (the
    client step's ``(2,)`` u32 words) with the site number mixed into the
    first word. :meth:`bits` materializes them; the B6 kernels draw the same
    bits inside (``csrc/quant_rand.cu``), so none are made on the card."""

    key2: torch.Tensor   # (2,) uint32
    site: int

    @property
    def mix(self) -> int:
        """The site's word, xor-ed into the first key word."""
        return (self.site * SITE_MIX) & _M32

    def bits(self, shape) -> torch.Tensor:
        """The site's u32 bits of ``shape``, on ``key2``'s device."""
        k = self.key2.to(torch.int64)
        idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
        return as_u32(counter_bits(idx, k[0] ^ self.mix, k[1])).reshape(tuple(shape))


def site_bits(bits, shape) -> torch.Tensor:
    """A site's u32 bits of ``shape``: ``bits`` itself, or a
    :class:`CounterKey`'s bits materialized."""
    return bits.bits(shape) if isinstance(bits, CounterKey) else bits


def _round_rand(y: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding from u32 ``bits`` (any integer dtype), as the
    kernels: ``u = bits * 2^-32``, ``floor(y) + 1{u < y - floor(y)}``."""
    u = bits.to(torch.int64).to(torch.float32) * _INV_2_32
    fl = torch.floor(y)
    return fl + (u < (y - fl)).to(torch.float32)


def quant_rand(x: torch.Tensor, alpha: torch.Tensor, bits,
               fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``_quant_rand_kernel``: Q_rand with a per-tensor scalar alpha
    and external u32 ``bits`` of x's shape (or a :class:`CounterKey`)."""
    bits = site_bits(bits, x.shape)
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    xc = _clip(x, a)
    _, s = _scale_p(xc, b, fmt)
    return s * _round_rand(xc / s, bits)


def quant_rand_bwd(x: torch.Tensor, alpha: torch.Tensor, bits,
                   g: torch.Tensor, fmt: FP8Format = E4M3):
    """Twin of ``_quant_rand_bwd_kernel``: :func:`quant_det_bwd` with the
    forward's stochastic ``q`` (same bits, or the same :class:`CounterKey`)
    in the scale term."""
    bits = site_bits(bits, x.shape)
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    inside = (torch.abs(x) <= a).to(torch.float32)
    xc = _clip(x, a)
    _, s = _scale_p(xc, b, fmt)
    y = xc / s
    q = _round_rand(y, bits)
    gx = g * inside
    ga = torch.sum(g * (torch.sign(x) * (1.0 - inside) + (q - y) * s / a))
    return gx, ga


def fake_quant_bits(x2: torch.Tensor, a2: torch.Tensor,
                    bits: torch.Tensor | None, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``fake_quant_bits_jnp``: quantize-dequantize with explicit u32
    ``bits`` (None -> round to nearest even), the saturated-exponent clamp
    included. ``a2`` broadcasts against ``x2`` and is not floored here."""
    a = a2.to(torch.float32)
    b = _bias(a, fmt)
    xc = _clip(x2, a)
    p, s = _scale_p(xc, b, fmt, saturate=True)
    y = xc / s
    q = torch.round(y) if bits is None else _round_rand(y, bits)
    vmax = float(2 ** (fmt.mant + 1) - 1)
    q = torch.where(p >= float(fmt.max_exp_code), torch.clamp(q, -vmax, vmax), q)
    return s * q


def fake_quant_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``_fake_quant_tiles_kernel`` (det) / ``_rand_kernel`` (counter
    RNG keyed by the ``(2,)`` u32 ``key2``): ``(R, LANE)`` f32 -> f32 grid
    values without codes. ``a2`` is ``(R, 1)`` or ``(R, LANE)``."""
    bits = None if key2 is None else tile_counter_bits(tuple(x2.shape), key2)
    return fake_quant_bits(x2, a2, bits, fmt)


def slice_counter_bits(shape: tuple[int, int, int], keys: torch.Tensor) -> torch.Tensor:
    """counter_bits over a ``(S, rows, LANE)`` stack of tile slices, slice s
    keyed by ``keys[s]`` (``(S, 2)`` u32) over its own element index
    ``row * LANE + col``: each slice's :func:`tile_counter_bits`."""
    k = keys.to(torch.int64)
    idx = torch.arange(shape[1] * shape[2], dtype=torch.int64,
                       device=keys.device).reshape(shape[1:])
    return counter_bits(idx, k[:, 0, None, None], k[:, 1, None, None])


def _slice_bias(a3: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """The bias of a ``(S, R, 1 | LANE)`` alpha stack, each slice's as its
    single-plane twin computes it: this CPU's log2, like its exp2
    (:func:`_exp2_vectors`), rounds a tensor's vectorized body and its tail
    differently, so a short column is taken slice by slice (a (R, LANE)
    slice is whole vectors either way)."""
    a = a3.to(torch.float32)
    if a.shape[2] == LANE:
        return _bias(a, fmt)
    return torch.stack([_bias(a[i], fmt) for i in range(a.shape[0])])


def fake_quant_tiles_many(x2: torch.Tensor, a3: torch.Tensor,
                          keys: torch.Tensor | None = None,
                          fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``fake_quant_many_kernel``: the ``(R, LANE)`` plane at G clip
    slices ``a3`` (``(G, R, 1)`` or ``(G, R, LANE)``), slice g rounded with
    ``keys[g]`` (``(G, 2)`` u32; None: to nearest even) -> ``(G, R, LANE)``;
    slice g is :func:`fake_quant_tiles` ``(x2, a3[g], keys[g])``."""
    a = a3.to(torch.float32)
    b = _slice_bias(a, fmt)
    xc = _clip(x2[None], a)
    p, s = _scale_p(xc, b, fmt, saturate=True)
    y = xc / s
    bits = None if keys is None else slice_counter_bits((a.shape[0], *x2.shape), keys)
    q = torch.round(y) if bits is None else _round_rand(y, bits)
    vmax = float(2 ** (fmt.mant + 1) - 1)
    q = torch.where(p >= float(fmt.max_exp_code), torch.clamp(q, -vmax, vmax), q)
    return s * q


def fake_quant_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                          key2: torch.Tensor | None = None, fmt: FP8Format = E4M3):
    """Twin of ``fake_quant_amax_tiles`` (B9): :func:`fake_quant_tiles` and
    the per-row raw amax ``(R, 1)``."""
    return fake_quant_tiles(x2, a2, key2, fmt), _rowmax(x2)


# ---------------------------------------------------------------------------
# B7: Q_det on the parameter plane with a per-row alpha column
# ---------------------------------------------------------------------------


def quant_det_tiles(x2: torch.Tensor, a_col: torch.Tensor,
                    fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``_quant_det_tiles_kernel``: ``(R, LANE)`` f32 plane, ``(R, 1)``
    alpha column (floored by the caller, ``core.plane``), f32 out; the
    arithmetic of :func:`quant_det` at each ``(x, a)``."""
    b = _bias(a_col, fmt)
    xc = _clip(x2, a_col)
    _, s = _scale_p(xc, b, fmt)
    return s * torch.round(xc / s)


def quant_det_tiles_bwd(x2: torch.Tensor, a_col: torch.Tensor, g2: torch.Tensor,
                        fmt: FP8Format = E4M3):
    """Twin of ``_quant_det_tiles_bwd_kernel``: ``(gx (R, LANE), ga_row (R, 1))``,
    the clip mask to the plane and each row's sum of the clip cotangent's
    terms."""
    gx, route = _ste(x2, a_col, g2, fmt)
    return gx, torch.sum(route, dim=1, keepdim=True)


def _tile_bits(shape, key2: torch.Tensor | None, row0: int = 0):
    """The counter bits of ``(R, LANE)`` tiles at ``key2`` (None: det)."""
    return None if key2 is None else tile_counter_bits(tuple(shape), key2, row0)


def _pack_codes(x2: torch.Tensor, a2: torch.Tensor, bits: torch.Tensor | None,
                fmt: FP8Format, b: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of ``_pack_code`` over the tile layout (or a stack of slices):
    int32 ``[sign|exp|mant]`` codes, stochastic from the counter ``bits``
    when given; ``b`` the alphas' bias where the caller made it."""
    a = a2.to(torch.float32)
    b = _bias(a, fmt) if b is None else b
    xc = _clip(x2, a)
    p, s = _scale_p(xc, b, fmt, saturate=True)
    return _round_code(xc / s, p, bits, fmt)


def _round_code(y: torch.Tensor, p: torch.Tensor, bits: torch.Tensor | None,
                fmt: FP8Format) -> torch.Tensor:
    """``_pack_code``'s tail: ``y = xc / s`` of the tiles at exponent ``p``,
    rounded (to nearest even, or from the counter ``bits``), to int32
    ``[sign|exp|mant]`` codes."""
    v_signed = torch.round(y) if bits is None else _round_rand(y, bits)
    sign = (v_signed < 0).to(torch.int32)
    v = torch.abs(v_signed).to(torch.int32)
    top = 2 ** (fmt.mant + 1)
    overflow = v >= top
    at_max = p >= float(fmt.max_exp_code)
    v = torch.where(overflow & at_max, top - 1,
                    torch.where(overflow, v // 2, v))
    p = torch.where(overflow & ~at_max, p + 1.0, p)
    is_normal = v >= 2 ** fmt.mant
    f = torch.where(is_normal, p.to(torch.int32), 0)
    m_field = torch.where(is_normal, v - 2 ** fmt.mant, v)
    return (sign << (fmt.exp + fmt.mant)) | (f << fmt.mant) | m_field


def quant_pack_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3, row0: int = 0) -> torch.Tensor:
    """Twin of ``_quant_pack_det_kernel`` / ``_quant_pack_rand_ctr_kernel``
    with ``_pack_code``: ``(R, LANE)`` f32 -> ``(R, LANE)`` u8 codes.

    ``a2`` is ``(R, 1)`` or ``(R, LANE)`` (already floored by the caller);
    ``key2`` a ``(2,)`` u32 tensor for stochastic rounding, None for det;
    ``row0`` the absolute row of the tiles' first (a slice of a plane draws
    its counter bits at the plane's element indices).
    """
    return _pack_codes(x2, a2, _tile_bits(x2.shape, key2, row0), fmt).to(torch.uint8)


def _decode_codes(code: torch.Tensor, a2: torch.Tensor, fmt: FP8Format,
                  b: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of ``_decode_codes``: int ``[sign|exp|mant]`` codes -> f32 grid
    values; ``b`` the alphas' bias where the caller made it."""
    b = _bias(a2.to(torch.float32), fmt) if b is None else b
    sign = (code >> (fmt.exp + fmt.mant)) & 0x1
    f = (code >> fmt.mant) & (2 ** fmt.exp - 1)
    m_field = code & (2 ** fmt.mant - 1)
    is_normal = f >= 1
    v = torch.where(is_normal, m_field + 2 ** fmt.mant, m_field)
    p_eff = torch.where(is_normal, f, 1)
    s = torch.exp2(p_eff.to(torch.float32) - b - fmt.mant)
    mag = v.to(torch.float32) * s
    return torch.where(sign == 1, -mag, mag)


def unpack_tiles(c2: torch.Tensor, a2: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``_unpack_kernel``: ``(R, LANE)`` u8 codes -> f32 grid values."""
    return _decode_codes(c2.to(torch.int32), a2, fmt)


# ---------------------------------------------------------------------------
# the FP8 wire pair's per-row route (csrc/quant_pack.cu, csrc/unpack.cu)
# ---------------------------------------------------------------------------


def _exp2_vectors(t: torch.Tensor) -> torch.Tensor:
    """``torch.exp2(t)`` over whole 32-element vectors: this CPU's exp2
    rounds a tensor's ragged tail (its scalar path) unlike its vectorized
    body, where the (R, 1024) twins take all of theirs."""
    flat = t.reshape(-1)
    pad = flat.new_zeros((-flat.numel()) % 32)
    return torch.exp2(torch.cat([flat, pad]))[:flat.numel()].reshape(t.shape)


def wire_row_scales(a_col: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``csrc/fp8_common.cuh::wire_row_scales`` for each row's clip
    of an ``(R, 1)`` column (floored by the caller): ``(R, 2^e)`` f32 with
    ``s[k] = 2^((max(k, 1) - b) - m)``, the step of exponent field k: the
    encode's ``s`` at ``p = k``, the decode's at field k (0 read as 1)."""
    b = _bias(a_col.to(torch.float32), fmt)
    k = torch.arange(2 ** fmt.exp, dtype=torch.float32, device=a_col.device).clamp(min=1.0)
    return _exp2_vectors(k - b - fmt.mant)


def wire_table_ok(alpha: torch.Tensor, fmt: FP8Format = E4M3) -> bool:
    """Whether ``csrc/fp8_common.cuh::wire_table_build`` holds the clip: B1/B2's
    table holds it (``scale_table``'s ok) and P, p at |xc| = alpha, is at
    most the format's largest exponent code."""
    return scale_table(alpha, fmt)[3] and \
        scale_thresholds(alpha, fmt).numel() + 1 <= fmt.max_exp_code


def quant_pack_rows(x2: torch.Tensor, a_col: torch.Tensor,
                    key2: torch.Tensor | None = None, fmt: FP8Format = E4M3) -> torch.Tensor:
    """The encode's per-row route (``csrc/quant_pack.cu``): ``(R, LANE)`` f32
    at an ``(R, 1)`` clip column -> u8 codes. A row whose clip the threshold
    table holds (``wire_table_ok``) takes p from it (``table_p``, as
    ``pack_code_tab``), any other row ``floor(log2|xc| + b)`` (as
    ``pack_code``); each step the row's ``wire_row_scales`` entry at p (the
    table's s is the same expression). Equal to :func:`quant_pack_tiles`."""
    a = a_col.to(torch.float32)
    b = _bias(a, fmt)
    xc = _clip(x2, a)
    p = torch.floor(torch.log2(torch.abs(xc)) + b)
    p = torch.where(p > 1.0, p, 1.0).clamp(max=float(fmt.max_exp_code))
    for alpha in torch.unique(a):
        if wire_table_ok(alpha, fmt):
            rows = a[:, 0] == alpha
            p[rows] = table_p(xc[rows], scale_table(alpha, fmt))
    s = torch.gather(wire_row_scales(a, fmt), 1, p.to(torch.int64))
    return _round_code(xc / s, p, _tile_bits(xc.shape, key2), fmt).to(torch.uint8)


def unpack_rows(c2: torch.Tensor, a_col: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """The decode's per-row route (``csrc/fp8_common.cuh::decode_code_row``):
    ``(R, LANE)`` u8 codes at an ``(R, 1)`` clip column -> f32, each step
    taken from its row's ``wire_row_scales`` at the code's exponent field.
    Equal to :func:`unpack_tiles`."""
    code = c2.to(torch.int64)
    sign = (code >> (fmt.exp + fmt.mant)) & 0x1
    f = (code >> fmt.mant) & (2 ** fmt.exp - 1)
    m_field = code & (2 ** fmt.mant - 1)
    v = torch.where(f >= 1, m_field + 2 ** fmt.mant, m_field).to(torch.float32)
    mag = v * torch.gather(wire_row_scales(a_col, fmt), 1, f)
    return torch.where(sign == 1, -mag, mag)


# ---------------------------------------------------------------------------
# sub-byte wire (B8) and the fused amax variants (B9)
# ---------------------------------------------------------------------------


def codes_per_byte(fmt: FP8Format) -> int:
    """How many ``fmt`` codes share one payload byte (1 for FP8, 2 for FP4)."""
    if fmt.bits > 8 or 8 % fmt.bits:
        raise ValueError(f"cannot byte-pack a {fmt.bits}-bit format")
    return 8 // fmt.bits


def fold_codes(codes: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """``(..., L)`` b-bit codes -> ``(..., L // (8 // b))`` u8, little-endian:
    code ``k*i + j`` in bits ``j*b .. (j+1)*b`` of byte ``i``."""
    k = codes_per_byte(fmt)
    if k == 1:
        return codes.to(torch.uint8)
    *lead, lanes = codes.shape
    c = codes.to(torch.int32).reshape(*lead, lanes // k, k)
    out = c[..., 0]
    for j in range(1, k):
        out = out | (c[..., j] << (fmt.bits * j))
    return out.to(torch.uint8)


def unfold_codes(packed: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """Inverse of :func:`fold_codes`: packed u8 ``(..., L // k)`` -> ``(..., L)``
    int32 codes."""
    k = codes_per_byte(fmt)
    p = packed.to(torch.int32)
    if k == 1:
        return p
    mask = (1 << fmt.bits) - 1
    code = torch.stack([(p >> (fmt.bits * j)) & mask for j in range(k)], dim=-1)
    return code.reshape(*p.shape[:-1], p.shape[-1] * k)


def quant_pack_sub_tiles(x2: torch.Tensor, a2: torch.Tensor,
                         key2: torch.Tensor | None, fmt: FP8Format) -> torch.Tensor:
    """Twin of ``_quant_pack_sub_det_kernel`` / ``_rand_ctr_kernel``:
    ``(R, LANE)`` f32 -> ``(R, LANE // codes_per_byte)`` u8. Tile zero fill
    packs to code 0 under both roundings."""
    return fold_codes(_pack_codes(x2, a2, _tile_bits(x2.shape, key2), fmt), fmt)


def quant_pack_sub_tiles_many(x3: torch.Tensor, a3: torch.Tensor,
                              keys: torch.Tensor | None, fmt: FP8Format) -> torch.Tensor:
    """Twin of ``quant_pack_sub_kernel`` over a cohort: ``(P, R, LANE)`` f32
    at alphas ``(P, R, 1 | LANE)``, slice p rounded with ``keys[p]`` (``(P,
    2)`` u32; None: det) -> ``(P, R, LANE // codes_per_byte)`` u8; slice p is
    :func:`quant_pack_sub_tiles` ``(x3[p], a3[p], keys[p])`` (at an 8-bit
    ``fmt``, :func:`quant_pack_tiles`)."""
    bits = None if keys is None else slice_counter_bits(tuple(x3.shape), keys)
    return fold_codes(_pack_codes(x3, a3, bits, fmt, _slice_bias(a3, fmt)), fmt)


def unpack_sub_tiles(c2: torch.Tensor, a2: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """Twin of ``_unpack_sub_kernel``: packed u8 -> ``(R, LANE)`` f32."""
    return _decode_codes(unfold_codes(c2, fmt), a2, fmt)


def unpack_sub_tiles_many(c3: torch.Tensor, a3: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """Twin of ``unpack_sub_kernel`` over a cohort: ``(P, R, LANE //
    codes_per_byte)`` packed u8 at alphas ``(P, R, 1 | LANE)`` -> ``(P, R,
    LANE)`` f32; slice p is :func:`unpack_sub_tiles` ``(c3[p], a3[p])``."""
    return _decode_codes(unfold_codes(c3, fmt), a3, fmt, _slice_bias(a3, fmt))


def _rowmax(x2: torch.Tensor) -> torch.Tensor:
    """Per-row max|x| of the raw (unclipped) tile, ``(R, 1)``."""
    return torch.amax(torch.abs(x2), dim=1, keepdim=True)


def quant_pack_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                          key2: torch.Tensor | None = None, fmt: FP8Format = E4M3):
    """Twin of ``quant_pack_amax_tiles``: :func:`quant_pack_tiles` and the
    per-row raw amax."""
    return quant_pack_tiles(x2, a2, key2, fmt), _rowmax(x2)


def quant_pack_sub_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                              key2: torch.Tensor | None, fmt: FP8Format):
    """Twin of ``quant_pack_sub_amax_tiles``: :func:`quant_pack_sub_tiles`
    and the per-row raw amax."""
    return quant_pack_sub_tiles(x2, a2, key2, fmt), _rowmax(x2)


def quant_pack_amax_tiles_many(x3: torch.Tensor, a3: torch.Tensor,
                               keys: torch.Tensor | None, fmt: FP8Format = E4M3):
    """Twin of ``quant_pack_amax_kernel`` over a cohort: ``(P, R, LANE)``
    f32 at alphas ``(P, R, 1 | LANE)`` (one slice expanded over P too),
    slice p rounded with ``keys[p]`` (``(P, 2)`` u32; None: det) -> ``(codes
    (P, R, LANE // codes_per_byte) u8, rowmax (P, R, 1))``; slice p is
    :func:`quant_pack_amax_tiles` (FP8) or :func:`quant_pack_sub_amax_tiles`
    ``(x3[p], a3[p], keys[p])``."""
    return (quant_pack_sub_tiles_many(x3, a3, keys, fmt),
            torch.amax(torch.abs(x3), dim=2, keepdim=True))


# ---------------------------------------------------------------------------
# static-table rANS (B12 and the encode mirror), ``repro.kernels.rans``
# ---------------------------------------------------------------------------

SCALE_BITS = 12            # frequency resolution: sum(freq) == 1 << SCALE_BITS
TAB = 1 << SCALE_BITS
RANS_L = 1 << 23           # lower bound of the state interval [L, 2**31)
LANES = 16                 # interleaved independent coder states
RENORMS = 2                # max bytes emitted/consumed per symbol per lane
_THRESH_SHIFT = 23 - SCALE_BITS + 8   # encoder renorm threshold: f << 19


def n_steps(n_syms: int) -> int:
    """Rows of ``LANES`` symbols for an n-symbol stream (at least 1)."""
    return max(1, -(-int(n_syms) // LANES))


def buf_cols(n_syms: int) -> int:
    """Per-lane byte capacity: ``RENORMS`` bytes a row, never overflowed."""
    return RENORMS * n_steps(n_syms)


def _sym_rows(syms: torch.Tensor) -> torch.Tensor:
    """(n,) symbols -> (steps, LANES) int64 rows, zero-padded at the tail."""
    n = syms.numel()
    rows = torch.zeros(n_steps(n) * LANES, dtype=torch.int64, device=syms.device)
    rows[:n] = syms.reshape(-1).to(torch.int64)
    return rows.reshape(-1, LANES)


def rans_encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor):
    """Twin of ``rans_encode``: (n,) symbols in [0, 256) against the (256,)
    table -> ``(buf (LANES, buf_cols(n)) u8, state (LANES,) i32, lens
    (LANES,) i32)``. Rows are coded in reverse, low byte first; a lane that
    does not emit writes to the sentinel column ``cols``, which is dropped,
    so the buffer past each lane's ``lens`` stays zero."""
    rows = _sym_rows(syms)
    cols = buf_cols(syms.numel())
    dev = syms.device
    f_rows, c_rows = freq.to(torch.int64)[rows], cum.to(torch.int64)[rows]
    lane = torch.arange(LANES, device=dev)
    x = torch.full((LANES,), RANS_L, dtype=torch.int64, device=dev)
    ptr = torch.zeros(LANES, dtype=torch.int64, device=dev)
    buf = torch.zeros((LANES, cols + 1), dtype=torch.uint8, device=dev)
    sentinel = torch.full_like(ptr, cols)
    for t in range(rows.shape[0] - 1, -1, -1):
        f, c = f_rows[t], c_rows[t]
        thresh = f << _THRESH_SHIFT
        for _ in range(RENORMS):
            emit = x >= thresh
            buf[lane, torch.where(emit, ptr, sentinel)] = (x & 0xFF).to(torch.uint8)
            x = torch.where(emit, x >> 8, x)
            ptr = ptr + emit.to(torch.int64)
        x = ((x // f) << SCALE_BITS) + (x % f) + c
    return buf[:, :cols].contiguous(), x.to(torch.int32), ptr.to(torch.int32)


def rans_enc_table(freq: torch.Tensor, cum: torch.Tensor) -> torch.Tensor:
    """The encode kernel's per-symbol table: ryg's ``rans_byte``
    ``RansEncSymbol`` at ``SCALE_BITS``, ``(256, 2)`` int32 on ``freq``'s
    device. Word 0 holds the reciprocal ``rcp`` (its u32 bits), word 1 ``bias |
    (TAB - f) << 13 | shift << 25``, so that ``x + bias + ((x * rcp) >> 32 >>
    shift) * (TAB - f)`` is ``((x // f) << SCALE_BITS) + x % f + cum`` for
    every state below ``2^31``: ``shift = ceil(log2 f) - 1`` and ``rcp =
    ceil(2^(shift + 32) / f)`` (Alverson's exact reciprocal), except ``f == 1``,
    which takes ``rcp = 2^32 - 1``, ``shift = 0`` and ``bias = cum + TAB - 1``
    (the quotient comes out as ``x - 1``)."""
    f = freq.to(torch.int64)
    c = cum.to(torch.int64)
    bits = sum((f > (1 << k)).to(torch.int64) for k in range(SCALE_BITS + 1))  # ceil(log2 f)
    one = f == 1
    shift = torch.where(one, 0, bits - 1)
    rcp = torch.where(one, (1 << 32) - 1, ((1 << (bits + 31)) + f - 1) // f)
    bias = torch.where(one, c + TAB - 1, c)
    word1 = bias | (TAB - f) << 13 | shift << 25
    rcp = torch.where(rcp >= 1 << 31, rcp - (1 << 32), rcp)     # u32 bits as int32
    return torch.stack([rcp, word1], dim=1).to(torch.int32).contiguous()


def rans_dec_table(freq: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor) -> torch.Tensor:
    """The decode kernel's slot table, as it builds it in shared memory: (TAB,)
    int64, ``freq[s] | (slot - cum[s]) << 12 | s << 24`` for ``s =
    slot2sym[slot]``, so a row decodes as ``x = (e & 0xFFF) * (x >> 12) + ((e
    >> 12) & 0xFFF)`` with symbol ``e >> 24``."""
    s = slot2sym.to(torch.int64)
    slot = torch.arange(TAB, device=s.device)
    return freq.to(torch.int64)[s] | (slot - cum.to(torch.int64)[s]) << 12 | s << 24


def rans_decode(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                freq: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor) -> torch.Tensor:
    """Twin of ``_decode_step`` / ``rans_decode_jnp``: pop ``LANES`` symbols a
    row, renormalizing by reading each lane's stream backward from
    ``lens - 1``; the byte is read at ``clip(rpos, 0, cols - 1)`` whether or
    not it is needed. Returns (n,) u8 symbols."""
    steps, cols = n_steps(n), buf.shape[1]
    dev = buf.device
    b = buf.to(torch.int64)
    freq, cum, s2s = (t.to(torch.int64) for t in (freq, cum, slot2sym))
    lane = torch.arange(LANES, device=dev)
    x = state.to(torch.int64)
    rpos = lens.to(torch.int64) - 1
    out = torch.empty((steps, LANES), dtype=torch.int64, device=dev)
    for t in range(steps):
        slot = x & (TAB - 1)
        sym = s2s[slot]
        x = freq[sym] * (x >> SCALE_BITS) + slot - cum[sym]
        for _ in range(RENORMS):
            need = x < RANS_L
            byte = b[lane, torch.clamp(rpos, 0, cols - 1)]
            x = torch.where(need, (x << 8) | byte, x)
            rpos = rpos - need.to(torch.int64)
        out[t] = sym
    return out.reshape(-1)[:n].to(torch.uint8)


# ---------------------------------------------------------------------------
# B10/B11: the fused QAT matrix products (csrc/qat_matmul.cu)
# ---------------------------------------------------------------------------
#
# Each output is summed over the reduction index in ascending order, one
# product at a time, mul and add rounded separately (``torch.matmul`` sums
# in another order). The kernels sum bf16 frames on tensor cores: they
# share the twins' codes, and each is held against the f64 product of the
# twin's quantized operands (``qat_matmul_f64``, ``qat_matmul_dx_f64``,
# ``qat_matmul_dw_f64``) at ``within_bar``. The backward's epilogue is
# ``quant_det_bwd`` of the forward operand, with the summed product as its
# cotangent.


def qat_matmul(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
               alpha: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Twin of ``qat_matmul`` (B10): ``Q_det(x; beta) @ Q_det(w; alpha)``,
    x (M, K), w (K, N) f32, summed over k in ascending order."""
    xq = quant_det(x, beta, fmt)
    wq = quant_det(w, alpha, fmt)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    for k in range(x.shape[1]):
        acc.add_(xq[:, k:k + 1] * wq[k:k + 1, :])
    return acc


def qat_matmul_dx(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """Twin of ``qat_matmul_dx`` (B11): ``(gx, g_beta)``, ``g @ wq^T`` summed
    over n in ascending order, masked and routed at x's clip ``beta``."""
    wq = quant_det(w, alpha, fmt)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for n in range(g.shape[1]):
        acc.add_(g[:, n:n + 1] * wq[:, n].reshape(1, -1))
    return quant_det_bwd(x, beta, acc, fmt)


def qat_matmul_dw(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """Twin of ``qat_matmul_dw`` (B11): ``(gw, g_alpha)``, ``xq^T @ g`` summed
    over m in ascending order, masked and routed at w's clip ``alpha``."""
    xq = quant_det(x, beta, fmt)
    acc = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for m in range(g.shape[0]):
        acc.add_(xq[m].reshape(-1, 1) * g[m:m + 1, :])
    return quant_det_bwd(w, alpha, acc, fmt)


# The staging arithmetic of the B10 / B11 tensor-core kernels, and the bar
# they are held to. Nothing on the main path calls these: they are the
# kernels' arithmetic written out for the tests and ``chip_smoke.py``.

BAR_FACTOR = 4.0          # the kernel's worst error at most 4x the twin's ...
BAR_FLOOR = 2.0 ** -20    # ... or 16 f32 ULP, whichever is larger


def split_bf16x3(g: torch.Tensor):
    """``(hi, mid, lo)`` bf16 with ``g == hi + mid + lo`` exactly for f32
    ``|g| >= 2^-110`` (within 2^-134 below): ``hi = bf16(g)``, ``mid =
    bf16(g - hi)``, ``lo = g - hi - mid`` (at most 8 significant bits), as
    ``qat_matmul.cu::split3``."""
    g = g.to(torch.float32)
    hi = g.to(torch.bfloat16)
    r = g - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def quant_det_frame(x: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """``(frame, s1)``: ``Q_det(x; alpha)`` as its code times ``2^(p - 1)``,
    exact in bf16, and the f32 grid step at ``p = 1``, as
    ``qat_matmul.cu::frame_elem`` / ``s1_of`` stage it. ``frame * s1`` is
    within one f32 ULP of ``quant_det`` (equal at ``p = 1``)."""
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    b = _bias(a, fmt)
    xc = _clip(x.to(torch.float32), a)
    p, s = _scale_p(xc, b, fmt)
    frame = (torch.round(xc / s) * torch.exp2(p - 1.0)).to(torch.bfloat16)
    return frame, torch.exp2(1.0 - b - fmt.mant)


def qat_matmul_f64(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                   alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """``(ref64, mag)``: ``xq @ wq`` and ``|xq| @ |wq|`` in f64, xq and wq
    this module's ``quant_det``."""
    xq = quant_det(x, beta, fmt).double()
    wq = quant_det(w, alpha, fmt).double()
    return xq @ wq, xq.abs() @ wq.abs()


def qat_matmul_dx_f64(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """``(ref64, mag)``: ``g @ wq^T`` and ``|g| @ |wq|^T`` in f64, both masked
    by ``1{|x| <= beta}`` (beta floored as the kernels floor it)."""
    wq = quant_det(w, alpha, fmt).double()
    b = torch.clamp(beta.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    inside = (x.abs() <= b).double()
    g64 = g.double()
    return (g64 @ wq.t()) * inside, (g64.abs() @ wq.abs().t()) * inside


def qat_matmul_dw_f64(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                      beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """``(ref64, mag)``: ``xq^T @ g`` and ``|xq|^T @ |g|`` in f64, both masked
    by ``1{|w| <= alpha}`` (alpha floored as the kernels floor it)."""
    xq = quant_det(x, beta, fmt).double()
    a = torch.clamp(alpha.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    inside = (w.abs() <= a).double()
    g64 = g.double()
    return (xq.t() @ g64) * inside, (xq.abs().t() @ g64.abs()) * inside


def product_error(out: torch.Tensor, ref64: torch.Tensor, mag: torch.Tensor) -> float:
    """The largest ``|out - ref64| / mag`` over the elements. Where ``mag ==
    0`` every term is 0: there ``|out - ref64|`` itself counts, 0 for a right
    kernel."""
    d = (out.double() - ref64).abs()
    err = torch.where(mag > 0, d / torch.where(mag > 0, mag, 1.0), d)
    return float(err.max()) if err.numel() else 0.0


def stray_nonzeros(out: torch.Tensor, ref64: torch.Tensor) -> int:
    """Elements of ``out`` that are nonzero where the masked f64 product
    ``ref64`` is zero: every masked element, and every element whose terms
    are all zero. A right dx or dw has none; a sum that cancels to zero on
    one side only is not counted, so this does not compare with a twin."""
    return int(((out != 0) & (ref64 == 0)).sum())


def within_bar(err_kernel: float, err_twin: float) -> bool:
    """The B10 / B11 contract: no less accurate than the twin, up to 4x or 16 ULP."""
    return err_kernel <= max(BAR_FACTOR * err_twin, BAR_FLOOR)


def qat_clip_f64(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                 alpha: torch.Tensor, fmt: FP8Format = E4M3, *, dx: bool):
    """``(clip64, mag)``: B11's scalar clip cotangent in f64 on the twin's
    quantized operands, and the sum of its terms' absolute values. ``dx``:
    dx's ``g_beta``, the product ``g @ wq^T`` routed at x's clip ``beta``;
    else dw's ``g_alpha``, ``xq^T @ g`` routed at w's clip ``alpha`` (each
    term the f64 product times the f32 route factor of ``_ste``)."""
    g, x, w, beta, alpha = (t.detach() for t in (g, x, w, beta, alpha))
    if dx:
        v64, z, a = g.double() @ quant_det(w, alpha, fmt).double().t(), x, beta
    else:
        v64, z, a = quant_det(x, beta, fmt).double().t() @ g.double(), w, alpha
    a = torch.clamp(a.to(torch.float32).reshape(()), min=_ALPHA_FLOOR)
    zf = z.to(torch.float32)
    terms = v64 * _ste(zf, a, torch.ones_like(zf), fmt)[1].double()
    return float(terms.sum()), float(terms.abs().sum())


def clip_within_bar(kernel: float, clip64: float, mag: float, twin=None):
    """The B10 / B11 clip-cotangent contract, on the magnitude sum of its
    terms (their f32 sum may cancel many-fold, so no relative bound on the
    result holds): ``e = |kernel - clip64| / mag`` at most ``max(4 e_twin,
    2^-20)``, :func:`within_bar`'s form, ``clip64`` and ``mag`` from
    :func:`qat_clip_f64`. ``twin`` (the twin's cotangent, or a callable
    giving it) is read only when ``e`` exceeds 2^-20. Returns ``(ok, e,
    e_twin)``, ``e_twin`` None when the twin was not read."""
    def err(v: float) -> float:
        d = abs(float(v) - clip64)
        return d / mag if mag > 0 else d
    e = err(kernel)
    if e <= BAR_FLOOR or twin is None:
        return e <= BAR_FLOOR, e, None
    e_t = err(twin() if callable(twin) else twin)
    return within_bar(e, e_t), e, e_t
