"""The FP8 wire pair's per-row route (``csrc/quant_pack.cu``,
``csrc/unpack.cu``) replayed in plain torch against the twins and the
reference.

Where every element of a row shares one clip, the kernels compute the bias
once a row; the decode takes each step from the row's scale table
(``csrc/fp8_common.cuh::wire_row_scales``: s for every exponent field, the
same expression as ``decode_code``'s exp2f), the encode its p and s from
B1/B2's threshold table where that holds the clip (``wire_table_build``;
``ref.wire_table_ok``, ``ref.table_p``), whose steps are the same. The
replay (``ref.wire_row_scales``, ``ref.quant_pack_rows``,
``ref.unpack_rows``) must give exactly
``ref.quant_pack_tiles``' codes and ``ref.unpack_tiles``' values (bitwise,
no tolerance) on every code byte, on random inputs and on the edges: +-0,
+-alpha and beyond, every grid point and midpoint of every exponent, the
top mantissa and its bin-edge overflow, f32 subnormals; E4M3 and E5M2
(the decode also both FP4 formats), det and counter-RNG rounding, on runs
of rows whose clips change, alphas from 1e-12 to 448. (The replay takes
exp2 over whole 32-element vectors: this CPU's torch.exp2 rounds a short
tensor's tail unlike a long tensor's body.)

Against the JAX package's interpret-mode ``quant_pack_tiles`` /
``unpack_tiles``, from numpy inputs made from a seed, the North star's tie
bars: codes equal but for adjacent-grid ties (at most 1e-5 of codes,
rounded up, each one code apart; seen: one of 20480, on a stochastic E5M2
plane), values decoded from the SAME codes within relative 4e-6
(``test_torch_codec``'s bar).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as r_fp8
from repro.kernels import fp8_quant as r_kern
from repro_torch.core.fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0
from repro_torch.kernels import ref

FMTS = {"e4m3": E4M3, "e5m2": E5M2, "e2m1": FP4_E2M1, "e3m0": FP4_E3M0}
R_FMTS = {"e4m3": r_fp8.E4M3, "e5m2": r_fp8.E5M2}
ALPHAS = (1e-12, 448.0, 4.0, 2.7, 0.0731)
KEY = np.array([2718281828, 3141592653], np.uint32)
VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5


def _tkey() -> torch.Tensor:
    return torch.from_numpy(KEY.astype(np.int64)).to(torch.uint32)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _runs(rows_each: int):
    """Rows in runs of changing clips: each alpha of ALPHAS for
    ``rows_each`` rows, then the five alternating row by row."""
    run = [a for a in ALPHAS for _ in range(rows_each)]
    return run + [ALPHAS[i % len(ALPHAS)] for i in range(len(ALPHAS))]


def _edges(alpha: float, fmt) -> np.ndarray:
    """f32 values at the edges of ``fmt``'s grid at clip ``alpha``: every
    grid point and midpoint of every exponent (the top mantissa and its
    bin-edge overflow among them) and their f32 neighbours, every f32 within
    8 ULP of each exponent threshold, +-0, +-alpha and its neighbours,
    beyond alpha, f32 subnormals; both signs."""
    a = torch.tensor(max(alpha, 1e-12), dtype=torch.float32)
    s = ref.wire_row_scales(a.reshape(1, 1), fmt)[0, 1:]          # p = 1 .. 2^e - 1
    v = torch.arange(2 ** (fmt.mant + 1) + 1, dtype=torch.float32)
    pts = torch.cat([(v[:, None] * s[None, :]).flatten(),
                     ((v[:, None] + 0.5) * s[None, :]).flatten()])
    up, down = torch.full_like(pts, np.inf), torch.full_like(pts, -np.inf)
    pts = torch.cat([pts, torch.nextafter(pts, up), torch.nextafter(pts, down)])
    # every f32 within 8 ULP of each exponent threshold (the table's compares)
    thr = ref.scale_thresholds(a, fmt)
    near = (thr.view(torch.int32).to(torch.int64)[:, None] + torch.arange(-8, 9)).flatten()
    pts = torch.cat([pts, near.clamp(min=0).to(torch.int32).view(torch.float32)])
    special = torch.tensor([0.0, float(a), float(torch.nextafter(a, torch.tensor(np.inf))),
                            float(torch.nextafter(a, torch.tensor(0.0))), 2.0 * float(a),
                            1e30, 1e-45, 1e-40, 1.1754942e-38, 1.1754944e-38])
    pts = torch.cat([pts, special]).numpy().astype(np.float32)
    return np.concatenate([pts, -pts])


def _plane(fmt, seed: int, edges: bool):
    """``(R, 1024)`` tiles on runs of changing clips and their ``(R, 1)``
    column: random values at each row's clip scale (half normal, half
    uniform over the bit patterns below it) and, with ``edges``, a row's
    edge values in its first columns."""
    rng = np.random.default_rng(seed)
    alphas = _runs(3)
    x = np.empty((len(alphas), 1024), np.float32)
    for r, alpha in enumerate(alphas):
        a = np.float32(max(alpha, 1e-12))
        top = int(np.array(a, np.float32).view(np.int32))
        bits = rng.integers(0, top + 1, 512).astype(np.int32).view(np.float32)
        norm = (rng.standard_normal(512) * a * 0.6).astype(np.float32)
        row = np.concatenate([bits, norm])
        row = np.where(rng.random(1024) < 0.5, -row, row).astype(np.float32)
        if edges:
            e = _edges(alpha, fmt)
            e = e[rng.permutation(e.size)][:1024]
            row[:e.size] = e
        x[r] = row
    col = np.maximum(np.array(alphas, np.float32), np.float32(1e-12)).reshape(-1, 1)
    return x, col


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("layout", ["column", "full"])
def test_decode_table_is_unpack_tiles_on_every_code(fmt, layout):
    """Every code byte (FP4: its 16 codes, and every byte) at every clip of
    the runs: the per-row route's values are unpack_tiles' bit for bit."""
    f = FMTS[fmt]
    alphas = _runs(2)
    col = torch.tensor(alphas, dtype=torch.float32).clamp(min=1e-12).reshape(-1, 1)
    codes = torch.arange(1024) % (16 if f.bits == 4 and layout == "column" else 256)
    c2 = codes.to(torch.uint8).repeat(len(alphas), 1)
    a2 = col if layout == "column" else col.expand(c2.shape).contiguous()
    assert _bits_equal(ref.unpack_rows(c2, col, f), ref.unpack_tiles(c2, a2, f))


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("rounding", ["det", "rand"])
@pytest.mark.parametrize("edges", [False, True])
def test_encode_rows_is_quant_pack_tiles(fmt, rounding, edges):
    """Random and edge inputs on runs of changing clips: the per-row
    route's codes, p from the threshold table (every clip here fits it),
    are quant_pack_tiles' bit for bit, and so are the values the per-row
    decode gives them."""
    f = FMTS[fmt]
    x, col = _plane(f, seed=5 + edges, edges=edges)
    x, col = torch.from_numpy(x), torch.from_numpy(col)
    assert all(ref.wire_table_ok(a, f) for a in torch.unique(col))
    key = _tkey() if rounding == "rand" else None
    want = ref.quant_pack_tiles(x, col, key, f)
    got = ref.quant_pack_rows(x, col, key, f)
    assert torch.equal(got, want), f"{int((got != want).sum())} codes differ"
    assert torch.equal(want, ref.quant_pack_tiles(x, col.expand(x.shape).contiguous(), key, f))
    assert _bits_equal(ref.unpack_rows(got, col, f), ref.unpack_tiles(want, col, f))


@pytest.mark.parametrize("row0", [1, 7, 19])
@pytest.mark.parametrize("layout", ["column", "full"])
def test_quant_pack_tiles_from_row0_is_the_planes_slice(row0, layout):
    """The twin on a plane's rows from ``row0`` on, its counter bits drawn
    at the plane's element indices (``row0``), gives the whole plane's
    stochastic codes there, as a chunked check of the card's codes needs;
    det codes do not depend on it."""
    x, col = _plane(E4M3, seed=11, edges=False)
    x, a = torch.from_numpy(x), torch.from_numpy(col)
    if layout == "full":
        a = a.expand(x.shape).contiguous()
    whole = ref.quant_pack_tiles(x, a, _tkey())
    assert torch.equal(ref.quant_pack_tiles(x[row0:], a[row0:], _tkey(), row0=row0),
                       whole[row0:])
    assert not torch.equal(ref.quant_pack_tiles(x[row0:], a[row0:], _tkey()), whole[row0:])
    assert torch.equal(ref.quant_pack_tiles(x[row0:], a[row0:], None, row0=row0),
                       ref.quant_pack_tiles(x, a)[row0:])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_row_scales_are_the_steps_of_every_exponent(fmt, alpha):
    """Entry k of a row's table is the encode's s at p = k and the decode's
    at field k, taken over the same long tensor."""
    f = FMTS[fmt]
    a = torch.tensor([[max(alpha, 1e-12)]], dtype=torch.float32)
    b = ref._bias(a, f)
    k = torch.arange(2 ** f.exp, dtype=torch.float32).clamp(min=1.0)
    p = k.repeat(64).reshape(1, -1)                  # one long tensor of p = max(k, 1)
    s = torch.exp2(p - b - f.mant)[0, :2 ** f.exp]
    assert _bits_equal(ref.wire_row_scales(a, f)[0], s)


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("rounding", ["det", "rand"])
@pytest.mark.parametrize("layout", ["column", "full"])
def test_row_route_matches_reference_interpret_kernels(fmt, rounding, layout):
    """The replay against the JAX package's Pallas bodies (interpret mode),
    at the North star's tie bars."""
    f, rf = FMTS[fmt], R_FMTS[fmt]
    x, col = _plane(f, seed=9, edges=False)
    a = col if layout == "column" else np.broadcast_to(col, x.shape).copy()
    rk = None if rounding == "det" else jnp.asarray(KEY)
    tk = None if rounding == "det" else _tkey()
    rc = np.asarray(r_kern.quant_pack_tiles(jnp.asarray(x), jnp.asarray(a), rk, fmt=rf,
                                            interpret=True)).astype(np.int32)
    tc = ref.quant_pack_rows(torch.from_numpy(x), torch.from_numpy(col), tk, f)
    tcn = tc.numpy().astype(np.int32)
    diff = tcn != rc
    assert int(diff.sum()) <= math.ceil(TIE_FRAC * rc.size)
    assert np.all(np.abs(tcn[diff] - rc[diff]) == 1)
    # decoded from the SAME codes
    ru = np.asarray(r_kern.unpack_tiles(jnp.asarray(rc.astype(np.uint8)), jnp.asarray(a), fmt=rf,
                                        interpret=True), np.float64)
    tu = ref.unpack_rows(torch.from_numpy(rc.astype(np.uint8)), torch.from_numpy(col),
                         f).numpy().astype(np.float64)
    bad = int(np.sum(np.abs(tu - ru) > VALUE_RTOL * np.abs(ru)))
    assert bad <= math.ceil(TIE_FRAC * ru.size), f"{bad} values beyond rtol {VALUE_RTOL}"
