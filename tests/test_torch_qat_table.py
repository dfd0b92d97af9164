"""B1/B2's per-call scale table (``csrc/fp8_common.cuh::scale_table_build``)
replayed in plain torch (``ref.scale_thresholds``, ``ref.scale_table``,
``ref.table_p``) against det_code's own p and s.

The kernels take s from the table instead of ``exp2(max(floor(log2|xc| +
b), 1) - b - m)``; the table's thresholds are found with the same log2, so
wherever log2 is non-decreasing (the card's is checked over every positive
f32 by ``chip_smoke.py``) the table's p is det_code's, and its s, one exp2f
of the same input, det_code's to the bit. Here the replay, with this CPU's
log2, must give exactly ``ref._scale_p``'s p, and exp2 of it its s, on a
million random f32 below alpha and on every f32 within 64 ULP of each
threshold, for the four formats at several clips. Exact equality: no
tolerance. (s is compared as exp2 of the table's p over the same long
tensor: this CPU's torch.exp2 may round a short tensor's elements unlike a
long one's.)
"""
import numpy as np
import pytest
import torch

from repro_torch.core.fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0
from repro_torch.kernels import ref

FMTS = {"e4m3": E4M3, "e5m2": E5M2, "e2m1": FP4_E2M1, "e3m0": FP4_E3M0}
ALPHAS = (4.0, 2.7, 0.0731, 1.0, 448.0, 1e-3, 1e-12, 37.0)


def _det_p_s(xc, alpha, fmt):
    a = torch.clamp(torch.tensor(alpha, dtype=torch.float32), min=1e-12)
    return ref._scale_p(xc, ref._bias(a, fmt), fmt)


def _below_alpha(alpha, n, seed):
    """n f32 in [-alpha, alpha]: half uniform over the bit patterns of
    [0, alpha] (every binade alike), half normal at alpha's scale, clipped;
    signs random; zero and +-alpha included."""
    rng = np.random.default_rng(seed)
    a = np.float32(max(alpha, 1e-12))
    top = int(np.array(a, np.float32).view(np.int32))
    bits = rng.integers(0, top + 1, n // 2, dtype=np.int64).astype(np.int32).view(np.float32)
    norm = np.clip(rng.standard_normal(n - n // 2).astype(np.float32) * a, -a, a)
    v = np.concatenate([bits, norm, np.array([0.0, a, -a], np.float32)])
    v = np.where(rng.random(v.size) < 0.5, -v, v).astype(np.float32)
    return torch.from_numpy(v)


def _near(thr, ulps=64):
    """Every f32 within ``ulps`` ULP of each threshold, both signs."""
    bits = thr.view(torch.int32).to(torch.int64)[:, None] + torch.arange(-ulps, ulps + 1)
    v = bits.clamp(min=0).to(torch.int32).view(torch.float32).flatten()
    return torch.cat([v, -v])


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("fmt", list(FMTS))
def test_table_scale_is_det_codes_scale(fmt, alpha):
    f = FMTS[fmt]
    a = torch.tensor(alpha, dtype=torch.float32)
    table = ref.scale_table(a, f)
    assert table[3], "the table holds every clip the kernels see"
    thr = ref.scale_thresholds(a, f)
    af = torch.clamp(a, min=1e-12)
    xc = torch.cat([_below_alpha(alpha, 10 ** 6, 0), _near(thr)])
    xc = torch.minimum(torch.maximum(xc, -af), af)
    p, s = _det_p_s(xc, alpha, f)
    got = ref.table_p(xc, table)
    assert torch.equal(got, p), f"{int((got != p).sum())} exponents differ"
    s_tab = torch.exp2(got - ref._bias(af, f) - f.mant)
    assert torch.equal(s_tab, s)
    # and the grid point built on it is quant_det's
    assert torch.equal(s_tab * torch.round(xc / s_tab), ref.quant_det(xc, a, f))


@pytest.mark.parametrize("fmt", list(FMTS))
def test_thresholds_are_the_least_f32_of_each_exponent(fmt):
    """T_k is the least f32 with floor(log2(v) + b) >= k: v reaches k, its
    predecessor does not, and the thresholds climb one exponent a step."""
    f = FMTS[fmt]
    a = torch.tensor(2.7)
    b = ref._bias(a, f)
    thr = ref.scale_thresholds(a, f)
    k = torch.arange(2, thr.numel() + 2, dtype=torch.float32)
    prev = (thr.view(torch.int32) - 1).view(torch.float32)
    assert torch.equal(ref._p_raw(thr, b) >= k, torch.ones_like(k, dtype=torch.bool))
    assert torch.equal(ref._p_raw(prev, b) < k, torch.ones_like(k, dtype=torch.bool))
    assert bool((thr[1:] > thr[:-1]).all())
    assert thr.numel() == int(torch.clamp(ref._p_raw(a, b), min=1)) - 1


@pytest.mark.parametrize("alpha", (4.0, 1e-12))
@pytest.mark.parametrize("fmt", list(FMTS))
def test_table_rows_run_from_below_t2_to_alphas_binade(fmt, alpha):
    """Row 0 (T_2's binade less one) has p 1 and no threshold, so every |xc|
    below it, zero and subnormals included, takes p = 1; each row's p is the
    last row's, or one more where a threshold was crossed; the last row is
    alpha's binade; every threshold sits in exactly one row."""
    f = FMTS[fmt]
    a = torch.tensor(alpha)
    base, thr, p_lo, ok = ref.scale_table(a, f)
    assert ok and bool(torch.isinf(thr[0])) and float(p_lo[0]) == 1.0
    steps = p_lo[1:] - p_lo[:-1]
    assert bool(((steps == 0) | (steps == 1)).all())
    assert base + thr.numel() - 1 == int(a.view(torch.int32)) >> 23
    t = ref.scale_thresholds(a, f)
    assert torch.equal(thr[torch.isfinite(thr)], t)
    tiny = torch.tensor([0.0, 1e-45, -1e-40, 1e-38])
    assert torch.equal(ref.table_p(tiny, (base, thr, p_lo, ok)), torch.ones(4))

