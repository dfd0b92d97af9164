"""The staging arithmetic of the B10 / B11 (dx, dw) tensor-core kernels
(``csrc/qat_matmul.cu``), on the CPU: ``ref.split_bf16x3`` (the three-way
bf16 split of the f32 cotangent), ``ref.quant_det_frame`` (a quantized
operand as its integer code times a power of two, exact in bf16, and the f32
step that scales it back), and the products the kernels form from them.

The kernels' contract on the card (``chip_smoke.py``, ``tests/test_torch_
cuda.py``): per element, ``|out - ref64| / mag``, with ``ref64`` the f64
product of the twin's quantized operands and ``mag`` that of their absolute
values, at most ``max(4 x the twin's worst, 2^-20)``. Here the products are
summed in f64 over the bf16 pieces and rounded once to f32, then scaled in
f32 as the kernels' epilogues do: what remains of the contract without
the card's summation order. The reference's interpret-mode Pallas kernels
(``repro.kernels.fp8_matmul``) are held to the same framed products within
1e-5 of the magnitude sum, as ``test_torch_qat_matmul.py`` holds the twins.

Inputs are seeded numpy arrays at small and ragged shapes, E4M3 and E5M2.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fp8 import E4M3 as R_E4M3
from repro.core.fp8 import E5M2 as R_E5M2
from repro.kernels import fp8_matmul as r_fm
from repro_torch.core.fp8 import E4M3, E5M2
from repro_torch.kernels import ref

FMTS = {"e4m3": (R_E4M3, E4M3), "e5m2": (R_E5M2, E5M2)}
ELEM_RTOL = 1e-5
SHAPES = [(77, 130, 200), (5, 17, 3), (1, 1, 1), (33, 64, 129), (32, 256, 1000)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 1.5).astype(np.float32)
    x.flat[rng.integers(0, x.size, 3)] = 2.5          # exactly on beta
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    beta = np.float32(2.5)
    alpha = np.float32(np.abs(w).max())                 # max|w| on the clip
    out = ref.qat_matmul(_t(x), _t(w), _t(beta), _t(alpha)).numpy()
    g = (np.abs(rng.normal(size=(m, n))) * np.sign(out)).astype(np.float32)
    return _t(x), _t(w), _t(beta), _t(alpha), _t(g)


def _ulp(v: torch.Tensor) -> torch.Tensor:
    a = v.abs()
    return torch.nextafter(a, torch.tensor(float("inf"))) - a


def framed_qat_matmul(x, w, beta, alpha, fmt):
    """B10 as its kernel stages it: frames of x and w, summed (in f64, rounded
    once), times s1(alpha) then s1(beta)."""
    fx, sx = ref.quant_det_frame(x, beta, fmt)
    fw, sw = ref.quant_det_frame(w, alpha, fmt)
    acc = (fx.double() @ fw.double()).float()
    return (acc * sw) * sx


def framed_qat_matmul_dx(g, x, w, beta, alpha, fmt, pieces=3):
    """dx as its kernel stages it: the first ``pieces`` of g's split against
    w's frame, times s1(alpha), masked at x's clip."""
    fw, sw = ref.quant_det_frame(w, alpha, fmt)
    g3 = sum(p.double() for p in ref.split_bf16x3(g)[:pieces])
    acc = (g3 @ fw.double().t()).float()
    return (acc * sw) * (x.abs() <= beta.reshape(())).float()


def framed_qat_matmul_dw(g, x, w, beta, alpha, fmt, pieces=3):
    """dw as its kernel stages it: x's frame transposed against the first
    ``pieces`` of g's split, times s1(beta), masked at w's clip."""
    fx, sx = ref.quant_det_frame(x, beta, fmt)
    g3 = sum(p.double() for p in ref.split_bf16x3(g)[:pieces])
    acc = (fx.double().t() @ g3).float()
    return (acc * sx) * (w.abs() <= alpha.reshape(())).float()


def _framed(kernel, x, w, beta, alpha, g, fmt, pieces=3):
    """``(framed, twin, ref64, mag)`` of one product: its framed staging,
    the twin's output and the f64 product with its magnitudes."""
    if kernel == "qat_matmul":
        return (framed_qat_matmul(x, w, beta, alpha, fmt),
                ref.qat_matmul(x, w, beta, alpha, fmt), *ref.qat_matmul_f64(x, w, beta, alpha, fmt))
    staged = {"qat_matmul_dx": framed_qat_matmul_dx, "qat_matmul_dw": framed_qat_matmul_dw}
    return (staged[kernel](g, x, w, beta, alpha, fmt, pieces),
            getattr(ref, kernel)(g, x, w, beta, alpha, fmt)[0],
            *getattr(ref, f"{kernel}_f64")(g, x, w, beta, alpha, fmt))


# the B10 + dx cases keep their ids; dw's are added beside them
FMT_KERNELS = pytest.mark.parametrize(
    "fmt,kernels",
    [("e4m3", ("qat_matmul", "qat_matmul_dx")), ("e5m2", ("qat_matmul", "qat_matmul_dx")),
     ("e4m3", ("qat_matmul_dw",)), ("e5m2", ("qat_matmul_dw",))],
    ids=["e4m3", "e5m2", "e4m3-dw", "e5m2-dw"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_reconstructs_f32_exactly_above_the_subnormal_range(seed):
    rng = np.random.default_rng(seed)
    n = 1 << 16
    g = rng.uniform(1.0, 2.0, n) * np.exp2(rng.integers(-126, 127, n))
    g *= np.where(rng.random(n) < 0.5, -1.0, 1.0)
    edges = [0.0, -0.0, 2.0 ** -126, 2.0 ** -110, 1.0 + 2.0 ** -23, -(2.0 - 2.0 ** -23),
             3.0e38, -3.0e38, 2.0 ** -140]
    gt = _t(np.concatenate([g, edges]))
    hi, mid, lo = ref.split_bf16x3(gt)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    rec = hi.double() + mid.double() + lo.double()
    exact = gt.abs() >= 2.0 ** -110
    assert torch.equal(rec[exact], gt.double()[exact])
    # below 2^-110 the last piece is a bf16 subnormal: off by at most 2^-134
    assert float((rec - gt.double()).abs().max()) <= 2.0 ** -134
    # every piece is its f32 value exactly (no second rounding hides in lo)
    assert torch.equal(lo.float()[exact], ((gt - hi.float()) - mid.float())[exact])


@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
@pytest.mark.parametrize("alpha", [0.0731, 1.0, 2.5, 4.0, None])
def test_frame_is_the_code_times_a_power_of_two(fmt, alpha):
    _, tfmt = FMTS[fmt]
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(257, 129)) * 1.5).astype(np.float32)
    a = np.float32(np.abs(x).max() if alpha is None else alpha)
    x.flat[:4] = [a, -a, 0.0, 1e-30]
    xt, at = _t(x), _t(a)
    frame, s1 = ref.quant_det_frame(xt, at, tfmt)
    assert frame.dtype == torch.bfloat16 and s1.dtype == torch.float32
    # the code n and exponent p, from the twin's own steps (quant_det's)
    xc = ref._clip(xt, at)
    p, s = ref._scale_p(xc, ref._bias(at, tfmt), tfmt)
    n = torch.round(xc / s)
    assert torch.equal(s * n, ref.quant_det(xt, at, tfmt))
    assert torch.equal(frame.double(), n.double() * torch.exp2(p.double() - 1.0))
    assert bool((n.abs() <= 2 ** (tfmt.mant + 1)).all()) and bool((p >= 1).all())
    # +-alpha: the largest code at the top exponent, finite in bf16
    top = (2 ** (tfmt.mant + 1) - 1) * 2.0 ** (2 ** tfmt.exp - 2)
    assert frame[0, 0].item() == top and frame[0, 1].item() == -top
    # frame * s1 within one f32 ULP of quant_det
    qt = ref.quant_det(xt, at, tfmt)
    d = (frame.float() * s1 - qt).abs()
    assert bool((d <= _ulp(qt)).all())


@pytest.mark.parametrize("shape", SHAPES)
@FMT_KERNELS
def test_framed_products_meet_the_bar_against_f64(shape, fmt, kernels):
    _, tfmt = FMTS[fmt]
    x, w, beta, alpha, g = _inputs(*shape)
    for kernel in kernels:
        framed, twin, r64, mag = _framed(kernel, x, w, beta, alpha, g, tfmt)
        e_twin = ref.product_error(twin, r64, mag)
        e_frame = ref.product_error(framed, r64, mag)
        assert ref.within_bar(e_frame, e_twin), (kernel, e_frame, e_twin)
        if kernel != "qat_matmul":   # masked elements zero, and no stray nonzero
            assert ref.stray_nonzeros(framed, r64) == 0, kernel


BF16_SHAPES = [(77, 130, 200), (33, 64, 129), (32, 256, 1000)]


@pytest.mark.parametrize(
    "shape,kernel",
    [(s, "qat_matmul_dx") for s in BF16_SHAPES] + [(s, "qat_matmul_dw") for s in BF16_SHAPES],
    ids=[f"shape{i}" for i in range(3)] + [f"shape{i}-dw" for i in range(3)])
def test_a_bf16_cotangent_fails_the_bar(shape, kernel):
    """The bar is tight enough to see one rounding of g: the hi piece alone
    (g cast to bf16) misses it, for dx and for dw."""
    x, w, beta, alpha, g = _inputs(*shape, seed=5)
    out, twin, r64, mag = _framed(kernel, x, w, beta, alpha, g, E4M3, pieces=1)
    assert not ref.within_bar(ref.product_error(out, r64, mag),
                              ref.product_error(twin, r64, mag))


def test_product_error_and_bar():
    ref64 = torch.tensor([1.0, -2.0, 0.0, 3.0], dtype=torch.float64)
    mag = torch.tensor([2.0, 4.0, 0.0, 3.0], dtype=torch.float64)
    out = torch.tensor([1.5, -2.0, 0.0, 3.0])
    assert ref.product_error(out, ref64, mag) == 0.25
    assert ref.product_error(torch.tensor([1.0, -2.0, 1e-3, 3.0]), ref64, mag) == \
        pytest.approx(1e-3)   # an output where every term is 0 counts absolutely
    assert ref.within_bar(2.0 ** -20, 0.0) and not ref.within_bar(2.0 ** -19, 2.0 ** -22)
    assert ref.within_bar(4e-6, 1e-6) and not ref.within_bar(4.1e-6, 1e-6)
    assert ref.stray_nonzeros(out, ref64) == 0
    assert ref.stray_nonzeros(torch.tensor([1.0, 0.0, -1e-30, 0.0]), ref64) == 1


@pytest.mark.parametrize("shape", [(77, 130, 200), (33, 64, 129)])
@FMT_KERNELS
def test_framed_products_match_reference_interpret_kernels(shape, fmt, kernels):
    rfmt, tfmt = FMTS[fmt]
    x, w, beta, alpha, g = _inputs(*shape, seed=1)
    jx, jw, jb, ja, jg = (jnp.asarray(t.numpy()) for t in (x, w, beta, alpha, g))
    for kernel in kernels:
        if kernel == "qat_matmul":
            r_out = r_fm.qat_matmul(jx, jw, jb, ja, fmt=rfmt, interpret=True)
        else:
            r_out, _ = getattr(r_fm, kernel)(jg, jx, jw, jb, ja, fmt=rfmt, interpret=True)
        framed, _, _, mag = _framed(kernel, x, w, beta, alpha, g, tfmt)
        d = np.abs(framed.double().numpy() - np.asarray(r_out))
        assert np.all(d <= ELEM_RTOL * mag.numpy() + 1e-30), kernel


@pytest.mark.parametrize("shape", [(77, 130, 200), (64, 256, 96)])
@pytest.mark.parametrize("dx", [True, False], ids=["g_beta", "g_alpha"])
def test_clip_cotangent_bar_on_the_terms_magnitude_sum(shape, dx):
    """``ref.clip_within_bar``: the twin's clip cotangent, on a cotangent of
    random sign whose terms cancel, lies within 2^-20 of their magnitude sum
    from ``ref.qat_clip_f64``, though far from it relative to the result; an
    error of 2^-19 of the magnitude sum fails unless 4x the twin's own
    reaches it; a callable twin is read only past 2^-20."""
    x, w, beta, alpha, g = _inputs(*shape, seed=5)
    g = g * torch.from_numpy(np.random.default_rng(6).choice([-1.0, 1.0], g.shape)).float()
    twin = (ref.qat_matmul_dx if dx else ref.qat_matmul_dw)(g, x, w, beta, alpha)[1]
    clip64, mag = ref.qat_clip_f64(g, x, w, beta, alpha, dx=dx)
    assert mag > 20 * abs(clip64)                     # the terms cancel
    ok, e, e_t = ref.clip_within_bar(float(twin), clip64, mag)
    assert ok and e <= ref.BAR_FLOOR and e_t is None
    off = clip64 + 2 * ref.BAR_FLOOR * mag
    assert not ref.clip_within_bar(off, clip64, mag, float(twin))[0]
    assert ref.clip_within_bar(off, clip64, mag, clip64 + 0.75 * ref.BAR_FLOOR * mag)[0]
    assert not ref.clip_within_bar(off, clip64, mag)[0]
    read = []
    ref.clip_within_bar(float(twin), clip64, mag, lambda: read.append(1) or 0.0)
    assert read == []
