"""B10/B11, the fused QAT matrix products: the port's plain twins
(``repro_torch.kernels.ref.qat_matmul``, ``qat_matmul_dx``,
``qat_matmul_dw``, which the CUDA kernels of ``csrc/qat_matmul.cu`` equal
bitwise on the card) against the reference's own Pallas kernels in
interpret mode (``repro.kernels.fp8_matmul``), and the port's
``dispatch.qat_matmul`` autograd Function against the reference's
``dispatch.qat_matmul`` VJP under ``REPRO_KERNEL_BACKEND=interpret``.

Inputs are seeded numpy arrays at ragged shapes (no dimension a multiple of
the kernels' tiles), with activations beyond and on the clip beta, the
largest weight exactly on its clip alpha (alpha = max|w|, the init) and
others beyond a smaller alpha, and a cotangent signed like the forward
output.

Tolerances, and why:

* out, gx and gw: each element within 1e-5 of its magnitude sum
  (``|xq| @ |wq|`` and the like, in f64). The twin sums in ascending
  reduction order one product at a time; XLA's dot inside the interpret
  kernel sums in its own blocked order, so the two round differently. Up
  to 1e-3 of the elements may differ by more: an operand whose code is an
  adjacent-grid tie between XLA's ``log2``/``exp2`` and torch's (ROADMAP
  North star); none is seen at these seeds.
* g_beta and g_alpha: within 1e-5 of the magnitude sum of their terms, as
  ``tests/test_torch_rand.py`` holds them: a scalar f32 sum whose terms
  nearly cancel is off by more than its own size's relative rounding.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fp8 import E4M3 as R_E4M3
from repro.core.fp8 import E5M2 as R_E5M2
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_matmul as r_fm
from repro_torch.core.fp8 import E4M3, E5M2
from repro_torch.kernels import dispatch, fp8_matmul, ref

FMTS = {"e4m3": (R_E4M3, E4M3), "e5m2": (R_E5M2, E5M2)}
ELEM_RTOL = 1e-5
TIE_FRAC = 1e-3
SUM_RTOL = 1e-5


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(m, k)) * 1.5).astype(np.float32)
    x.flat[rng.integers(0, x.size, 3)] = 2.5          # exactly on beta
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    beta = np.float32(2.5)
    alpha = np.float32(np.abs(w).max())                 # max|w| on the clip
    out = np.asarray(r_fm.qat_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta),
                                     jnp.asarray(alpha), interpret=True))
    g = (np.abs(rng.normal(size=(m, n))) * np.sign(out)).astype(np.float32)
    return x, w, beta, alpha, g


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _q(a, clip, fmt):
    return ref.quant_det(_t(a), _t(clip), fmt).double().numpy()


def _close(port, ref_, mag, label):
    d = np.abs(np.asarray(port, np.float64) - np.asarray(ref_, np.float64))
    bad = int(np.sum(d > ELEM_RTOL * mag + 1e-30))
    assert bad <= TIE_FRAC * d.size, f"{label}: {bad} of {d.size} beyond {ELEM_RTOL} of |terms|"


def _clip_terms(cot, e, clip, fmt):
    """Magnitude sum of the clip cotangent's terms (f64)."""
    e_t, c = _t(e), torch.tensor(float(np.asarray(clip).reshape(())))
    b = 2.0 ** fmt.exp - torch.log2(c) + fmt.mant_const - 1.0
    inside = (e_t.abs() <= c).double()
    ec = torch.clamp(e_t, -c, c)
    p = torch.clamp(torch.floor(torch.log2(ec.abs()) + b), min=1.0)
    s = torch.exp2(p - b - fmt.mant)
    y = ec / s
    term = torch.sign(e_t) * (1 - inside) + (torch.round(y) - y) * s / c
    return float(np.sum(np.abs(np.asarray(cot, np.float64) * term.double().numpy())))


@pytest.mark.parametrize("shape", [(77, 130, 200), (5, 17, 3), (33, 64, 129)])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_twins_match_reference_interpret_kernels(shape, fmt):
    rfmt, tfmt = FMTS[fmt]
    x, w, beta, alpha, g = _inputs(*shape)
    jx, jw, jb, ja, jg = map(jnp.asarray, (x, w, beta, alpha, g))
    r_out = r_fm.qat_matmul(jx, jw, jb, ja, fmt=rfmt, interpret=True)
    r_gx, r_gb = r_fm.qat_matmul_dx(jg, jx, jw, jb, ja, fmt=rfmt, interpret=True)
    r_gw, r_ga = r_fm.qat_matmul_dw(jg, jx, jw, jb, ja, fmt=rfmt, interpret=True)

    out = ref.qat_matmul(_t(x), _t(w), _t(beta), _t(alpha), tfmt)
    gx, gb = ref.qat_matmul_dx(_t(g), _t(x), _t(w), _t(beta), _t(alpha), tfmt)
    gw, ga = ref.qat_matmul_dw(_t(g), _t(x), _t(w), _t(beta), _t(alpha), tfmt)

    xq, wq = np.abs(_q(x, beta, tfmt)), np.abs(_q(w, alpha, tfmt))
    _close(out, r_out, xq @ wq, "out")
    gxq = g.astype(np.float64) @ _q(w, alpha, tfmt).T
    _close(gx, r_gx, np.abs(g) @ wq.T, "gx")
    gwq = _q(x, beta, tfmt).T @ g.astype(np.float64)
    _close(gw, r_gw, xq.T @ np.abs(g), "gw")
    assert abs(float(gb) - float(r_gb)) <= SUM_RTOL * _clip_terms(gxq, x, beta, tfmt)
    assert abs(float(ga) - float(r_ga)) <= SUM_RTOL * _clip_terms(gwq, w, alpha, tfmt)
    # both clips route gradient: values beyond each clip exist
    assert float(gb) != 0.0 and float(ga) != 0.0


def test_twin_sums_in_ascending_reduction_order():
    """The twin is the kernel's sum order, one product at a time, not a
    library product: on the card the kernel equals it bitwise."""
    x, w, beta, alpha, _ = _inputs(9, 300, 7, seed=3)
    xq = ref.quant_det(_t(x), _t(beta))
    wq = ref.quant_det(_t(w), _t(alpha))
    want = torch.zeros(9, 7)
    for kk in range(300):
        want = want + xq[:, kk:kk + 1] * wq[kk:kk + 1, :]
    assert torch.equal(ref.qat_matmul(_t(x), _t(w), _t(beta), _t(alpha)), want)


@pytest.mark.parametrize("shape", [(77, 130, 200), (32, 64, 48)])
def test_dispatch_vjp_matches_reference_kernel_path(shape, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    x, w, beta, alpha, g = _inputs(*shape, seed=1)
    ja = jnp.asarray(alpha).reshape(1, 1)   # a stacked clip's per-layer slice
    r_out, vjp = jax.vjp(lambda a, b, c, d: r_dispatch.qat_matmul(a, b, c, d),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(beta), ja)
    r_gx, r_gw, r_gb, r_ga = vjp(jnp.asarray(g))

    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tb = _t(beta).reshape(()).requires_grad_()
    ta = _t(alpha).reshape(1, 1).requires_grad_()
    out = dispatch.qat_matmul(tx, tw, tb, ta)
    out.backward(_t(g))
    assert tb.grad.shape == () and ta.grad.shape == (1, 1)
    xq, wq = np.abs(_q(x, beta, E4M3)), np.abs(_q(w, alpha, E4M3))
    _close(out.detach(), r_out, xq @ wq, "out")
    _close(tx.grad, r_gx, np.abs(g) @ wq.T, "gx")
    _close(tw.grad, r_gw, xq.T @ np.abs(g), "gw")
    gxq = g.astype(np.float64) @ _q(w, alpha, E4M3).T
    gwq = _q(x, beta, E4M3).T @ g.astype(np.float64)
    assert abs(float(tb.grad) - float(r_gb)) <= SUM_RTOL * _clip_terms(gxq, x, beta, E4M3)
    assert abs(float(ta.grad[0, 0]) - float(np.asarray(r_ga).reshape(()))) <= \
        SUM_RTOL * _clip_terms(gwq, w, alpha, E4M3)


def test_dispatch_runs_the_three_kernels_once_each_per_use(monkeypatch):
    """Forward and backward go through the B10/B11 wrappers (on the CPU the
    wrappers take the twins): one forward and one of each backward per use."""
    calls = []
    x, w, beta, alpha, g = _inputs(6, 10, 4, seed=2)
    for n in ("qat_matmul", "qat_matmul_dx", "qat_matmul_dw"):
        f = getattr(fp8_matmul, n)
        monkeypatch.setattr(fp8_matmul, n,
                            lambda *a, _n=n, _f=f, **kw: calls.append(_n) or _f(*a, **kw))
    tx = _t(x).requires_grad_()
    out = dispatch.qat_matmul(tx, _t(w), _t(beta).reshape(()), _t(alpha).reshape(1, 1))
    out.backward(_t(g))
    assert calls == ["qat_matmul", "qat_matmul_dx", "qat_matmul_dw"]


def test_dispatch_rejects_what_the_kernels_do_not_take():
    x = torch.zeros(3, 4)
    w = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="one-element clips"):
        dispatch.qat_matmul(x, w, torch.ones(2), torch.ones(()))
    with pytest.raises(ValueError, match="2-D x and w"):
        dispatch.qat_matmul(torch.zeros(2, 3, 4), w, torch.ones(()), torch.ones(()))
    with pytest.raises(ValueError, match=r"x \(M, K\) and w \(K, N\)"):
        fp8_matmul._check_operands(x, torch.zeros(5, 5), torch.ones(()), torch.ones(()))
