"""Stochastic QAT of the port (the Table 2 ablation) against the JAX
reference: the ``quant_rand`` / ``quant_rand_bwd`` twins (B6), the
kernel-backed autograd Function and ``wq`` in ``mode='rand'``.

The reference's kernel path draws ``jax.random.bits`` outside its kernel;
the same bits are handed to the port. Its jnp fallback ``fp8.quantize_rand``
draws with ``jax.random.uniform`` instead and is not bitwise the kernel
path (``dispatch.py:194-198``), so the port is held against the kernel path
run as the reference's tests run it on the CPU (``interpret``).

Tolerances, and why:
* values: relative 4e-6 except adjacent-grid ties at most 1e-5 of elements
  (math-library ``log2``/``exp2`` ULPs, as ``test_torch_fp8``); with the
  same bits the stochastic decisions can only move at such a tie;
* ``gx``: exact (``g * 1{|x| <= a}``);
* the scalar clip cotangent: within 5e-5 of the sum of its terms'
  magnitudes, the scale of a float32 sum's rounding error. The cotangent is
  drawn with the sign of x so the clipped terms add up, but the scale terms
  ``g (q - y) s / a`` keep random signs and still cancel: measured against
  the sum in float64, the reference's interpret-mode sum is off by up to
  4.2e-6 of the magnitude sum (3.7e-5 of the result on a (1024, 120)
  weight), the port's twin by 1e-7. An element whose value tied (see
  above) carries another ``q`` into the scale term, worth up to
  ``|g| * s / a`` of the sum, so such elements are named and their
  cotangent zeroed on both sides before the sums are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as r_qat
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_quant as r_kern
from repro_torch.core import fp8 as t_fp8
from repro_torch.core import qat as t_qat
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ref as t_ref

VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
GA_SUM_TOL = 5e-5  # of sum |terms|; largest gap seen: 4.2e-6 of it


def _x(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _bits(shape, seed):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _u32(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(torch.uint32)


def _beyond_rtol(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return np.abs(port - ref) > VALUE_RTOL * np.abs(ref)


def _ga_scale(x, a, bits, g) -> float:
    """Sum of the magnitudes of the clip cotangent's terms, in float64."""
    xt, at = _t(x), torch.as_tensor(a, dtype=torch.float32).reshape(())
    b = t_ref._bias(at, t_fp8.E4M3)
    inside = (xt.abs() <= at).to(torch.float32)
    xc = t_ref._clip(xt, at)
    _, s = t_ref._scale_p(xc, b, t_fp8.E4M3)
    y = xc / s
    q = t_ref._round_rand(y, _u32(bits))
    terms = _t(g) * (torch.sign(xt) * (1.0 - inside) + (q - y) * s / at)
    return float(terms.double().abs().sum())


def _assert_ga_close(port, ref, scale):
    assert abs(float(port) - float(ref)) <= GA_SUM_TOL * scale, (float(port), float(ref))


def _n_beyond_rtol(port, ref):
    return int(np.sum(_beyond_rtol(port, ref)))


# MLP / LeNet weight shapes and a ragged 1-D one
SHAPES = [(32, 64), (5, 5, 6, 16), (1024, 120), (84, 10), (1000,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_quant_rand_pair_twins_match_reference(shape):
    x, bits = _x(shape, 1, 0.2), _bits(shape, 2)
    g = np.abs(_x(shape, 3, 1.0)) * np.sign(x)
    a = np.float32(np.abs(x).max() * 0.7)
    ref = np.asarray(r_kern.quant_rand(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bits),
                                       interpret=True))
    port = t_ref.quant_rand(_t(x), torch.tensor(a), _u32(bits))
    ties = _beyond_rtol(port.numpy(), ref)
    assert int(ties.sum()) <= int(TIE_FRAC * ref.size)
    g[ties] = 0.0
    rgx, rga = r_kern.quant_rand_bwd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(bits),
                                     jnp.asarray(g), interpret=True)
    tgx, tga = t_ref.quant_rand_bwd(_t(x), torch.tensor(a), _u32(bits), _t(g))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    _assert_ga_close(tga, rga, _ga_scale(x, a, bits, g))


def test_quant_rand_is_unbiased_and_differs_from_det():
    """E[Q_rand(x)] == clip(x): the mean over many bit draws of one x."""
    x = _t(_x((1, 2048), 4, 0.2)).expand(256, 2048).contiguous()
    a = torch.tensor(0.3)
    bits = _u32(_bits((256, 2048), 5))
    q = t_ref.quant_rand(x, a, bits)
    clipped = torch.clamp(x[0], -0.3, 0.3)
    step = 0.3 / 15
    assert float((q.mean(0) - clipped).abs().max()) < 0.25 * step
    assert not torch.equal(q, t_ref.quant_det(x, a))


def test_dispatch_quantize_rand_matches_reference_custom_vjp(monkeypatch):
    """The kernel-pair autograd Function against the reference's Pallas
    custom VJP, fed the bits the reference draws from its key."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    x = _x((48, 40), 8, 0.3)
    a = np.float32(np.abs(x).max() * 0.6)
    g = np.abs(_x((48, 40), 9, 1.0)) * np.sign(x)
    key = jax.random.PRNGKey(7)
    bits = np.asarray(jax.random.bits(key, shape=x.shape, dtype=jnp.uint32))
    rv, rvjp = jax.vjp(lambda xx, aa: r_dispatch.quantize_rand(xx, aa, key),
                       jnp.asarray(x), jnp.asarray(a))
    rgx, rga = rvjp(jnp.asarray(g))
    tx, ta = _t(x).requires_grad_(), torch.tensor(a, requires_grad=True)
    tv = t_dispatch.quantize_rand(tx, ta, _u32(bits))
    tgx, tga = torch.autograd.grad(tv, (tx, ta), _t(g))
    assert _n_beyond_rtol(tv.detach().numpy(), rv) <= int(TIE_FRAC * x.size)
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    _assert_ga_close(tga, rga, _ga_scale(x, a, bits, g))


def test_wq_rand_mode_matches_reference_kernel_path(monkeypatch):
    """``wq`` with LSQ grad scaling in mode 'rand': value and both
    cotangents, bits from the reference's ``fold_in`` site key."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    w = _x((64, 10), 10, 0.3)
    a = np.float32(np.abs(w).max() * 0.9)
    g = np.abs(_x((64, 10), 11, 1.0)) * np.sign(w)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 2)
    bits = np.asarray(jax.random.bits(key, shape=w.shape, dtype=jnp.uint32))
    rcfg = r_qat.QATConfig(mode="rand")
    rv, rvjp = jax.vjp(lambda ww, aa: r_qat.wq(ww, aa, rcfg, key=key),
                       jnp.asarray(w), jnp.asarray(a))
    rgw, rga = rvjp(jnp.asarray(g))
    tw, ta = _t(w).requires_grad_(), torch.tensor(a, requires_grad=True)
    tv = t_qat.wq(tw, ta, t_qat.QATConfig(mode="rand"), _u32(bits))
    tgw, tga = torch.autograd.grad(tv, (tw, ta), _t(g))
    assert _n_beyond_rtol(tv.detach().numpy(), rv) <= int(TIE_FRAC * w.size)
    np.testing.assert_array_equal(tgw.numpy(), np.asarray(rgw))
    lsq = 1.0 / np.sqrt(w.size * 15)          # the LSQ gradient scale of the clip
    _assert_ga_close(tga, rga, lsq * _ga_scale(w, a, bits, g))
    with pytest.raises(ValueError, match="random bits"):
        t_qat.wq(tw, ta, t_qat.QATConfig(mode="rand"))
    with pytest.raises(ValueError, match="mode"):
        t_qat.QATConfig(mode="stochastic")


def test_plain_quantize_rand_chain_matches_twin_and_handles_stacked_alpha():
    """``core.fp8.quantize_rand`` (the CPU path for stacked clip values)
    gives the twin's values, and its STE gradient is the clip mask."""
    x = _t(_x((3, 20, 8), 12, 0.3)).requires_grad_()
    bits = _u32(_bits((3, 20, 8), 13))
    a = torch.tensor([0.2, 0.3, 0.4]).reshape(3, 1, 1)
    v = t_dispatch.quantize_rand(x, a, bits)
    for i in range(3):
        assert torch.equal(v[i].detach(), t_ref.quant_rand(x[i].detach(), a[i], bits[i]))
    (gx,) = torch.autograd.grad(v.sum(), x)
    assert torch.equal(gx, (x.detach().abs() <= a).float())
    assert torch.equal(t_fp8.quantize_rand(x.detach(), a, bits), v.detach())
    with pytest.raises(NotImplementedError, match="not ported"):
        t_dispatch.quantize_rand(torch.empty((3, 2, 2), device="meta"),
                                 torch.empty((3, 1, 1), device="meta"),
                                 torch.empty((3, 2, 2), device="meta"))
