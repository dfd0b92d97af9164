"""The port's FP8 core and kernel twins against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages. The
reference kernels run as the JAX package's own tests run them on the CPU:
the Pallas bodies under ``interpret=True``.

Tolerances, and why:
* wire codes: equal, except adjacent-grid ties from ``log2``/``exp2`` ULP
  differences between math libraries, at most 1e-5 of elements (the
  reference admits the same across its own backends);
* values on the grid: within relative 4e-6 where the grid point agrees.
  The exponent bias ``b = 2^e - log2(alpha) + ...`` (16 <= b < 32 for E4M3
  at the alphas used) may differ by up to 2 ULP = 2 * 2^-19 between math
  libraries; through ``s = exp2(p - b - m)`` that is a relative 2 * 2^-19 *
  ln 2 = 2.6e-6, plus exp2's own ULPs. A different grid point differs by
  at least 1/16 relative;
* the scalar clip cotangent: relative 1e-5 (sums run in another order).
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fp8 as r_fp8
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_quant as r_kern
from repro_torch.core import fp8 as t_fp8
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import fp8_quant as t_kern
from repro_torch.kernels import ref as t_ref

VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance in f32 ULP of the larger magnitude."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale


def _assert_values_close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bad = int(np.sum(np.abs(port - ref) > VALUE_RTOL * np.abs(ref)))
    assert bad <= int(TIE_FRAC * ref.size), f"{bad} elements beyond rtol {VALUE_RTOL}"


def _assert_codes_close(port, ref):
    port, ref = np.asarray(port).astype(np.int32), np.asarray(ref).astype(np.int32)
    diff = port != ref
    assert int(diff.sum()) <= int(TIE_FRAC * ref.size)
    # a tie moves a code to its neighbour on the grid, never across the sign
    assert np.all(np.abs(port[diff] - ref[diff]) == 1)


def _x(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _key_t(k):
    return torch.from_numpy(np.asarray(k, np.int64)).to(torch.uint32)


# LeNet's activation shapes at a small batch and a ragged weight shape
SHAPES = [(2, 32, 32, 3), (2, 16, 16, 6), (4, 1024), (5, 5, 6, 16), (1000,)]


@pytest.mark.parametrize("shape", SHAPES)
def test_quant_det_twin_matches_reference(shape):
    x = _x(shape)
    a = np.float32(np.abs(x).max() * 0.7)
    ref = r_kern.quant_det(jnp.asarray(x), jnp.asarray(a), interpret=True)
    port = t_ref.quant_det(_t(x), torch.tensor(a))
    _assert_values_close(port.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_quant_det_bwd_twin_matches_reference(shape):
    x, g = _x(shape, 1), _x(shape, 2, 1.0)
    a = np.float32(np.abs(x).max() * 0.7)
    rgx, rga = r_kern.quant_det_bwd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(g),
                                    interpret=True)
    tgx, tga = t_ref.quant_det_bwd(_t(x), torch.tensor(a), _t(g))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    np.testing.assert_allclose(float(tga), float(rga), rtol=1e-5)


@pytest.mark.parametrize("shape", [(64, 64), (8, 128, 96)])
def test_quant_det_clip_f64_sums_b2s_cotangent_terms(shape):
    """``ref.quant_det_clip_f64``: B2's g_alpha with its terms summed in f64,
    and their magnitude sum. On a cotangent of random sign the terms cancel;
    the reference's f32 g_alpha (its interpret kernel) and the twin's then
    both lie within 2^-20 of the magnitude sum from the f64 sum."""
    x, g = _x(shape, 3), _x(shape, 4, 1.0)
    a = np.float32(np.abs(x).max() * 0.8)
    _, rga = r_kern.quant_det_bwd(jnp.asarray(x), jnp.asarray(a), jnp.asarray(g),
                                  interpret=True)
    _, tga = t_ref.quant_det_bwd(_t(x), torch.tensor(a), _t(g))
    clip64, mag = t_ref.quant_det_clip_f64(_t(x), torch.tensor(a), _t(g))
    assert mag > 10 * abs(clip64)                       # the terms cancel
    for v in (float(rga), float(tga)):
        assert abs(v - clip64) <= t_ref.BAR_FLOOR * mag
    assert t_ref.clip_within_bar(float(tga), clip64, mag)[0]


@pytest.mark.parametrize("mode", ["det", "rand"])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
def test_quant_pack_tiles_twin_matches_reference(mode, alpha_layout):
    rows = 9
    x = _x((rows, 1024), 3, 0.2)
    amax = np.abs(x).max(axis=1, keepdims=True) * 0.8
    a2 = (amax if alpha_layout == "column"
          else np.broadcast_to(amax, x.shape)).astype(np.float32)
    key = np.array([123456789, 3987654321], np.uint32) if mode == "rand" else None
    ref = r_kern.quant_pack_tiles(jnp.asarray(x), jnp.asarray(a2),
                                  None if key is None else jnp.asarray(key),
                                  interpret=True)
    port = t_ref.quant_pack_tiles(_t(x), _t(a2), None if key is None else _key_t(key))
    assert port.dtype == torch.uint8
    _assert_codes_close(port.numpy(), ref)


@pytest.mark.parametrize("alpha_layout", ["column", "full"])
def test_unpack_tiles_twin_matches_reference(alpha_layout):
    rows = 7
    codes = np.random.default_rng(4).integers(0, 256, (rows, 1024)).astype(np.uint8)
    amax = np.random.default_rng(5).uniform(0.01, 3.0, (rows, 1)).astype(np.float32)
    a2 = amax if alpha_layout == "column" else np.broadcast_to(amax, codes.shape).copy()
    ref = r_kern.unpack_tiles(jnp.asarray(codes), jnp.asarray(a2), interpret=True)
    port = t_ref.unpack_tiles(_t(codes), _t(a2))
    _assert_values_close(port.numpy(), ref)


def test_counter_bits_bitwise_equal_reference():
    key = np.array([0xDEADBEEF, 0x01234567], np.uint32)
    ref = r_kern._tile_counter_bits(jnp.uint32(0), (3, 1024), jnp.uint32(key[0]),
                                    jnp.uint32(key[1]))
    port = t_ref.tile_counter_bits((3, 1024), _key_t(key))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


def test_fp8_quantize_det_and_ste_grads_match_reference():
    """The plain autograd chain of core.fp8 against jnp autodiff, away from
    the clip boundary (alpha is not any element's magnitude)."""
    x = _x((64, 33), 6)
    a = np.float32(np.abs(x).max() * 0.61)
    g = _x((64, 33), 7, 1.0)
    rv, rvjp = jax.vjp(lambda xx, aa: r_fp8.quantize_det(xx, aa), jnp.asarray(x),
                       jnp.asarray(a))
    rgx, rga = rvjp(jnp.asarray(g))
    tx, ta = _t(x).requires_grad_(), torch.tensor(a, requires_grad=True)
    tv = t_fp8.quantize_det(tx, ta)
    tgx, tga = torch.autograd.grad(tv, (tx, ta), _t(g))
    _assert_values_close(tv.detach().numpy(), rv)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(rgx), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(tga), float(rga), rtol=1e-5)


def test_dispatch_kernel_ste_matches_reference_custom_vjp(monkeypatch):
    """Kernel-pair autograd Function against the reference's Pallas custom
    VJP, with alpha = max|x| so one element sits exactly on the clip
    boundary (both send its whole gradient to x)."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    x = _x((48, 40), 8)
    a = np.float32(np.abs(x).max())
    g = _x((48, 40), 9, 1.0)
    rv, rvjp = jax.vjp(lambda xx, aa: r_dispatch.quantize_det(xx, aa),
                       jnp.asarray(x), jnp.asarray(a))
    rgx, rga = rvjp(jnp.asarray(g))
    tx, ta = _t(x).requires_grad_(), torch.tensor(a, requires_grad=True)
    tv = t_dispatch.quantize_det(tx, ta)
    tgx, tga = torch.autograd.grad(tv, (tx, ta), _t(g))
    _assert_values_close(tv.detach().numpy(), rv)
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    np.testing.assert_allclose(float(tga), float(rga), rtol=1e-5)


def test_pack_unpack_fp8_match_reference():
    x = _x((50, 20), 10)
    a = np.float32(np.abs(x).max())
    q = np.asarray(r_fp8.quantize_det(jnp.asarray(x), jnp.asarray(a)))
    ref_codes = r_fp8.pack_fp8(jnp.asarray(q), jnp.asarray(a))
    port_codes = t_fp8.pack_fp8(_t(q), torch.tensor(a))
    _assert_codes_close(port_codes.numpy(), ref_codes)
    ref_vals = r_fp8.unpack_fp8(ref_codes, jnp.asarray(a))
    port_vals = t_fp8.unpack_fp8(_t(np.asarray(ref_codes)), torch.tensor(a))
    _assert_values_close(port_vals.numpy(), ref_vals)


@pytest.mark.parametrize("fmt_name", ["E4M3", "E5M2"])
def test_exponent_bias_matches_reference(fmt_name):
    rf, tf = getattr(r_fp8, fmt_name), getattr(t_fp8, fmt_name)
    alphas = np.array([1e-3, 0.37, 1.0, 4.0, 123.5], np.float32)
    ref = np.asarray(r_fp8.exponent_bias(jnp.asarray(alphas), rf))
    port = t_fp8.exponent_bias(_t(alphas), tf).numpy()
    assert np.all(_ulps(port, ref) <= 1)
    assert tf.mant_const == np.float64(np.log2(rf.mant_scale))


def test_wrappers_reject_devices_other_than_cpu_and_cuda():
    x = torch.empty((4, 1024), device="meta")
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        t_kern.quant_pack_tiles(x, torch.empty((4, 1), device="meta"))


@pytest.mark.parametrize("x_shape,a_shape", [((2, 4, 3), (2, 1, 1)), ((), ())])
def test_dispatch_raises_off_the_cpu_where_no_kernel_applies(x_shape, a_shape):
    """Stacked alpha or 0-dim x: the plain chain on the CPU, an error on
    any other device (never a silent plain path on the card)."""
    x, a = _x(x_shape or (1,), 12).reshape(x_shape), np.full(a_shape, 0.5, np.float32)
    assert t_dispatch.quantize_det(_t(x), _t(a)).shape == x_shape
    with pytest.raises(NotImplementedError, match="not ported"):
        t_dispatch.quantize_det(torch.empty(x_shape, device="meta"),
                                torch.empty(a_shape, device="meta"))


def test_library_is_named_by_its_sources():
    """The library name hashes the sources and flags, so an edited kernel
    gets a fresh build (import-time laziness is checked in a subprocess
    below)."""
    path = t_kern.library_path()
    assert path.parent == t_kern.BUILD_DIR and path.name.startswith("libfp8_quant_")
    assert all((t_kern.CSRC / s).exists() for s in t_kern.SOURCES + t_kern.HEADERS)


def test_port_imports_no_jax_and_nothing_of_reference():
    """Every module of the port imports with jax blocked, loads no
    ``repro.*`` module, and builds no kernel on import."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert 'jax' not in [m for m in sys.modules if sys.modules[m] is not None]\n"
        "from repro_torch.kernels import fp8_quant\n"
        "assert fp8_quant._lib is None\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
