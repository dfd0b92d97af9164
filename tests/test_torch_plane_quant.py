"""The trainer's quantizers on the port against the live JAX reference: the
bf16 activation path through B1/B2, the B7 plane pair and B9's
``fake_quant_amax_tiles`` (twins against the reference's interpret-mode
Pallas kernels), ``core.plane.quantize_det`` and ``launch.steps``'
quantize-once against the reference's plane and the per-leaf loop, and the
train step with weight-only QAT in f32, where no FP8 activation tie can
occur.

The reference runs its kernel path (``REPRO_KERNEL_BACKEND=interpret``):
there ``quant_det_plane`` is the B7 Pallas pair and ``aq`` the B1/B2 Pallas
pair, which the port mirrors; its default jnp backend takes other code
paths (``common.py:92-111``, ``dispatch.py:432-435``).

Tolerances, and the mechanism behind each:

* quantized values: within relative 4e-6 where the grid point agrees, and
  at most 1e-5 of elements on the other grid neighbour (XLA's and torch's
  ``log2``/``exp2`` differ by an ULP, as ``test_torch_fp8`` states). On bf16
  activations both compute in f32 and round once: equal, except at a clip
  that is not a power of two, where a value within a few ULP of an FP8
  midpoint may take the other neighbour (11 of 16384 at alpha 2.5): ROADMAP
  §3's named midpoint mechanism, checked element by element, with a whole
  ``(q - y)`` step added to g_alpha's bar at each such element.
* clip masks (``gx``): equal.
* clip cotangents: within 1e-5 of the magnitude sum of their terms (f32
  sums taken in another order: per row, then per segment, against the
  reference's per-tile running sum and scatter-add), plus 2e-6 of
  ``sum |g| |clip(x)| / a``: at a clip that is not a power of two XLA:CPU's
  grid scale ``s`` is up to ~16 f32 ULP off torch's (measured 1.0e-6 to
  1.5e-6 relative on every element of a TinyLlama layer), which moves every
  ``(q - y) * s / a`` term the same way.
* the f32 weight-QAT train step: loss to 1e-6; every weight, norm and
  embedding gradient to 1e-5 of its magnitude sum (2e-6 measured); every
  clip gradient to 1e-3 of its value, the reference's own bar for these
  cancelling sums (``tests/test_plane.py:229``; 6.5e-5 measured, 2.7e-4 at
  opt_level 2, where each microbatch's gradient is rounded to bf16 and a
  last-bit difference can move that rounding). At opt_level 2 the weight
  gradients take 5e-5 for the same reason (6.1e-6 measured).
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as r_common
import repro.models.transformer as r_tr
from repro import configs as r_configs
from repro.core import plane as r_plane
from repro.core import qat as r_qat
from repro.core.fp8 import E4M3 as R_E4M3
from repro.core.fp8 import E5M2 as R_E5M2
from repro.core.qat import QATConfig as RQAT
from repro.data.pipeline import LMBatcher as RBatcher
from repro.data.pipeline import silo_stream as r_stream
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_quant as r_kern
from repro.launch import steps as r_steps
from repro.models.registry import get_model as r_get_model
from repro.optim.base import Optimizer as ROptimizer
from repro_torch import configs as t_configs
from repro_torch import convert, tree
from repro_torch.core import plane as t_plane
from repro_torch.core import qat as t_qat
from repro_torch.core.fp8 import E4M3, E5M2
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import fp8_quant as t_kern
from repro_torch.kernels import ref as t_ref
from repro_torch.launch import steps as t_steps
from repro_torch.models import common as t_common
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_tr
from repro_torch.optim.base import Optimizer as TOptimizer

ARCH = "tinyllama_1_1b"
VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
SUM_RTOL = 1e-5
S_RTOL = 2e-6        # 16 f32 ULP of the grid scale
FMTS = {"e4m3": (R_E4M3, E4M3), "e5m2": (R_E5M2, E5M2)}


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _assert_values_close(port, ref):
    p, r = _f64(port), _f64(ref)
    bad = int(np.sum(np.abs(p - r) > VALUE_RTOL * np.abs(r)))
    assert bad <= int(TIE_FRAC * r.size), f"{bad} of {r.size} beyond rtol {VALUE_RTOL}"


def _terms(x, a, g, fmt):
    """|g * clip-cotangent term| elementwise (f64), ``a`` broadcasting."""
    x, a, g = (torch.as_tensor(np.asarray(v, np.float64)) for v in (x, a, g))
    b = 2.0 ** fmt.exp - torch.log2(a) + fmt.mant_const - 1.0
    inside = (x.abs() <= a).double()
    xc = torch.minimum(torch.maximum(x, -a), a)
    p = torch.clamp(torch.floor(torch.log2(xc.abs()) + b), min=1.0)
    s = torch.exp2(p - b - fmt.mant)
    y = xc / s
    return (g * (torch.sign(x) * (1 - inside) + (torch.round(y) - y) * s / a)).abs().numpy()


def _clip_bar(x, a, g, fmt=E4M3):
    """The bar of a clip cotangent (``a`` broadcasting against ``x``, summed
    over the last axis): the sum's order (1e-5 of its terms' magnitude sum)
    plus the grid scale ``s``, which XLA:CPU computes up to ~16 f32 ULP away
    from torch at a clip that is not a power of two (``log2``/``exp2``;
    ROADMAP's North star), so every ``(q - y) * s / a`` term moves by up to
    ``2e-6 * |clip(x)| / a``, all the same way."""
    xa, aa, ga = (np.asarray(v, np.float64) for v in (x, a, g))
    drift = np.abs(ga) * np.minimum(np.abs(xa), aa) / aa
    return SUM_RTOL * _terms(x, a, g, fmt).sum(axis=-1) + S_RTOL * drift.sum(axis=-1)


def _assert_equal_but_midpoint_ties(port, ref, x, alpha, fmt=E4M3):
    """Equal, except where ``y = clip(x) / s`` is within a few ULP of a
    midpoint of the FP8 grid (ROADMAP §3, named mechanisms 3 and 6): at a
    clip whose log2 is not an integer XLA:CPU's ``s`` is ~16 f32 ULP off
    torch's, and such an element rounds to the other neighbour, one grid
    step away."""
    xt = torch.from_numpy(np.asarray(x, np.float32))
    a = torch.tensor(alpha, dtype=torch.float32)
    b = t_ref._bias(a, fmt)
    xc = t_ref._clip(xt, a)
    _, s_ = t_ref._scale_p(xc, b, fmt)
    y = (xc / s_).double().numpy()
    tie = np.abs(np.abs(y - np.trunc(y)) - 0.5) <= S_RTOL * np.abs(y)
    p, r = _f64(port), _f64(ref)
    diff = p != r
    assert not np.any(diff & ~tie), f"{int((diff & ~tie).sum())} differ off a midpoint"
    # one grid step, plus the rounding of both grid values to bf16
    step = s_.double().numpy() + 2.0 ** -8 * np.maximum(np.abs(p), np.abs(r))
    assert np.all(np.abs(p - r)[diff] <= step[diff])
    assert diff.sum() <= 0.01 * diff.size
    return tie, s_.double().numpy()


# ---------------------------------------------------------------------------
# bf16 activations through B1/B2 (the repaired fault)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,scale,alpha", [((64, 256), 2.0, 4.0), ((2, 16, 64), 3.0, 4.0),
                                               ((4, 32, 128), 1.0, 2.5)])
@pytest.mark.parametrize("lsq", [False, True])
def test_bf16_activation_through_the_kernel_pair_is_the_reference(shape, scale, alpha, lsq):
    """A bf16 activation through ``dispatch.quantize_det`` (and through
    ``qat.aq``, its LSQ-scaled clip): both packages compute in f32 and round
    once to bf16, so the values and ``gx`` are the reference's; ``g_alpha``
    is f32 within its bar. The plain chain in bf16 differed in every value."""
    rng = np.random.default_rng(sum(shape))
    jx = jnp.asarray((rng.normal(size=shape) * scale).astype(np.float32)).astype(jnp.bfloat16)
    xb = _f64(jx).astype(np.float32)
    g = (np.abs(rng.normal(size=shape)) * np.sign(xb)).astype(np.float32)
    jg = jnp.asarray(g).astype(jnp.bfloat16)
    if lsq:
        rfn = lambda x, a: r_qat.aq(x, a, RQAT())
        tfn = lambda x, a: t_qat.aq(x, a, TQAT())
    else:
        rfn, tfn = r_dispatch.quantize_det, t_dispatch.quantize_det
    rout, vjp = jax.vjp(rfn, jx, jnp.float32(alpha))
    rgx, rga = vjp(jg)
    tx = _t(xb).to(torch.bfloat16).requires_grad_()
    ta = torch.tensor(alpha, dtype=torch.float32).requires_grad_()
    tout = tfn(tx, ta)
    tout.backward(_t(_f64(jg).astype(np.float32)).to(torch.bfloat16))
    assert tout.dtype == tx.grad.dtype == torch.bfloat16 and ta.grad.dtype == torch.float32
    tie, step = _assert_equal_but_midpoint_ties(tout, rout, xb, alpha)
    np.testing.assert_array_equal(_f64(tx.grad), _f64(rgx))
    # g_alpha: the sum's order, plus a whole (q - y) step at each midpoint tie
    scale_g = 1.0 / np.sqrt(np.prod(shape) * 15) if lsq else 1.0
    g64 = _f64(jg)
    bound = scale_g * (SUM_RTOL * _terms(xb, alpha, g64, E4M3).sum()
                       + np.sum(np.abs(g64[tie]) * step[tie]) / alpha)
    assert abs(float(ta.grad) - float(rga)) <= bound
    assert float(ta.grad) != 0.0


# ---------------------------------------------------------------------------
# B7 and B9 twins against the reference's interpret-mode kernels
# ---------------------------------------------------------------------------


def _plane_case(seed, seg_rows):
    """A ragged plane of segments (a stacked leaf's layers, then single
    leaves), every segment with its own clip, rows zero-padded at a
    segment's tail; one element of each segment on its clip."""
    rng = np.random.default_rng(seed)
    rows = sum(seg_rows)
    x = (rng.normal(size=(rows, 1024)) * 0.2).astype(np.float32)
    col = np.zeros((rows, 1), np.float32)
    r0 = 0
    for i, n in enumerate(seg_rows):
        a = np.float32(np.abs(x[r0:r0 + n]).max() * (0.6 + 0.05 * i))
        col[r0:r0 + n] = a
        x[r0, 3] = a
        x[r0 + n - 1, 700:] = 0.0
        r0 += n
    g = (np.abs(rng.normal(size=x.shape)) * np.sign(x)).astype(np.float32)
    return x, col, g


@pytest.mark.parametrize("seg_rows", [(3, 3, 3, 1, 7), (1,), (2, 2, 2, 2, 5, 11)])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2"])
def test_b7_twins_match_the_reference_kernels(seg_rows, fmt):
    rfmt, tfmt = FMTS[fmt]
    x, col, g = _plane_case(len(seg_rows), seg_rows)
    rq = r_kern.quant_det_tiles(jnp.asarray(x), jnp.asarray(col), fmt=rfmt, interpret=True)
    rgx, rga = r_kern.quant_det_tiles_bwd(jnp.asarray(x), jnp.asarray(col), jnp.asarray(g),
                                          fmt=rfmt, interpret=True)
    tq = t_ref.quant_det_tiles(_t(x), _t(col), tfmt)
    tgx, tga = t_ref.quant_det_tiles_bwd(_t(x), _t(col), _t(g), tfmt)
    assert tq.dtype == tgx.dtype == tga.dtype == torch.float32 and tga.shape == (x.shape[0], 1)
    _assert_values_close(tq, rq)
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    assert np.all(np.abs(_f64(tga)[:, 0] - _f64(rga)[:, 0]) <= _clip_bar(x, col, g, tfmt))
    # the wrappers take the twins for CPU tensors; a B7 element is a B1 element
    assert torch.equal(t_kern.quant_det_tiles(_t(x), _t(col), tfmt), tq)
    assert torch.equal(tq[:1], t_ref.quant_det(_t(x[:1]), _t(col[0, 0]), tfmt))


@pytest.mark.parametrize("mode", ["det", "rand"])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("rows", [1, 37])
def test_b9_fake_quant_amax_twin_matches_the_reference_kernel(mode, alpha_layout, rows):
    x, col, g = _plane_case(rows, (rows,))
    a2 = col if alpha_layout == "column" else np.broadcast_to(col, x.shape).copy()
    key = np.array([2654435769, 97], np.uint32) if mode == "rand" else None
    jkey = None if key is None else jnp.asarray(key)
    tkey = None if key is None else _t(key.astype(np.int64)).to(torch.uint32)
    rq, rmx = r_kern.fake_quant_amax_tiles(jnp.asarray(x), jnp.asarray(a2), jkey,
                                           interpret=True)
    tq, tmx = t_ref.fake_quant_amax_tiles(_t(x), _t(a2), tkey)
    _assert_values_close(tq, rq)
    np.testing.assert_array_equal(tmx.numpy(), np.asarray(rmx))
    # q is B5's, bit for bit; the dispatch entry's backward is B5's STE, the
    # row max's cotangent ignored
    assert torch.equal(tq, t_ref.fake_quant_tiles(_t(x), _t(a2), tkey))
    xt = _t(x).requires_grad_()
    q, mx = t_dispatch.fake_quant_amax_plane(xt, _t(col), tkey)
    assert torch.equal(mx, tmx) and not mx.requires_grad
    (q * _t(g)).sum().backward()
    rvjp = jax.vjp(lambda xx: r_dispatch.fake_quant_amax_plane(xx, jnp.asarray(col), jkey,
                                                               R_E4M3), jnp.asarray(x))[1]
    rgx = rvjp((jnp.asarray(g), jnp.ones_like(rmx)))[0]
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(rgx))


# ---------------------------------------------------------------------------
# the plane quantize and quantize-once
# ---------------------------------------------------------------------------


def _reduced_pair(nudge=1.05):
    """Reduced TinyLlama from the reference's init, every clip value nudged
    off the ``|w| == alpha`` boundary (the reference's jnp autodiff splits
    the subgradient there, the kernels do not; ``tests/test_plane.py:216``
    nudges the same way)."""
    rcfg = r_configs.reduced(r_configs.get(ARCH))
    rp = r_get_model(rcfg).init(jax.random.PRNGKey(0))
    flat, td = jax.tree_util.tree_flatten_with_path(rp)
    rp = jax.tree_util.tree_unflatten(td, [
        leaf * nudge if r_qat.is_clip_key(r_qat._key_name(p[-1])) else leaf
        for p, leaf in flat])
    return rp, convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")


def _cotangent(q_np: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {n: (np.abs(rng.normal(size=v.shape)) * np.sign(v)).astype(np.float32)
            for n, v in q_np.items()}


@pytest.mark.parametrize("out_dtype", ["bf16", "f32"])
def test_plane_quantize_det_matches_the_reference_plane(out_dtype):
    """Values and STE gradients of ``plane.quantize_det`` (B7 twins) against
    the reference's (B7 interpret kernels): the quantized leaves in the out
    dtype, the weights' clip masks equal, each clip's gradient within its
    bar. No LSQ gradient scale on either side."""
    rp, tp = _reduced_pair()
    r_dt, t_dt = (jnp.bfloat16, torch.bfloat16) if out_dtype == "bf16" else (None, None)
    rq, vjp = jax.vjp(lambda p: r_plane.quantize_det(p, out_dtype=r_dt), rp)
    qnames = sorted(t_qat.quantized_leaf_names(tp))
    rflat = dict(tree.flatten(jax.tree.map(np.asarray, rq)))
    ct = _cotangent({n: _f64(rflat[n]) for n in qnames}, 3)
    full = {n: (ct[n] if n in ct else np.zeros(np.shape(v), np.float32))
            for n, v in rflat.items()}
    rct = jax.tree.map(lambda v, c: jnp.asarray(c).astype(v.dtype), rq,
                       tree.unflatten(list(full), list(full.values())))
    rg = dict(tree.flatten(jax.tree.map(np.asarray, vjp(rct)[0])))

    names = [n for n, _ in tree.flatten(tp)]
    leaves = [t.clone().requires_grad_() for t in tree.leaves(tp)]
    spec = t_plane.make_plane_spec(tp)
    tq = dict(tree.flatten(t_plane.quantize_det(tree.unflatten(names, leaves), spec=spec,
                                                out_dtype=t_dt)))
    outs = [tq[n] for n in qnames]
    torch.autograd.backward(outs, [_t(ct[n]).to(o.dtype) for n, o in zip(qnames, outs)])
    tg = {n: t.grad for n, t in zip(names, leaves)}
    for n in qnames:
        assert tq[n].dtype == (t_dt or torch.float32)
        _assert_values_close(tq[n], rflat[n])
        np.testing.assert_array_equal(_f64(tg[n]), _f64(rg[n]), err_msg=n)
        a = dict(tree.flatten(tp))[n + "_qa"]
        layers = a.numel()
        w = _f64(dict(tree.flatten(tp))[n]).reshape(layers, -1)
        g = _f64(_t(ct[n]).to(tq[n].dtype)).reshape(layers, -1)
        bar = _clip_bar(w, a.double().numpy().reshape(layers, 1), g)
        assert np.all(np.abs(_f64(tg[n + "_qa"]).reshape(-1) - _f64(rg[n + "_qa"]).reshape(-1))
                      <= bar), n
    for n in names:           # every other leaf passes through untouched
        if n not in qnames and not n.endswith("_qa"):
            assert tq[n] is dict(zip(names, leaves))[n]


def test_quantize_params_once_matches_the_per_leaf_loop():
    """The plane against ``quantize_params_once_per_leaf`` (the port's, and
    the reference's values): the same bf16 leaves; the weights' gradients
    within an f32 rounding (the plain chain's autograd multiplies by ``s``
    and divides by it again) and the clips' within 1e-4 (sums in another
    order); ``quantize_weights`` switched off for the model."""
    rp, tp = _reduced_pair()
    names = [n for n, _ in tree.flatten(tp)]
    runs = {}
    for kind, fn in (("plane", t_steps.quantize_params_once),
                     ("leaf", t_steps.quantize_params_once_per_leaf)):
        leaves = [t.clone().requires_grad_() for t in tree.leaves(tp)]
        q, qcfg = fn(tree.unflatten(names, leaves), TQAT())
        assert not qcfg.quantize_weights and qcfg.quantize_acts
        qf = dict(tree.flatten(q))
        qnames = sorted(t_qat.quantized_leaf_names(tp))
        ct = _cotangent({n: _f64(qf[n]) for n in qnames}, 5)
        torch.autograd.backward([qf[n] for n in qnames],
                                [_t(ct[n]).to(torch.bfloat16) for n in qnames])
        runs[kind] = (qf, {n: t.grad for n, t in zip(names, leaves)})
    rq = dict(tree.flatten(jax.tree.map(
        np.asarray, r_steps.quantize_params_once_per_leaf(rp, RQAT())[0])))
    (pq, pg), (lq, lg) = runs["plane"], runs["leaf"]
    for n in qnames:
        assert pq[n].dtype == lq[n].dtype == torch.bfloat16
        np.testing.assert_array_equal(_f64(pq[n]), _f64(lq[n]), err_msg=n)
        np.testing.assert_array_equal(_f64(pq[n]), _f64(rq[n]), err_msg=n)
        # the plain chain's autograd divides by s after multiplying by it
        np.testing.assert_allclose(_f64(pg[n]), _f64(lg[n]), rtol=1e-6, err_msg=n)
        np.testing.assert_allclose(_f64(pg[n + "_qa"]), _f64(lg[n + "_qa"]), rtol=1e-4,
                                   err_msg=n)


def test_segment_sum_is_the_gather_transpose_in_a_fixed_order():
    rp, tp = _reduced_pair()
    spec = t_plane.make_plane_spec(tp)
    col = _t(np.random.default_rng(1).normal(size=(spec.n_rows, 1)).astype(np.float32))
    got = t_plane.segment_sum(col, spec)
    want = torch.zeros(spec.n_seg, dtype=torch.float64).index_add_(
        0, spec.row_seg_ids("cpu"), col[:, 0].double())
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, t_plane.segment_sum(col.clone(), spec))
    assert spec.row_seg_ids("cpu") is spec.row_seg_ids("cpu")   # built once


# ---------------------------------------------------------------------------
# the train step with weight-only QAT in f32: no activation tie can occur
# ---------------------------------------------------------------------------


def _grads_as_state():
    """Optimizers whose update is zero and whose new state is the step's
    gradient tree, so a step hands back exactly what the optimizer saw."""
    r = ROptimizer(init=lambda p: jax.tree.map(jnp.zeros_like, p),
                   update=lambda g, s, p, t: (jax.tree.map(jnp.zeros_like, p), g))
    t = TOptimizer(init=lambda p: (),
                   update=lambda g, s, p, step: (tree.tree_map(torch.zeros_like, p), g))
    return r, t


@pytest.mark.parametrize("opt_level,accum", [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1), (2, 2)])
def test_f32_weight_qat_step_is_the_reference_step(monkeypatch, opt_level, accum):
    for mod in (r_common, r_tr):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (t_common, t_tr, t_steps):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    rp, tp = _reduced_pair()
    rcfg = r_configs.reduced(r_configs.get(ARCH))
    tcfg = t_configs.reduced(t_configs.get(ARCH))
    batch = RBatcher(r_stream(rcfg.vocab, 4 * 65 * 64, 0, 0), 4, 64)(0)
    ropt, topt = _grads_as_state()
    rq, tq = RQAT(quantize_acts=False), TQAT(quantize_acts=False)
    _, rg, rm = jax.jit(r_steps.make_train_step(r_get_model(rcfg), ropt, rq, accum=accum,
                                                opt_level=opt_level))(
        rp, ropt.init(rp), {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(0, jnp.int32))
    _, tg, tm = t_steps.make_train_step(t_registry.get_model(tcfg), topt, tq, accum=accum,
                                        opt_level=opt_level)(
        tp, (), {k: _t(v) for k, v in batch.items()}, 0)
    assert abs(float(tm["loss"]) - float(rm["loss"])) <= 1e-6 * abs(float(rm["loss"]))
    w_bar = 5e-5 if opt_level == 2 and accum > 1 else 1e-5
    for n, r in tree.flatten(jax.tree.map(np.asarray, rg)):
        t, r = _f64(dict(tree.flatten(tg))[n]), r.astype(np.float64)
        if n.endswith("_qb") or (n.endswith("_qa") and opt_level == 0 and n == "embed_qa"):
            assert not np.any(r) and not np.any(t), n    # QAT acts off; embed not quantized
        elif n.endswith("_qa"):
            assert np.all(np.abs(t - r) <= 1e-3 * np.abs(r)) and np.any(r), n
        else:
            assert np.abs(t - r).sum() <= w_bar * np.abs(r).sum(), n
