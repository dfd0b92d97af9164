"""The UQ+ slice of the port against the JAX reference: the
``fake_quant_tiles`` twin (B5), the tiled parameter plane and the server
optimizer (paper Eqs. 4-5).

Inputs are made from a numpy seed and handed to both packages. The
reference kernel runs as its own tests run it on the CPU (``interpret=True``);
``server_optimize`` runs jitted with the reference's default jnp backend,
whose ``fake_quant_tiles_jnp`` is op for op the kernel body.

Tolerances, and why:
* fake-quant values: within relative 4e-6 (2 ULP of the exponent bias
  through exp2, as ``test_torch_fp8``), except adjacent-grid ties at most
  1e-5 of elements; the stochastic decisions are the same bits, so a tie is
  the only way a value can move;
* the plane: layouts equal, round trips exact;
* ``server_optimize``: ``w2_new`` within 1e-5 of its segment's clip value
  (the largest gap seen on the LeNet and KWT stacks is 5.6e-7 of alpha:
  the STE-SGD steps sum in another order), except elements whose quantized
  value tied to the other grid neighbour during a GD step, which moves them
  by about a grid step (alpha / 15 at the top bin; at most 1e-4 of
  elements); the clip values equal, except a segment whose reference grid
  losses tie (best two within relative 1e-6), where either is accepted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plane as r_plane
from repro.core import server_opt as r_so
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_quant as r_kern
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import plane as t_plane
from repro_torch.core import server_opt as t_so
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ref as t_ref

VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
W2_ALPHA_TOL = 1e-5
W2_TIE_FRAC = 1e-4


def _x(shape, seed=0, scale=0.1):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _u32(a):
    return torch.from_numpy(np.asarray(a, np.int64)).to(torch.uint32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float32))
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / scale


def _n_beyond_rtol(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return int(np.sum(np.abs(port - ref) > VALUE_RTOL * np.abs(ref)))


# ---------------------------------------------------------------------------
# B5: fake_quant_tiles twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["det", "rand"])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
def test_fake_quant_tiles_twin_matches_reference(mode, alpha_layout):
    rows = 9
    x = _x((rows, 1024), 3, 0.2)
    amax = (np.abs(x).max(axis=1, keepdims=True) * 0.8).astype(np.float32)
    x[:, 0], x[:, 1] = amax[:, 0], -amax[:, 0]          # on the clip boundary
    a2 = amax if alpha_layout == "column" else np.broadcast_to(amax, x.shape).copy()
    key = np.array([123456789, 3987654321], np.uint32) if mode == "rand" else None
    ref = np.asarray(r_kern.fake_quant_tiles(
        jnp.asarray(x), jnp.asarray(a2), None if key is None else jnp.asarray(key),
        interpret=True))
    port = t_ref.fake_quant_tiles(_t(x), _t(a2), None if key is None else _u32(key))
    assert port.dtype == torch.float32
    assert _n_beyond_rtol(port.numpy(), ref) <= int(TIE_FRAC * ref.size)
    # the dispatch entry takes the twin for a CPU tensor
    assert torch.equal(t_dispatch.fake_quant_tiles(
        _t(x), _t(a2), None if key is None else _u32(key)), port)


@pytest.mark.parametrize("mode", ["det", "rand"])
def test_fake_quant_tiles_equals_wire_transit_within_one_ulp(mode):
    """``unpack_tiles(quant_pack_tiles(...))`` lands on the same grid point."""
    x = _x((12, 1024), 4, 0.3)
    a2 = _t((np.abs(x).max(axis=1, keepdims=True) * 0.7).astype(np.float32))
    key = _u32([77, 0xFFFF0000]) if mode == "rand" else None
    q = t_ref.fake_quant_tiles(_t(x), a2, key)
    wire = t_ref.unpack_tiles(t_ref.quant_pack_tiles(_t(x), a2, key), a2)
    assert np.all(_ulps(q.numpy(), wire.numpy()) <= 1.0)


def test_tile_counter_bits_row_offset_matches_reference():
    key = np.array([0xDEADBEEF, 0x01234567], np.uint32)
    ref = r_kern._tile_counter_bits(jnp.uint32(5), (3, 1024), jnp.uint32(key[0]),
                                    jnp.uint32(key[1]))
    port = t_ref.tile_counter_bits((3, 1024), _u32(key), row0=5)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref).astype(np.int64))


def test_fake_quant_plane_backward_is_the_reference_ste():
    """The autograd Function's backward against the reference's custom VJP
    (clip mask to the tiles, per-row clip routing + scale term)."""
    x = _x((6, 1024), 5, 0.3)
    a = (np.abs(x).max(axis=1, keepdims=True) * 0.6).astype(np.float32)
    g = _x((6, 1024), 6, 1.0)
    key = np.array([9, 10], np.uint32)
    _, vjp = jax.vjp(lambda xx, aa: r_dispatch.fake_quant_plane(xx, aa, jnp.asarray(key),
                                                                r_kern.E4M3),
                     jnp.asarray(x), jnp.asarray(a))
    rgx, rga = vjp(jnp.asarray(g))
    tx, ta = _t(x).requires_grad_(), _t(a).requires_grad_()
    tgx, tga = torch.autograd.grad(t_dispatch.fake_quant_plane(tx, ta, _u32(key)),
                                   (tx, ta), _t(g))
    np.testing.assert_array_equal(tgx.numpy(), np.asarray(rgx))
    # each row's clip cotangent sums 1024 terms: within 5e-5 of their
    # magnitude sum (the largest gap seen is 1.9e-6 of the result)
    q = t_ref.fake_quant_tiles(_t(x), _t(a), _u32(key)).numpy().astype(np.float64)
    inside = np.abs(x) <= a
    xc = np.clip(x, -a, a)
    terms = g * (np.sign(x) * ~inside + (q - xc) / a)
    scale = np.abs(terms).sum(axis=1, keepdims=True)
    assert np.all(np.abs(tga.numpy() - np.asarray(rga)) <= 5e-5 * scale)


def test_fake_quant_plane_backward_with_a_fixed_alpha_gives_the_same_gx():
    """Eq. 4 holds the alpha column fixed: the backward then skips the clip
    cotangent and the tiles' gradient is unchanged (exactly)."""
    x = _x((6, 1024), 5, 0.3)
    a = _t((np.abs(x).max(axis=1, keepdims=True) * 0.6).astype(np.float32))
    g, key = _t(_x((6, 1024), 6, 1.0)), _u32(np.array([9, 10], np.uint32))
    tx = _t(x).requires_grad_()
    (fixed,) = torch.autograd.grad(t_dispatch.fake_quant_plane(tx, a, key), (tx,), g)
    ta = a.clone().requires_grad_()
    both = torch.autograd.grad(t_dispatch.fake_quant_plane(tx, ta, key), (tx, ta), g)
    assert torch.equal(fixed, both[0])
    assert ta.grad is None and both[1].shape == (6, 1)


# ---------------------------------------------------------------------------
# the plane
# ---------------------------------------------------------------------------


def _stacked_alpha_tree(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 40, 50)).astype(np.float32)
    return {"s": {"w": w, "w_qa": np.abs(w).max(axis=(1, 2), keepdims=True),
                  "b": np.zeros(50, np.float32)},
            "t": {"w": rng.standard_normal((1500, 3)).astype(np.float32),
                  "w_qa": np.float32(2.5)}}


@pytest.mark.parametrize("name", ["lenet", "kwt", "stacked"])
def test_plane_layout_and_round_trip_match_reference(name):
    if name == "stacked":
        rp = jax.tree.map(jnp.asarray, _stacked_alpha_tree())
    else:
        rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(3))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    rs, ts = r_plane.make_plane_spec(rp), t_plane.make_plane_spec(tp)
    for field in ("q_slots", "q_names", "q_shapes", "alpha_slots", "alpha_shapes",
                  "leaf_segs", "leaf_seg0", "seg_sizes", "seg_rows", "seg_row0"):
        assert getattr(ts, field) == tuple(getattr(rs, field)), field
    assert (ts.n_rows, ts.n_seg) == (rs.n_rows, rs.n_seg)
    assert ts.row_seg == tuple(int(i) for i in rs.row_seg)
    rx2, ra = r_plane.pack_tiles(rp, rs)
    tx2, ta = t_plane.pack_tiles(tp, ts)
    np.testing.assert_array_equal(tx2.numpy(), np.asarray(rx2))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(t_plane.alpha_column(ta, ts).numpy(),
                                  np.asarray(r_plane.alpha_column(ra, rs)))
    flat = dict(tree.flatten(tp))
    for qi, name_q in enumerate(ts.q_names):
        assert torch.equal(t_plane.leaf_from_tiles(tx2, ts, qi), flat[name_q])


# ---------------------------------------------------------------------------
# server_optimize (Eqs. 4-5)
# ---------------------------------------------------------------------------


def _client_stack(model, n_clients=3, seed=0):
    p = r_small.REGISTRY[model][0](jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)
    np_p = jax.tree.map(np.asarray, p)
    msgs = []
    for _ in range(n_clients):
        m = jax.tree.map(lambda v: (v + 0.02 * rng.standard_normal(v.shape)
                                    * (np.abs(v).max() + 1e-3)).astype(np.float32), np_p)
        msgs.append(m)
    return jax.tree.map(lambda *xs: np.stack(xs), *msgs)


def _ref_grid_losses(stacked, nk, key, w2_new, cfg):
    """The reference's Eq. (5) losses ``(n_grid, S)`` at its own ``w2_new``,
    from the reference's primitives: only used to NAME grid ties."""
    avg = r_so.weighted_mean(stacked, nk)
    spec = r_plane.make_plane_spec(avg)
    _, _, t2, ak = r_so._plane_views(stacked, avg, spec)
    nw_b = (nk / jnp.sum(nk))[:, None, None]
    _, k_grid = jax.random.split(key)
    keys = r_so._key_words(k_grid, cfg.n_grid)
    lo, hi = jnp.min(ak, 0), jnp.max(ak, 0)
    out = []
    for gi, t in enumerate(np.asarray(jnp.linspace(0.0, 1.0, cfg.n_grid))):
        a = jnp.maximum(lo + t * (hi - lo), 1e-12)
        q2 = r_kern.fake_quant_tiles_jnp(w2_new, r_plane.alpha_column(a, spec), keys[gi])
        err2 = jnp.sum(nw_b * (q2[None] - t2) ** 2, axis=0)
        out.append(jax.ops.segment_sum(jnp.sum(err2, 1), jnp.asarray(spec.row_seg),
                                       num_segments=spec.n_seg))
    return np.asarray(jnp.stack(out))


def _server_keys(key, cfg):
    k_gd, k_grid = jax.random.split(key)
    return (_u32(np.asarray(r_so._key_words(k_gd, cfg.gd_steps))),
            _u32(np.asarray(r_so._key_words(k_grid, cfg.n_grid))))


def _assert_server_trees_close(port: dict, ref, stacked, nk, key, cfg):
    rs = r_plane.make_plane_spec(ref)
    rw2, ra = (np.asarray(v) for v in r_plane.pack_tiles(ref, rs))
    tw2, ta = (v.numpy() for v in t_plane.pack_tiles(port, t_plane.make_plane_spec(port)))
    gap = np.abs(tw2 - rw2) / ra[rs.row_seg][:, None]
    assert int(np.sum(gap > W2_ALPHA_TOL)) <= int(W2_TIE_FRAC * rw2.size), gap.max()
    ref_flat = dict(tree.flatten(jax.tree.map(np.asarray, ref)))
    port_flat = {n: v.numpy() for n, v in tree.flatten(port)}
    ties = None
    for name, v in port_flat.items():
        if name.endswith("_qa"):
            continue
        np.testing.assert_allclose(v, ref_flat[name], rtol=1e-5, atol=1e-7, err_msg=name)
    for s in np.flatnonzero(ta != ra):
        # a grid tie: the reference's two best losses within relative 1e-6
        if ties is None:
            ties = _ref_grid_losses(stacked, nk, key, jnp.asarray(rw2), cfg)
        best2 = np.sort(ties[:, s])[:2]
        assert best2[1] - best2[0] <= 1e-6 * abs(best2[0]), (s, best2)
    return float(gap.max())


@pytest.mark.parametrize("model", ["lenet", "kwt"])
def test_server_optimize_matches_reference(model):
    stacked = _client_stack(model)
    nk = np.asarray([3.0, 1.0, 2.0], np.float32)
    cfg_r = r_so.ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    cfg_t = t_so.ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(lambda s, n, k: r_so.server_optimize(s, n, k, cfg_r))(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(nk), key)
    gd_keys, grid_keys = _server_keys(key, cfg_r)
    port = t_so.server_optimize(convert.from_jax_params(stacked, device="cpu"), _t(nk),
                                gd_keys, grid_keys, cfg_t)
    _assert_server_trees_close(port, ref, jax.tree.map(jnp.asarray, stacked),
                               jnp.asarray(nk), key, cfg_r)


def test_server_optimize_reference_matches_both():
    """The port's per-segment loop against the reference's per-leaf loop and
    against the port's plane path (same bits, same arithmetic)."""
    stacked = _client_stack("mlp")
    nk = np.asarray([1.0, 2.0, 4.0], np.float32)
    cfg_r = r_so.ServerOptConfig(enabled=True, gd_steps=3, lr=0.1, n_grid=7)
    cfg_t = t_so.ServerOptConfig(enabled=True, gd_steps=3, lr=0.1, n_grid=7)
    key = jax.random.PRNGKey(4)
    jstacked = jax.tree.map(jnp.asarray, stacked)
    ref = jax.jit(lambda s, n, k: r_so.server_optimize_reference(s, n, k, cfg_r))(
        jstacked, jnp.asarray(nk), key)
    gd_keys, grid_keys = _server_keys(key, cfg_r)
    tstacked = convert.from_jax_params(stacked, device="cpu")
    port_ref = t_so.server_optimize_reference(tstacked, _t(nk), gd_keys, grid_keys, cfg_t)
    port = t_so.server_optimize(tstacked, _t(nk), gd_keys, grid_keys, cfg_t)
    _assert_server_trees_close(port_ref, ref, jstacked, jnp.asarray(nk), key, cfg_r)
    for (n, a), (_, b) in zip(tree.flatten(port), tree.flatten(port_ref)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-8, err_msg=n)


def test_server_optimize_disabled_or_unquantized_is_the_mean():
    stacked = convert.from_jax_params(_client_stack("mlp"), device="cpu")
    nk = torch.tensor([1.0, 1.0, 2.0])
    keys = torch.zeros((5, 2), dtype=torch.int64).to(torch.uint32)
    mean = t_so.weighted_mean(stacked, nk)
    off = t_so.server_optimize(stacked, nk, keys, keys,
                               t_so.ServerOptConfig(enabled=False, gd_steps=5, n_grid=5))
    for (n, a), (_, b) in zip(tree.flatten(off), tree.flatten(mean)):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="key words"):
        t_so.server_optimize(stacked, nk, keys, keys[:2],
                             t_so.ServerOptConfig(gd_steps=5, n_grid=5))
