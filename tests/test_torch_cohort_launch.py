"""The cohort launches: B8's FP4 encode of a cohort's planes in one launch
(``quant_pack_sub_many``) and B5's UQ+ clip search at every grid point in
one launch (``fake_quant_many``), on the CPU.

Their plain twins (``ref.quant_pack_sub_tiles_many``,
``ref.fake_quant_tiles_many``) are held against the JAX reference, whose
kernels run as its own tests run them on the CPU (``interpret=True``): the
cohort encode against ``jax.vmap`` of its ``quant_pack_sub_tiles``, as its
uplink vmaps the encode over the cohort, and the clip search against G calls
of its ``fake_quant_tiles``. Codes equal, except adjacent-grid ties from
``log2``/``exp2`` ULP differences between math libraries, at most 1e-5 of
codes (seen: 0 ties on every case here); values within relative 4e-6, the
same tie allowance over a case's G slices, rounded up, each tie one grid
step (seen: one tie in 25600 values in each of the stochastic column and
full cases, the same element; 0 in the others), as ``test_torch_codec`` and
``test_torch_uqplus`` hold the single plane.

On the port itself everything is bitwise: the batched twins against loops
of the single-plane twins, and the batched callers (``WireLink.up``,
``ErrorFeedbackCodec.up_transit``, ``server_optimize``) against the loops
they replaced, kept below as oracles (no JAX: ``test_torch_cuda.py`` imports
them too). Those comparisons run on one CPU thread: ATen splits a large
elementwise op over threads at boundaries that need not fall on its
16-float vectors, and this CPU's exp2 rounds a vector's tail unlike its body
(``ref._exp2_vectors``), so on several threads one element of a larger
tensor may round differently from the same element of a smaller one. On the
card every element is computed alone, and ``test_torch_cuda.py`` holds the
kernels to the same equalities there.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import codec as t_codec
from repro_torch.core import fp8, plane, wire
from repro_torch.core.ef import add_resid, flatten_q
from repro_torch.core.engine import WireLink
from repro_torch.core.fp8 import E4M3, FP4_E2M1, FP4_E3M0
from repro_torch.core.server_opt import (ServerOptConfig, _check_keys, _lerp, _plane_views,
                                         _reassemble, grid_points, server_optimize,
                                         weighted_mean)
from repro_torch.kernels import dispatch, ref
from repro_torch.models import small

TIE_FRAC = 1e-5
VALUE_RTOL = 4e-6
FMTS = {"e2m1": FP4_E2M1, "e3m0": FP4_E3M0}
P, G, ROWS = 3, 5, 5


# --- the loops the cohort launches replaced (oracles; no JAX) ---------------


def up_per_client(codec, client_params, spec, keys, ref_model=None):
    """Each client encoded and decoded alone: ``(msgs, nbytes, payloads)``."""
    msgs, nbytes, payloads = [], [], []
    for p, k in zip(client_params, keys):
        payload = codec.encode(p, spec, k, ref=ref_model)
        msgs.append(codec.decode(payload, spec, ref=ref_model))
        nbytes.append(codec.payload_nbytes_traced(payload, spec))
        payloads.append(payload)
    return msgs, nbytes, payloads


def ef_per_client(codec, client_params, spec, keys, e_sel):
    """Error feedback a client at a time: ``(msgs, new_e, payloads)``."""
    msgs, new_e, payloads = [], [], []
    for p, k, e in zip(client_params, keys, e_sel):
        comp = add_resid(p, e, spec)
        payload = codec.inner.encode(comp, spec, k)
        dec = codec.inner.decode(payload, spec)
        msgs.append(dec)
        new_e.append(flatten_q(comp, spec) - flatten_q(dec, spec))
        payloads.append(payload)
    return msgs, torch.stack(new_e), payloads


def server_optimize_per_point(stacked, nk, gd_keys, grid_keys, cfg):
    """UQ+ (Eqs. 4-5) with one ``fake_quant_tiles`` launch a grid point."""
    avg = weighted_mean(stacked, nk)
    spec = plane.make_plane_spec(avg)
    _check_keys(gd_keys, grid_keys, cfg)
    nw_b = (nk / torch.sum(nk))[:, None, None]
    w2, abar, t2, ak = _plane_views(stacked, avg, spec)
    seg_ids = spec.row_seg_ids(w2.device)
    abar_col = plane.alpha_column(abar, spec, seg_ids)
    for step in range(cfg.gd_steps):
        w = w2.detach().requires_grad_()
        with torch.enable_grad():
            err = dispatch.fake_quant_plane(w, abar_col, gd_keys[step], cfg.fmt)[None] - t2
            (g,) = torch.autograd.grad(torch.sum(nw_b * err * err), w)
        w2 = w2 - cfg.lr * g
    lo, hi = torch.min(ak, dim=0).values, torch.max(ak, dim=0).values
    ts = grid_points(cfg.n_grid, w2.device)
    losses = []
    for gi in range(cfg.n_grid):
        a = torch.clamp(_lerp(lo, ts[gi], hi), min=fp8._ALPHA_FLOOR)
        q2 = dispatch.fake_quant_tiles(w2, plane.alpha_column(a, spec, seg_ids),
                                       grid_keys[gi], cfg.fmt)
        err2 = torch.sum(nw_b * (q2[None] - t2) ** 2, dim=0)
        losses.append(torch.zeros(spec.n_seg, device=w2.device)
                      .index_add_(0, seg_ids, torch.sum(err2, dim=1)))
    t_best = ts[torch.argmin(torch.stack(losses), dim=0)]
    return _reassemble(avg, spec, w2, _lerp(lo, t_best, hi))


# --- inputs ------------------------------------------------------------------


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(torch.uint32)


def _keys(n, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 2 ** 32, (n, 2)).astype(np.uint32)


def _stack(n, seed, layout):
    """``n`` random ``(ROWS, 1024)`` planes whose last row holds an odd tail
    (517 elements, then the zero fill), and their clips: a row-max column,
    it expanded to (ROWS, 1024), or (ROWS, 1024) varying within rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, ROWS, 1024)) * 0.2).astype(np.float32)
    x[:, -1, 517:] = 0.0
    col = (np.abs(x).max(axis=2, keepdims=True)
           * rng.uniform(0.5, 1.0, (n, ROWS, 1))).astype(np.float32)
    if layout == "column":
        return x, col
    if layout == "full":
        return x, np.broadcast_to(col, x.shape).copy()
    return x, (col * rng.uniform(0.7, 1.0, x.shape)).astype(np.float32)


def _assert_codes_close(port: np.ndarray, want: np.ndarray, fmt) -> int:
    """Unfolded codes equal but for adjacent-grid ties; returns the ties."""
    port = ref.unfold_codes(torch.from_numpy(port).reshape(1, -1), fmt).numpy()
    want = ref.unfold_codes(torch.from_numpy(np.array(want)).reshape(1, -1), fmt).numpy()
    diff = port != want
    assert int(diff.sum()) <= int(TIE_FRAC * want.size)
    assert np.all(np.abs(port[diff] - want[diff]) == 1)
    return int(diff.sum())


def _trees_equal(a: dict, b: dict) -> bool:
    return all(na == nb and torch.equal(va, vb)
               for (na, va), (nb, vb) in zip(tree.flatten(a), tree.flatten(b)))


def _clients(n, seed=3, d_in=32):
    """A small MLP server model and ``n`` clients' models near it."""
    params = small.init_mlp(0, d_in=d_in, device="cpu")
    g = torch.Generator().manual_seed(seed)
    clients = [tree.tree_map(lambda v: v + 0.02 * torch.randn(v.shape, generator=g)
                             * (v.abs().max() + 1e-3), params) for _ in range(n)]
    return params, clients


# --- the twins against the JAX reference ------------------------------------


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cohort_encode_twin_matches_reference_vmap(fmt, layout, stochastic):
    import jax
    import jax.numpy as jnp

    from repro.core import fp8 as r_fp8
    from repro.kernels import fp8_quant as r_kern

    rf = {"e2m1": r_fp8.FP4_E2M1, "e3m0": r_fp8.FP4_E3M0}[fmt]
    x, a = _stack(P, 1, layout)
    keys = _keys(P, 2) if stochastic else None
    if keys is None:
        want = jax.vmap(lambda xi, ai: r_kern.quant_pack_sub_tiles(
            xi, ai, None, fmt=rf, interpret=True))(jnp.asarray(x), jnp.asarray(a))
    else:
        want = jax.vmap(lambda xi, ai, ki: r_kern.quant_pack_sub_tiles(
            xi, ai, ki, fmt=rf, interpret=True))(jnp.asarray(x), jnp.asarray(a),
                                                 jnp.asarray(keys))
    port = ref.quant_pack_sub_tiles_many(torch.from_numpy(x), torch.from_numpy(a),
                                         None if keys is None else _u32(keys), FMTS[fmt])
    assert port.dtype == torch.uint8 and tuple(port.shape) == (P, ROWS, 512)
    _assert_codes_close(port.numpy(), np.asarray(want), FMTS[fmt])
    # the zero fill packs to code 0, so the odd tail's pad nibble is 0
    assert not port[:, -1, 517 // 2 + 1:].any()
    assert not (port[:, -1, 517 // 2] >> 4).any()


@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_clip_search_twin_matches_reference(layout, stochastic):
    import jax.numpy as jnp

    from repro.kernels import fp8_quant as r_kern

    x, _ = _stack(1, 4, "column")
    _, a = _stack(G, 5, layout)
    keys = _keys(G, 6) if stochastic else None
    port = ref.fake_quant_tiles_many(torch.from_numpy(x[0]), torch.from_numpy(a),
                                     None if keys is None else _u32(keys), E4M3)
    assert port.dtype == torch.float32 and tuple(port.shape) == (G, ROWS, 1024)
    want = np.stack([np.asarray(r_kern.fake_quant_tiles(
        jnp.asarray(x[0]), jnp.asarray(a[g]), None if keys is None else jnp.asarray(keys[g]),
        interpret=True)) for g in range(G)]).astype(np.float64)
    got = port.numpy().astype(np.float64)
    tie = np.abs(got - want) > VALUE_RTOL * np.abs(want)
    # a tie lands on the neighbouring grid point: at most one E4M3 step (2^-3
    # of the larger value) away; at most 1e-5 of the G slices' values, rounded up
    step = 2.0 ** -E4M3.mant * np.maximum(np.abs(got), np.abs(want))
    assert np.all(np.abs(got - want)[tie] <= step[tie] * (1 + 1e-6))
    assert int(tie.sum()) <= math.ceil(TIE_FRAC * want.size), int(tie.sum())


# --- on the port, bitwise ----------------------------------------------------


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_batched_twins_are_loops_of_the_single_twins(one_thread, fmt, layout, stochastic):
    x, a = (torch.from_numpy(v) for v in _stack(P, 7, layout))
    keys = _u32(_keys(P, 8)) if stochastic else None
    codes = dispatch.quant_pack_sub_many(x, a, keys, fmt=FMTS[fmt])
    for p in range(P):
        k = None if keys is None else keys[p]
        assert torch.equal(codes[p], ref.quant_pack_sub_tiles(x[p], a[p], k, FMTS[fmt]))
    vals = dispatch.fake_quant_many(x[0], a, keys)
    for g in range(P):
        k = None if keys is None else keys[g]
        assert torch.equal(vals[g].view(torch.int32),
                           ref.fake_quant_tiles(x[0], a[g], k).view(torch.int32))


UPLINKS = ["fp4_e2m1", "fp4_e3m0", "fp4_e2m1_det", "delta:fp4_e2m1", "delta:fp4_e3m0_det",
           "rans:fp4_e2m1", "rans:delta:fp4_e2m1", "e4m3"]


@pytest.mark.parametrize("up", UPLINKS)
def test_cohort_uplink_is_the_per_client_uplink(one_thread, up):
    params, clients = _clients(P)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 9))
    link = WireLink("fp4_e2m1", up)
    want_msgs, want_bytes, _ = up_per_client(link.up_c, clients, spec, keys, ref_model=params)
    todo = list(clients)
    msgs, nbytes = link.up(todo, spec, keys, ref=params)
    assert todo == []                          # the uplink consumes the list
    assert [int(n) for n in nbytes] == [int(n) for n in want_bytes]
    assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs))


@pytest.mark.parametrize("up", ["ef:fp4_e2m1_det", "ef:fp4_e3m0", "ef:rans:fp4_e2m1_det",
                                "ef:e4m3_det"])
def test_cohort_error_feedback_is_the_per_client_uplink(one_thread, up):
    params, clients = _clients(P, seed=4)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 10))
    e_sel = 1e-3 * torch.randn((P, spec.total), generator=torch.Generator().manual_seed(1))
    codec = t_codec.get_codec(up)
    want_msgs, want_e, want_payloads = ef_per_client(codec, clients, spec, keys, e_sel)
    msgs, new_e, payloads = codec.up_transit(clients, spec, keys, e_sel)
    assert torch.equal(new_e, want_e)
    assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs))
    for pl, w in zip(payloads, want_payloads):
        assert torch.equal(pl["codes"], w["codes"])
        assert int(codec.payload_nbytes_traced(pl, spec)) == \
            int(codec.payload_nbytes_traced(w, spec))


def _uqp_case(model: str):
    init = {"mlp": lambda: small.init_mlp(0, device="cpu"),
            "lenet": lambda: small.init_lenet(0, device="cpu")}[model]
    params = init()
    g = torch.Generator().manual_seed(12)
    stacked = tree.tree_map(lambda v: torch.stack(
        [v + 0.02 * torch.randn(v.shape, generator=g) * (v.abs().max() + 1e-3)
         for _ in range(P)]), params)
    nk = torch.tensor([3.0, 1.0, 2.0])
    cfg = ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    return stacked, nk, _u32(_keys(5, 13)), _u32(_keys(20, 14)), cfg


@pytest.mark.parametrize("model", ["mlp", "lenet"])
def test_clip_search_in_one_launch_is_the_per_point_search(one_thread, model):
    stacked, nk, gd_keys, grid_keys, cfg = _uqp_case(model)
    got = server_optimize(stacked, nk, gd_keys, grid_keys, cfg)
    want = server_optimize_per_point(stacked, nk, gd_keys, grid_keys, cfg)
    assert _trees_equal(got, want)            # the plane's weights and every chosen clip


@pytest.mark.parametrize("cap_planes", [1, 2])
def test_a_chunked_cohort_launch_is_an_unchunked_one(one_thread, monkeypatch, cap_planes):
    """The stacking cap (``plane.STACK_TILE_BYTES``) cut to ``cap_planes``
    planes: the uplink encodes P = 3 clients and the clip search 20 points in
    chunks, bitwise the one-chunk results."""
    params, clients = _clients(P, seed=5)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 15))
    stacked, nk, gd_keys, grid_keys, cfg = _uqp_case("mlp")
    whole = {up: WireLink("fp4_e2m1", up).up(list(clients), spec, keys, ref=params)
             for up in ("fp4_e2m1", "delta:fp4_e2m1", "rans:fp4_e2m1")}
    whole_uqp = server_optimize(stacked, nk, gd_keys, grid_keys, cfg)
    rows = plane.make_plane_spec(weighted_mean(stacked, nk)).n_rows
    monkeypatch.setattr(plane, "STACK_TILE_BYTES", cap_planes * 4 * spec.n_rows * 1024)
    assert plane.stack_chunk(spec.n_rows) == cap_planes
    for up, (want_msgs, want_bytes) in whole.items():
        msgs, nbytes = WireLink("fp4_e2m1", up).up(list(clients), spec, keys, ref=params)
        assert [int(n) for n in nbytes] == [int(n) for n in want_bytes]
        assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs)), up
    monkeypatch.setattr(plane, "STACK_TILE_BYTES", cap_planes * 4 * rows * 1024)
    assert plane.stack_chunk(rows) == cap_planes
    assert _trees_equal(server_optimize(stacked, nk, gd_keys, grid_keys, cfg), whole_uqp)


def test_stack_chunk_keeps_a_plane_a_launch_at_least():
    assert plane.stack_chunk(135) == plane.STACK_TILE_BYTES // (4 * 135 * 1024)
    assert plane.stack_chunk(1074176) == 1     # full-width TinyLlama's plane: 4.4 GB


def test_batched_wrappers_check_their_shapes():
    x = torch.zeros((2, 4, 1024))
    with pytest.raises(ValueError, match="one byte each"):
        dispatch.quant_pack_sub_many(x, torch.ones((2, 4, 1)), None, fmt=E4M3)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        dispatch.fake_quant_many(x[0], torch.ones((2, 4, 1)), torch.zeros((2, 2)).to(
            "meta"))
