"""The cohort decode and the cohort amax encode: B8's FP4 decode of a
cohort's uplink payloads in one launch (``unpack_sub_many``) and B9's amax
encode of a delayed-scaling uplink in one launch (``quant_pack_amax_many``),
on the CPU.

Their plain twins (``ref.unpack_sub_tiles_many``,
``ref.quant_pack_amax_tiles_many``) are held against the JAX reference, whose
kernels run as its own tests run them on the CPU (``interpret=True``), under
``jax.vmap`` as its uplink vmaps the decode and the scaled encode over the
cohort. The decode's codes go in fixed, so no tie can arise: values agree
within relative 4e-6 (the step ``2^(p - b - m)`` differs in its last bits
between the two math libraries' log2 and exp2; seen: about half of the
values differ, by at most 9.4e-7 relative). The amax encode's codes are
equal except adjacent-grid ties, at most 1e-5 of codes (seen: 0), and its
row max is exact.

On the port itself everything is bitwise: the batched twins against loops of
the single-plane twins, and the batched callers (``WireLink.up``,
``ErrorFeedbackCodec.up_transit``, ``RansCodec.cohort_transit``,
``WireLink.up_scaled``) against the per-client loops they replaced, kept in
this file and in ``test_torch_cohort_launch`` as oracles (no JAX). Those
comparisons run on one CPU thread (``test_torch_cohort_launch``'s notes: on
several, one element of a larger tensor may round a last bit apart from the
same element of a smaller one). Every model here has leaves of odd length,
whose last payload byte holds a pad nibble.
"""
import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core import codec as t_codec
from repro_torch.core import plane, wire
from repro_torch.core.engine import WireLink
from repro_torch.core.fp8 import E4M3, FP4_E2M1, FP4_E3M0
from repro_torch.kernels import dispatch, ref
from repro_torch.models import small

from test_torch_cohort_launch import (_assert_codes_close, _keys, _stack, _trees_equal, _u32,
                                      ef_per_client, up_per_client)
from test_torch_cohort_launch import one_thread  # noqa: F401  (a fixture)

VALUE_RTOL = 4e-6
FMTS = {"e2m1": FP4_E2M1, "e3m0": FP4_E3M0}
AMAX_FMTS = {"e4m3": E4M3, **FMTS}
P, ROWS = 3, 5


# --- the loops the cohort launches replaced (oracles; no JAX) ---------------


def up_scaled_per_client(codec, client_params, spec, keys, a_eff):
    """A delayed-scaling uplink a client at a time: ``(msgs, amax (P, n_q))``,
    each amax row the max|leaf| of the client's quantized leaves."""
    msgs, amax = [], []
    for p, k in zip(client_params, keys):
        msgs.append(codec.decode_scaled(codec.encode_scaled(p, spec, k, a_eff), spec))
        flat = dict(tree.flatten(p))
        amax.append(torch.stack([flat[n].abs().max() for n in spec.q_names]))
    return msgs, torch.stack(amax)


# --- inputs ------------------------------------------------------------------


def _codes(n, seed, layout):
    """``n`` planes of random packed codes ``(n, ROWS, 512)`` (every code of
    the format, the last row's odd tail 517 codes long, then zero codes) and
    their clips, as ``test_torch_cohort_launch._stack`` makes them."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 256, (n, ROWS, 512), dtype=np.uint8)
    codes[:, -1, 517 // 2] &= 0x0F                  # the pad nibble of the odd tail
    codes[:, -1, 517 // 2 + 1:] = 0
    _, a = _stack(n, seed + 1, layout)
    return codes, a


def _clients(n, seed=3):
    """A small MLP server model whose quantized leaves are of odd length
    (33 x 63, 63 x 63) or even (63 x 10), and ``n`` clients near it."""
    params = small.init_mlp(0, d_in=33, d_hidden=63, device="cpu")
    g = torch.Generator().manual_seed(seed)
    clients = [tree.tree_map(lambda v: v + 0.02 * torch.randn(v.shape, generator=g)
                             * (v.abs().max() + 1e-3), params) for _ in range(n)]
    return params, clients


def test_the_clients_have_odd_leaves():
    params, _ = _clients(1)
    spec = wire.make_wire_spec(params)
    assert sorted(n % 2 for n in map(plane.nelem, spec.q_shapes)) == [0, 1, 1]


# --- the twins against the JAX reference ------------------------------------


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
def test_cohort_decode_twin_matches_reference_vmap(fmt, layout):
    import jax
    import jax.numpy as jnp

    from repro.core import fp8 as r_fp8
    from repro.kernels import fp8_quant as r_kern

    rf = {"e2m1": r_fp8.FP4_E2M1, "e3m0": r_fp8.FP4_E3M0}[fmt]
    c, a = _codes(P, 21, layout)
    want = np.asarray(jax.vmap(lambda ci, ai: r_kern.unpack_sub_tiles(
        ci, ai, fmt=rf, interpret=True))(jnp.asarray(c), jnp.asarray(a))).astype(np.float64)
    port = ref.unpack_sub_tiles_many(torch.from_numpy(c), torch.from_numpy(a), FMTS[fmt])
    assert port.dtype == torch.float32 and tuple(port.shape) == (P, ROWS, 1024)
    got = port.numpy().astype(np.float64)
    assert np.all(np.abs(got - want) <= VALUE_RTOL * np.abs(want))
    assert not port[:, -1, 517:].any()             # the pad nibble and the fill decode to 0


@pytest.mark.parametrize("fmt", list(AMAX_FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cohort_amax_encode_twin_matches_reference_vmap(fmt, layout, stochastic):
    import jax
    import jax.numpy as jnp

    from repro.core import fp8 as r_fp8
    from repro.kernels import fp8_quant as r_kern

    rf = {"e4m3": r_fp8.E4M3, "e2m1": r_fp8.FP4_E2M1, "e3m0": r_fp8.FP4_E3M0}[fmt]
    kern = r_kern.quant_pack_amax_tiles if fmt == "e4m3" else r_kern.quant_pack_sub_amax_tiles
    x, a = _stack(P, 22, layout)
    keys = _keys(P, 23) if stochastic else None
    if keys is None:
        want_c, want_m = jax.vmap(lambda xi, ai: kern(xi, ai, None, fmt=rf, interpret=True))(
            jnp.asarray(x), jnp.asarray(a))
    else:
        want_c, want_m = jax.vmap(lambda xi, ai, ki: kern(xi, ai, ki, fmt=rf, interpret=True))(
            jnp.asarray(x), jnp.asarray(a), jnp.asarray(keys))
    codes, rowmax = ref.quant_pack_amax_tiles_many(
        torch.from_numpy(x), torch.from_numpy(a), None if keys is None else _u32(keys),
        AMAX_FMTS[fmt])
    width = 1024 // ref.codes_per_byte(AMAX_FMTS[fmt])
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (P, ROWS, width)
    assert rowmax.dtype == torch.float32 and tuple(rowmax.shape) == (P, ROWS, 1)
    _assert_codes_close(codes.numpy(), np.asarray(want_c), AMAX_FMTS[fmt])
    assert np.array_equal(rowmax.numpy(), np.asarray(want_m))


# --- on the port, bitwise ----------------------------------------------------


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
def test_batched_decode_twin_is_a_loop_of_the_single_twin(one_thread, fmt, layout):
    c, a = (torch.from_numpy(v) for v in _codes(P, 24, layout))
    vals = dispatch.unpack_sub_many(c, a, fmt=FMTS[fmt])
    for p in range(P):
        assert torch.equal(vals[p].view(torch.int32),
                           ref.unpack_sub_tiles(c[p], a[p], FMTS[fmt]).view(torch.int32))


@pytest.mark.parametrize("fmt", list(AMAX_FMTS))
@pytest.mark.parametrize("layout", ["column", "full", "varying", "expanded"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_batched_amax_twin_is_a_loop_of_the_single_twins(one_thread, fmt, layout, stochastic):
    """Slice p is the single twin on slice p, the alphas one stack or one
    slice expanded over P (``up_scaled``'s shared effective scales)."""
    f = AMAX_FMTS[fmt]
    x, a = (torch.from_numpy(v) for v in _stack(P, 25, "column" if layout == "expanded"
                                                   else layout))
    if layout == "expanded":
        a = a[0].expand(P, *a.shape[1:])
    keys = _u32(_keys(P, 26)) if stochastic else None
    codes, rowmax = dispatch.quant_pack_amax_many(x, a, keys, fmt=f)
    single = dispatch.quant_pack_amax_tiles if f.bits == 8 else dispatch.quant_pack_sub_amax_tiles
    for p in range(P):
        want_c, want_m = single(x[p], a[p].contiguous(), None if keys is None else keys[p], f)
        assert torch.equal(codes[p], want_c) and torch.equal(rowmax[p], want_m)


@pytest.mark.parametrize("fmt", ["fp4_e2m1", "fp4_e3m0", "e4m3"])
def test_code_tiles_are_the_tiles_of_the_payload(fmt):
    """``wire.code_tiles``' slice copies lay a cohort's payload codes into
    the tiles ``plane.tiles`` makes of each, zero padding included."""
    params, clients = _clients(2)
    spec = wire.make_wire_spec(params)
    f = t_codec.get_codec(fmt).fmt
    k = ref.codes_per_byte(f)
    codes = torch.stack([wire.encode(c, spec, _u32(_keys(1, 27))[0], f)["codes"]
                         for c in clients])
    got = wire.code_tiles(codes, spec, f)
    assert got.shape == (2, spec.n_rows, 1024 // k) and got.dtype == torch.uint8
    offs = [0]
    for n in wire.code_sizes(spec, f):
        offs.append(offs[-1] + n)
    for p in range(2):
        want = plane.tiles([codes[p, o0:o1] for o0, o1 in zip(offs, offs[1:])], 0, 1024 // k)
        assert torch.equal(got[p], want)


UPLINKS = ["fp4_e2m1", "fp4_e3m0", "fp4_e2m1_det", "fp4_e3m0_det", "delta:fp4_e2m1",
           "delta:fp4_e3m0_det", "rans:fp4_e2m1", "rans:delta:fp4_e2m1", "e4m3"]


@pytest.mark.parametrize("up", UPLINKS)
def test_cohort_decode_uplink_is_the_per_client_uplink(one_thread, up):
    params, clients = _clients(P)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 28))
    link = WireLink("fp4_e2m1", up)
    want_msgs, want_bytes, _ = up_per_client(link.up_c, clients, spec, keys, ref_model=params)
    todo = list(clients)
    msgs, nbytes = link.up(todo, spec, keys, ref=params)
    assert todo == []
    assert [int(n) for n in nbytes] == [int(n) for n in want_bytes]
    assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs))


@pytest.mark.parametrize("up", ["ef:fp4_e2m1", "ef:fp4_e3m0_det", "ef:rans:fp4_e2m1",
                                "ef:rans:fp4_e2m1_det"])
def test_cohort_decode_error_feedback_is_the_per_client_uplink(one_thread, up):
    params, clients = _clients(P, seed=4)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 29))
    e_sel = 1e-3 * torch.randn((P, spec.total), generator=torch.Generator().manual_seed(2))
    codec = t_codec.get_codec(up)
    want_msgs, want_e, want_payloads = ef_per_client(codec, clients, spec, keys, e_sel)
    msgs, new_e, payloads = codec.up_transit(clients, spec, keys, e_sel)
    assert torch.equal(new_e, want_e)
    assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs))
    for pl, w in zip(payloads, want_payloads):
        assert torch.equal(pl["codes"], w["codes"])


@pytest.mark.parametrize("inner", ["fp4_e2m1", "delta:fp4_e2m1_det"])
def test_rans_cohort_transit_decodes_its_symbols_in_one_stack(one_thread, inner):
    """``cohort_transit`` hands its decoded ``(P, n)`` symbols to the inner
    codec's ``decode_many`` as they are: the trees of a client at a time."""
    params, clients = _clients(P, seed=5)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 30))
    codec = t_codec.get_codec("rans:" + inner)
    inner_payloads = codec.inner.encode_many(clients, spec, keys, ref=params)
    msgs, payloads = codec.cohort_transit(inner_payloads, spec, ref=params)
    for m, pl in zip(msgs, payloads):
        assert _trees_equal(m, codec.decode(pl, spec, ref=params))


@pytest.mark.parametrize("up", ["e4m3", "e4m3_det", "fp4_e2m1", "fp4_e3m0_det"])
def test_cohort_amax_uplink_is_the_per_client_uplink(one_thread, up):
    """``WireLink.up_scaled`` under delayed:4: the messages and the ``(P,
    n_q)`` amax bitwise the per-client encode and decode."""
    params, clients = _clients(P, seed=6)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 31))
    link = WireLink(up, up, "delayed:4", "delayed:4")
    _, st_up = link.scales_init(params, spec)
    st_up = st_up * torch.tensor([[0.9], [1.1], [1.0], [0.8]])   # a history of moved scales
    want_msgs, want_amax = up_scaled_per_client(link.up_c, clients, spec, keys,
                                                link.up_p.effective(st_up))
    todo = list(clients)
    msgs, amax = link.up_scaled(todo, spec, keys, st_up)
    assert todo == []
    assert amax.shape == (P, len(spec.q_slots)) and torch.equal(amax, want_amax)
    assert all(_trees_equal(m, w) for m, w in zip(msgs, want_msgs))


@pytest.mark.parametrize("cap_planes", [1, 2])
def test_a_chunked_cohort_decode_is_an_unchunked_one(one_thread, monkeypatch, cap_planes):
    """The stacking cap (``plane.STACK_TILE_BYTES``) cut to ``cap_planes``
    planes: every batched uplink decodes (and the scaled one encodes) P = 3
    clients in chunks, bitwise the one-chunk results."""
    params, clients = _clients(P, seed=7)
    spec = wire.make_wire_spec(params)
    keys = _u32(_keys(P, 32))
    e_sel = 1e-3 * torch.randn((P, spec.total), generator=torch.Generator().manual_seed(3))
    ups = ("fp4_e2m1", "delta:fp4_e2m1", "rans:fp4_e2m1")
    efs = ("ef:fp4_e2m1_det", "ef:rans:fp4_e2m1_det")
    scaled = ("e4m3", "fp4_e2m1")
    links = {u: WireLink(u, u, "delayed:4", "delayed:4") for u in scaled}
    st = {u: links[u].scales_init(params, spec)[1] for u in scaled}

    def run():
        return ({u: WireLink("fp4_e2m1", u).up(list(clients), spec, keys, ref=params)
                 for u in ups},
                {u: t_codec.get_codec(u).up_transit(list(clients), spec, keys, e_sel)
                 for u in efs},
                {u: links[u].up_scaled(list(clients), spec, keys, st[u]) for u in scaled})

    whole = run()
    monkeypatch.setattr(plane, "STACK_TILE_BYTES", cap_planes * 4 * spec.n_rows * 1024)
    assert plane.stack_chunk(spec.n_rows) == cap_planes
    up, ef, sc = run()
    for u in ups:
        assert [int(n) for n in up[u][1]] == [int(n) for n in whole[0][u][1]]
        assert all(_trees_equal(m, w) for m, w in zip(up[u][0], whole[0][u][0])), u
    for u in efs:
        assert torch.equal(ef[u][1], whole[1][u][1])
        assert all(_trees_equal(m, w) for m, w in zip(ef[u][0], whole[1][u][0])), u
    for u in scaled:
        assert torch.equal(sc[u][1], whole[2][u][1])
        assert all(_trees_equal(m, w) for m, w in zip(sc[u][0], whole[2][u][0])), u


def test_decode_many_of_a_model_without_quantized_leaves_passes_the_riders():
    params = {"b": torch.ones(3)}
    spec = wire.make_wire_spec(params)
    payload = {"codes": torch.zeros(0, dtype=torch.uint8), "other": (torch.ones(3),)}
    for name in ("fp4_e2m1", "e4m3"):
        (out,) = t_codec.get_codec(name).decode_many([payload], spec)
        assert torch.equal(out["b"], torch.ones(3))


def test_batched_wrappers_check_their_formats_and_devices():
    c3 = torch.zeros((2, 4, 512), dtype=torch.uint8)
    x3 = torch.zeros((2, 4, 1024))
    with pytest.raises(ValueError, match="one byte each"):
        dispatch.unpack_sub_many(c3, torch.ones((2, 4, 1)), fmt=E4M3)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        dispatch.unpack_sub_many(c3, torch.ones((2, 4, 1)).to("meta"))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        dispatch.quant_pack_amax_many(x3, torch.ones((2, 4, 1)),
                                      torch.zeros((2, 2)).to("meta"))
    vals = dispatch.unpack_sub_many(c3, torch.ones((2, 4, 1)))
    codes, rowmax = dispatch.quant_pack_amax_many(x3, torch.ones((2, 4, 1)), fmt=FP4_E2M1)
    assert tuple(vals.shape) == (2, 4, 1024) and not vals.any()
    assert tuple(codes.shape) == (2, 4, 512) and tuple(rowmax.shape) == (2, 4, 1)
