"""The port's error feedback (``core.ef``) against the live JAX reference,
and its engine state.

Inputs are made with numpy and handed to both packages. Tolerances, and
why: ``flatten_q`` and ``add_resid`` are one f32 add or a copy, so they are
exact. ``up_transit`` on the same inputs: every payload byte equal (the det
grids' codes, and the stochastic ones under the same key words; a rANS
inner's coded planes, states and lengths), so the decoded messages agree
within 16 f32 ULP (the repo's bar for grid values whose codes agree: the
two packages' ``log2``/``exp2`` differ in the last bits of the exponent
bias; seen: 7 ULP) and the new residual rows, ``comp - dec``, within 1e-6
absolute (seen: 1.2e-7); a dynamic inner's traced bytes exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as r_codec
from repro.core import ef as r_ef
from repro.core import wire as r_wire
from repro.models import small as r_small
from repro_torch import convert, optim, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import ef as t_ef
from repro_torch.core import wire as t_wire
from repro_torch.core.engine import FedConfig, RoundEngine, WireLink
from repro_torch.core.qat import QATConfig, clip_value_mask, weight_decay_mask
from repro_torch.data import partition_iid, synthetic_classification
from repro_torch.models import small as t_small


def _pair(seed=0, d_in=64, n_classes=10):
    rp = r_small.init_mlp(jax.random.PRNGKey(seed), d_in=d_in, n_classes=n_classes)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    return rp, r_wire.make_wire_spec(rp), tp, t_wire.make_wire_spec(tp)


def test_flatten_q_and_add_resid_equal_reference():
    rp, rs, tp, ts = _pair()
    assert ts.total == rs.total and ts.q_offsets == tuple(rs.q_offsets)
    e = np.random.RandomState(0).randn(rs.total).astype(np.float32) * 0.01
    np.testing.assert_array_equal(t_ef.flatten_q(tp, ts).numpy(),
                                  np.asarray(r_ef.flatten_q(rp, rs)))
    rc = jax.tree.map(np.asarray, r_ef.add_resid(rp, jnp.asarray(e), rs))
    tc = t_ef.add_resid(tp, torch.from_numpy(e), ts)
    rflat = dict(tree.flatten(rc))
    for name, v in tree.flatten(tc):
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), rflat[name], err_msg=name)
    # the riders (biases, clip values) are untouched: EF covers the codes only
    for name, v in tree.flatten(tp):
        if name not in ts.q_names:
            assert torch.equal(dict(tree.flatten(tc))[name], v)


def _ulp(a: np.ndarray) -> np.ndarray:
    a = np.abs(a.astype(np.float32))
    return np.nextafter(a, np.float32(np.inf)) - a


@pytest.mark.parametrize("inner", ["e4m3_det", "fp4_e2m1_det", "e4m3",
                                   "rans:fp4_e2m1_det", "rans:e4m3"])
def test_up_transit_equals_reference(inner):
    """Three clients (the MLP's init weights moved by numpy noise) with
    numpy residual rows and the reference's key words: the same messages,
    new residual rows and traced bytes."""
    rp, rs, tp, ts = _pair()
    P, rng = 3, np.random.RandomState(1)
    noise = [jax.tree.map(lambda a: np.asarray(rng.randn(*a.shape), np.float32) * 0.02,
                          jax.tree.map(np.asarray, rp)) for _ in range(P)]
    r_clients = [jax.tree.map(lambda a, n: a + n, rp, nz) for nz in noise]
    r_stack = jax.tree.map(lambda *xs: jnp.stack(xs), *r_clients)
    t_clients = [convert.from_jax_params(jax.tree.map(np.asarray, c), "cpu")
                 for c in r_clients]
    e = rng.randn(P, rs.total).astype(np.float32) * 0.01
    keys = jax.random.split(jax.random.PRNGKey(9), P)
    rcod, tcod = r_codec.get_codec("ef:" + inner), t_codec.get_codec("ef:" + inner)
    assert tcod.tag == rcod.tag and tcod.dynamic == getattr(rcod, "dynamic", False)
    r_msgs, r_new_e, r_pay = rcod.up_transit(r_stack, rs, keys, jnp.asarray(e))
    k_words = torch.from_numpy(np.asarray(keys)[:, :2].astype(np.int64)).to(torch.uint32)
    t_msgs, t_new_e, t_pay = tcod.up_transit(t_clients, ts, k_words, torch.from_numpy(e))
    assert t_new_e.shape == (P, ts.total)
    np.testing.assert_allclose(t_new_e.numpy(), np.asarray(r_new_e), rtol=0, atol=1e-6)
    r_flat = dict(tree.flatten(jax.tree.map(np.asarray, r_msgs)))
    for c in range(P):
        for name, v in tree.flatten(t_msgs[c]):
            r = r_flat[name][c]
            assert np.all(np.abs(v.numpy() - r) <= 16 * _ulp(r)), (inner, c, name)
        for key in ("codes", "rans") if tcod.dynamic else ("codes",):
            for t, r in zip(jax.tree.leaves(t_pay[c][key]), jax.tree.leaves(r_pay[key])):
                np.testing.assert_array_equal(t.numpy(), np.asarray(r)[c])
    if tcod.dynamic:
        r_tb = np.asarray(jax.vmap(lambda pl: rcod.payload_nbytes_traced(pl, rs))(r_pay))
        t_tb = [int(tcod.payload_nbytes_traced(pl, ts)) for pl in t_pay]
        assert t_tb == r_tb.tolist()
    assert tcod.payload_nbytes(ts) == rcod.payload_nbytes(rs)
    assert tcod.code_nbytes(ts) == rcod.code_nbytes(rs)


def test_residual_contracts_and_debiases_the_det_grid():
    """Iterating ``up_transit`` against a fixed model keeps the residual
    bounded, and the time-averaged decode lands far closer to the model than
    the one-shot det decode (the mechanism that makes ``ef:fp4_e2m1_det``
    converge)."""
    _, _, tp, ts = _pair(seed=3, d_in=16, n_classes=4)
    codec = t_codec.get_codec("ef:fp4_e2m1_det")
    target = t_ef.flatten_q(tp, ts)
    e = torch.zeros((2, ts.total))
    keys = torch.zeros((2, 2), dtype=torch.int64).to(torch.uint32)
    norms, acc, T = [], torch.zeros_like(target), 24
    for _ in range(T):
        msgs, e, _ = codec.up_transit([tp, tp], ts, keys, e)
        norms.append(float(torch.linalg.norm(e[0])))
        acc += t_ef.flatten_q(msgs[0], ts)
    assert max(norms[T // 3:]) <= 1.5 * max(norms[: T // 3])
    one_shot = codec.inner.decode(codec.inner.encode(tp, ts, None), ts)
    err_one = float(torch.linalg.norm(t_ef.flatten_q(one_shot, ts) - target))
    err_avg = float(torch.linalg.norm(acc / T - target))
    assert 0 < err_avg < 0.5 * err_one


def test_registry_tags_match_reference():
    for name in ("ef", "ef:e4m3_det", "ef:fp4_e2m1_det", "ef:rans:fp4_e2m1_det",
                 "ef:rans:e4m3_det", "EF:FP4", "rans:delta:fp4_e2m1"):
        assert t_codec.get_codec(name).tag == r_codec.get_codec(name).tag, name
    assert t_codec.get_codec("ef").inner == t_codec.get_codec("e4m3")
    assert t_codec.registry_tags() == r_codec.registry_tags()


def test_validation_errors_match_reference():
    for name, match in (("ef:delta:e4m3", "competing"), ("ef:rans:delta:e4m3", "competing"),
                        ("ef:fp32", "grid codec"), ("delta:ef:e4m3", "grid codec")):
        with pytest.raises(ValueError, match=match):
            r_codec.get_codec(name)
        with pytest.raises(ValueError, match=match):
            t_codec.get_codec(name)
    with pytest.raises(ValueError, match="downlink"):
        WireLink("ef:e4m3_det", "e4m3")
    with pytest.raises(ValueError, match="delayed"):
        WireLink("e4m3", "ef:e4m3_det", up_scaling="delayed:4")
    _, _, tp, ts = _pair()
    c = t_codec.get_codec("ef:e4m3_det")
    for call in (lambda: c.encode(tp, ts, None), lambda: c.decode({}, ts),
                 lambda: c.fake_quant(tp, ts, None)):
        with pytest.raises(ValueError, match="up_transit"):
            call()


def _mini(up, down="e4m3", K=6):
    x, y = synthetic_classification(0, 600, d=16, n_classes=4)
    cx, cy, nk = partition_iid(x, y, k=K, seed=0)
    params = t_small.init_mlp(0, d_in=16, n_classes=4, device="cpu")
    opt = optim.sgd(0.05, wd_mask=weight_decay_mask(params),
                    trust_mask=clip_value_mask(params))
    cfg = FedConfig(n_clients=K, participation=0.5, local_steps=2, batch_size=8,
                    qat=QATConfig(), down_codec=down, up_codec=up)
    eng = RoundEngine(t_small.make_loss(t_small.apply_mlp), opt, cfg, device="cpu")
    data = (torch.from_numpy(cx), torch.from_numpy(cy).long(), torch.from_numpy(nk).float())
    return eng, params, data


def test_ef_round_updates_exactly_the_cohort_rows():
    eng, params, data = _mini("ef:fp4_e2m1_det")
    st = eng.init(params)
    spec = t_wire.make_wire_spec(params)
    assert st.clients.resid.shape == (6, spec.total) and not st.clients.resid.any()
    g = torch.Generator().manual_seed(0)
    d = eng.draw(g, data[2], data[0].shape[1])
    st1, m = eng.round_fn(st, *data, d)
    changed = torch.nonzero(torch.any(st1.clients.resid != st.clients.resid, dim=1))
    assert sorted(changed.reshape(-1).tolist()) == sorted(d.cohort.tolist())
    # EF adds nothing to the wire: a static leg reports the static count
    assert type(m["wire_bytes"]) is int and m["wire_bytes"] == eng.round_bytes(params)
    # the residual is bounded by a grid step of each leaf's clip
    assert float(st1.clients.resid.abs().max()) < 1.0


def test_non_ef_engine_keeps_clients_empty():
    for up in ("e4m3", "rans:delta:e4m3", "delta:fp4"):
        eng, params, _ = _mini(up)
        assert eng.init(params).clients == ()
        assert not eng.link.up_is_ef
    eng, params, _ = _mini("ef:rans:e4m3_det", down="rans:e4m3")
    assert eng.link.up_is_ef and eng.dynamic and eng.link.down_c.dynamic


def test_client_state_converts_from_the_reference():
    rp, rs, _, ts = _pair()
    r_state = r_ef.init_client_state(4, rs)
    r_state = r_state._replace(resid=r_state.resid.at[2].set(0.5))
    t_state = convert.from_jax_client_state(jax.tree.map(np.asarray, r_state), "cpu")
    assert isinstance(t_state, t_ef.ClientState)
    assert t_state.resid.dtype == torch.float32 and t_state.resid.shape == (4, ts.total)
    np.testing.assert_array_equal(t_state.resid.numpy(), np.asarray(r_state.resid))
    assert t_ef.init_client_state(4, ts).resid.shape == (4, rs.total)
