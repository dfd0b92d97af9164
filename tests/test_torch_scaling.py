"""The port's scaling policies (``core.scaling``), the amax kernels' twins
(B9) and the scaled encode/decode against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages. The
reference's B9 kernels run as its own tests run them on the CPU (the
Pallas bodies under ``interpret=True``).

Tolerances, and why: the per-row amax and everything built from it (the
amax history, the effective scales) are EXACT, since a float max is exact
in any order and 2^M an exact multiply; codes equal but for adjacent-grid
ties, at most 1e-5 of codes (seen: 0); decoded values within relative 4e-6
(seen: 5.5e-7), as in ``test_torch_fp8``. Bytes are EXACT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as r_codec
from repro.core import fp8 as r_fp8
from repro.core import scaling as r_scaling
from repro.core import wire as r_wire
from repro.kernels import fp8_quant as r_kern
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import fp8 as t_fp8
from repro_torch.core import scaling as t_scaling
from repro_torch.core import wire as t_wire
from repro_torch.core.engine import WireLink
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ref as t_ref

VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
KEY = np.array([1234567, 4000000000], np.uint32)
FMTS = {"e4m3": (r_fp8.E4M3, t_fp8.E4M3), "e5m2": (r_fp8.E5M2, t_fp8.E5M2),
        "e2m1": (r_fp8.FP4_E2M1, t_fp8.FP4_E2M1), "e3m0": (r_fp8.FP4_E3M0, t_fp8.FP4_E3M0)}


def _tkey(k=KEY) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k, np.int64)).to(torch.uint32)


def _codes_close(port, ref, fmt):
    port = t_ref.unfold_codes(torch.from_numpy(np.array(port)).reshape(1, -1), fmt).numpy()
    ref = t_ref.unfold_codes(torch.from_numpy(np.array(ref)).reshape(1, -1), fmt).numpy()
    diff = port != ref
    assert int(diff.sum()) <= int(TIE_FRAC * ref.size)
    assert np.all(np.abs(port[diff] - ref[diff]) == 1)


# --- policies ---------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "current", "delayed", "delayed:4",
                                  "delayed:16:1", " Delayed:8:-1 ", "frozen",
                                  "per_round_frozen"])
def test_get_policy_matches_reference(spec):
    r, t = r_scaling.get_policy(spec), t_scaling.get_policy(spec)
    assert type(t).__name__ == type(r).__name__
    assert (t.name, t.is_current, t.stateful) == (r.name, r.is_current, r.stateful)
    for f in ("history_len", "margin"):
        assert getattr(t, f, None) == getattr(r, f, None)
    assert t_scaling.get_policy(t) is t


def test_bad_policies_raise():
    for bad in ("delayed:1:2:3", "delayed:0", "max", "frozen:2"):
        with pytest.raises(ValueError):
            t_scaling.get_policy(bad)
        with pytest.raises(ValueError):
            r_scaling.get_policy(bad)
    with pytest.raises(TypeError):
        t_scaling.get_policy(4)


@pytest.mark.parametrize("spec", ["delayed:4", "delayed:3:2", "delayed:2:-1"])
def test_delayed_history_matches_reference_exactly(spec):
    rng = np.random.default_rng(3)
    a0 = (np.abs(rng.standard_normal(5)) + 0.1).astype(np.float32)
    r, t = r_scaling.get_policy(spec), t_scaling.get_policy(spec)
    rh, th = r.init_state(jnp.asarray(a0)), t.init_state(torch.from_numpy(a0))
    assert tuple(th.shape) == (t.history_len, 5)
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh))
    for _ in range(t.history_len + 2):
        amax = (np.abs(rng.standard_normal(5)) * 2).astype(np.float32)
        rh, th = r.update(rh, jnp.asarray(amax)), t.update(th, torch.from_numpy(amax))
        np.testing.assert_array_equal(th.numpy(), np.asarray(rh))
        np.testing.assert_array_equal(t.effective(th).numpy(), np.asarray(r.effective(rh)))
    # the window holds the last H rows and the scale is 2^M times their max
    np.testing.assert_array_equal(th[-1].numpy(), amax)
    np.testing.assert_array_equal(t.effective(th).numpy(),
                                  np.float32(2.0 ** t.margin) * th.numpy().max(0))
    floor = t.effective(torch.zeros((t.history_len, 2)))
    np.testing.assert_array_equal(floor.numpy(), np.float32(t_fp8._ALPHA_FLOOR))


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_leaf_alphas_and_byte_deltas_match_reference(name):
    rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(2))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    np.testing.assert_array_equal(t_scaling.leaf_alphas(tp, ts).numpy(),
                                  np.asarray(r_scaling.leaf_alphas(rp, rs)))
    n_q = len(ts.q_slots)
    for codec in ("e4m3", "fp4_e2m1", "e5m2_det"):
        rc, tc = r_codec.get_codec(codec), t_codec.get_codec(codec)
        plain = t_codec.leg_nbytes(tc, ts)
        for spec, delta in (("current", 0), ("delayed:4", 4 * n_q), ("delayed:16:1", 4 * n_q),
                            ("frozen", -4 * n_q)):
            rpol, tpol = r_scaling.get_policy(spec), t_scaling.get_policy(spec)
            n = t_codec.leg_nbytes(tc, ts, policy=tpol)
            assert n == r_codec.leg_nbytes(rc, rs, policy=rpol) == plain + delta, (codec, spec)


# --- the amax kernels' twins --------------------------------------------------


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_amax_twins_match_reference_kernels(fmt, alpha_layout, stochastic):
    rf, tf = FMTS[fmt]
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 1024)) * 0.3).astype(np.float32)
    x[-1, 301:] = 0.0
    col = (np.abs(x).max(axis=1, keepdims=True) * 0.7).astype(np.float32)  # some clip
    a = col if alpha_layout == "column" else np.broadcast_to(col, x.shape).copy()
    k = KEY if stochastic else None
    rk, tk = (None, None) if k is None else (jnp.asarray(k), _tkey(k))
    sub = tf.bits < 8
    r_fn = r_kern.quant_pack_sub_amax_tiles if sub else r_kern.quant_pack_amax_tiles
    t_fn = t_dispatch.quant_pack_sub_amax_tiles if sub else t_dispatch.quant_pack_amax_tiles
    rc, rm = r_fn(jnp.asarray(x), jnp.asarray(a), rk, fmt=rf, interpret=True)
    tc, tm = t_fn(torch.from_numpy(x), torch.from_numpy(a), tk, fmt=tf)
    assert tuple(tm.shape) == (3, 1) and tm.dtype == torch.float32
    # the raw row max, unclipped: exact
    np.testing.assert_array_equal(tm.numpy(), np.asarray(rm))
    np.testing.assert_array_equal(tm.numpy(), np.abs(x).max(axis=1, keepdims=True))
    _codes_close(tc.numpy(), np.asarray(rc), tf)
    # the codes are the non-amax encode's, bit for bit
    plain = (t_ref.quant_pack_sub_tiles if sub else t_ref.quant_pack_tiles)(
        torch.from_numpy(x), torch.from_numpy(a), tk, tf)
    assert torch.equal(tc, plain)


# --- scaled encode/decode ------------------------------------------------------


def _pair(name="mlp"):
    rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(3))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    return rp, tp, r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)


@pytest.mark.parametrize("codec", ["e4m3", "e5m2_det", "fp4_e2m1", "fp4_e3m0_det"])
def test_encode_scaled_with_amax_matches_reference(codec):
    rp, tp, rs, ts = _pair()
    rc, tc = r_codec.get_codec(codec), t_codec.get_codec(codec)
    a = np.array([0.5, 0.25, 0.75], np.float32)[:len(ts.q_slots)]
    rpay, ramax = rc.encode_scaled(rp, rs, jnp.asarray(KEY), jnp.asarray(a), with_amax=True)
    tpays, tamax = tc.encode_scaled_many([tp], ts, _tkey()[None], torch.from_numpy(a))
    tpay, tamax = tpays[0], tamax[0]
    np.testing.assert_array_equal(tamax.numpy(), np.asarray(ramax))
    flat = dict(tree.flatten(tp))
    np.testing.assert_array_equal(tamax.numpy(),
                                  [float(flat[n].abs().max()) for n in ts.q_names])
    _codes_close(tpay["codes"].numpy(), np.asarray(rpay["codes"]), tc.fmt)
    for t, r in zip(tpay["other"], rpay["other"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    np.testing.assert_array_equal(tpay["other"][-1].numpy(), a)  # the scales ride last
    # without amax: the same payload
    plain = tc.encode_scaled(tp, ts, _tkey(), torch.from_numpy(a))
    assert torch.equal(plain["codes"], tpay["codes"])
    # decode the SAME payload on both sides
    same = {"codes": torch.from_numpy(np.array(rpay["codes"])), "other": tpay["other"]}
    ref = dict(tree.flatten(jax.tree.map(np.asarray, rc.decode_scaled(rpay, rs))))
    for n, v in tree.flatten(tc.decode_scaled(same, ts)):
        r = ref[n].astype(np.float64)
        bad = np.abs(v.numpy() - r) > VALUE_RTOL * np.abs(r)
        assert int(bad.sum()) <= int(TIE_FRAC * r.size), n


@pytest.mark.parametrize("codec", ["e4m3", "fp4_e2m1"])
def test_frozen_splice_is_bitwise_current(codec):
    """Frozen drops the alpha riders (-4 B each) and the receiver splices its
    own back: the decoded tree equals the plain wire's, bitwise."""
    rp, tp, rs, ts = _pair("lenet")
    tc, rc = t_codec.get_codec(codec), r_codec.get_codec(codec)
    alphas = t_scaling.leaf_alphas(tp, ts)
    pay = tc.encode_scaled(tp, ts, _tkey(), alphas, drop_alphas=True)
    assert len(pay["other"]) == len(ts.other_slots) - len(ts.q_slots)
    frozen = tc.decode_scaled(pay, ts, alphas=alphas, dropped=True)
    plain = tc.decode(tc.encode(tp, ts, _tkey()), ts)
    for (n, a), (_, b) in zip(tree.flatten(frozen), tree.flatten(plain)):
        assert torch.equal(a, b) and a.shape == b.shape, n
    rpay = rc.encode_scaled(rp, rs, jnp.asarray(KEY), r_scaling.leaf_alphas(rp, rs),
                            drop_alphas=True)
    _codes_close(pay["codes"].numpy(), np.asarray(rpay["codes"]), tc.fmt)
    with pytest.raises(ValueError, match="alphas="):
        tc.decode_scaled(pay, ts, dropped=True)


def test_wire_link_rejects_what_the_reference_rejects():
    from repro.core.engine import WireLink as RLink

    for kw in (dict(up_scaling="frozen"),
               dict(down_codec="fp32", down_scaling="delayed:4"),
               dict(up_codec="delta:e4m3", up_scaling="delayed"),
               dict(down_codec="delta:fp4", up_codec="fp4")):
        with pytest.raises(ValueError):
            WireLink(**{"down_codec": "e4m3", "up_codec": "e4m3", **kw})
        with pytest.raises(ValueError):
            RLink(**kw)
    link = WireLink("fp4", "delta:fp4", "frozen", None)
    assert link.scaled and link.down_c.tag == "fp4_e2m1" and link.up_p.is_current
    assert link.scales_init({"a": {"w": torch.ones(3), "w_qa": torch.tensor(1.0)}}) == ((), ())
    from repro_torch.core.engine import FedConfig

    with pytest.raises(ValueError, match="unknown scaling policy"):
        FedConfig(down_scaling="max")
