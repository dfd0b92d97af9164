"""The port's wire layout, codecs and byte accounting against the reference.

Layouts and bytes must be EXACTLY the reference's integers. Codes are equal
except adjacent-grid ties (at most 1e-5 of elements, as in
``test_torch_fp8``); the reference encodes with its default jnp backend and
a raw ``(2,)`` uint32 key, whose words the port takes directly.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as r_codec
from repro.core import metrics as r_metrics
from repro.core import wire as r_wire
from repro.core.engine import FedConfig as RCfg
from repro.core.qat import DISABLED as R_DISABLED
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import metrics as t_metrics
from repro_torch.core import wire as t_wire
from repro_torch.core.engine import FedConfig as TCfg
from repro_torch.core.qat import DISABLED as T_DISABLED

PAYLOAD = {"lenet": 137810, "mlp": 7360}
KEY = np.array([2718281828, 3141592653], np.uint32)


@functools.lru_cache(maxsize=None)
def _pair(name):
    p = r_small.REGISTRY[name][0](jax.random.PRNGKey(1))
    return p, convert.from_jax_params(jax.tree.map(np.asarray, p), device="cpu")


@pytest.mark.parametrize("name", ["lenet", "mlp"])
def test_wire_spec_layout_matches_reference(name):
    rp, tp = _pair(name)
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    for field in ("q_slots", "q_names", "q_shapes", "q_offsets", "total", "q_rows",
                  "q_row_offsets", "n_rows", "other_slots", "alpha_pos",
                  "n_other_elems", "alpha_cols_ok"):
        assert getattr(ts, field) == getattr(rs, field), field
    assert ts.n_leaves == rs.n_leaves
    assert t_wire.payload_nbytes(ts) == r_wire.payload_nbytes(rs) == PAYLOAD[name]


@pytest.mark.parametrize("name", ["lenet", "mlp"])
@pytest.mark.parametrize("mode", ["rand", "det"])
def test_encode_decode_match_reference(name, mode):
    rp, tp = _pair(name)
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    rpay = r_wire.encode(rp, rs, jnp.asarray(KEY), mode=mode)
    tpay = t_wire.encode(tp, ts, torch.from_numpy(KEY.astype(np.int64)).to(torch.uint32),
                         mode=mode)
    rc, tc = np.asarray(rpay["codes"]).astype(np.int32), tpay["codes"].numpy().astype(np.int32)
    assert tc.shape == rc.shape == (ts.total,)
    diff = rc != tc
    assert diff.sum() <= int(1e-5 * rc.size) and np.all(np.abs(rc - tc)[diff] == 1)
    for r, t in zip(rpay["other"], tpay["other"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    # decode the SAME codes on both sides
    rdec = r_wire.decode(rpay, rs)
    tdec = t_wire.decode({"codes": torch.from_numpy(np.array(rpay["codes"])),
                          "other": tpay["other"]}, ts)
    ref = dict(tree.flatten(jax.tree.map(np.asarray, rdec)))
    for n, v in tree.flatten(tdec):
        np.testing.assert_allclose(v.numpy(), ref[n], rtol=4e-6, atol=0, err_msg=n)


@pytest.mark.parametrize("mode", ["rand", "det", "none"])
def test_codec_and_round_bytes_match_reference(mode):
    rp, tp = _pair("lenet")
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    rc = r_codec.codec_for(r_codec.E4M3, mode)
    tc = t_codec.codec_for(t_codec.E4M3, mode)
    assert t_codec.leg_nbytes(tc, ts) == r_codec.leg_nbytes(rc, rs)
    assert tc.quantized == rc.quantized
    base = dict(n_clients=10, participation=0.3, local_steps=1, batch_size=2,
                comm_mode=mode)
    rcfg = RCfg(**base, qat=R_DISABLED if mode == "none" else RCfg().qat)
    tcfg = TCfg(**base, qat=T_DISABLED if mode == "none" else TCfg().qat)
    assert t_metrics.round_bytes_for(tp, tcfg) == r_metrics.round_bytes_for(rp, rcfg)


def test_lenet_round_bytes_are_the_slice_contract():
    """3 clients x 2 legs x 137810-byte payloads = 826860 bytes per round:
    136650 u8 codes + 290 f32 riders per payload."""
    _, tp = _pair("lenet")
    spec = t_wire.make_wire_spec(tp)
    assert (spec.total, spec.n_other_elems, spec.n_rows) == (136650, 290, 135)
    cfg = TCfg(n_clients=10, participation=0.3)
    assert t_metrics.round_bytes_for(tp, cfg) == 826860


def test_fp32_codec_roundtrips_exactly_and_fp8_codec_validates():
    _, tp = _pair("mlp")
    spec = t_wire.make_wire_spec(tp)
    c = t_codec.Fp32Codec()
    out = c.decode(c.encode(tp, spec, None), spec)
    for (n, a), (_, b) in zip(tree.flatten(tp), tree.flatten(out)):
        assert torch.equal(a, b), n
    with pytest.raises(ValueError, match="rounding"):
        t_codec.Fp8Codec(rounding="none")
    with pytest.raises(ValueError, match="1 code/byte"):
        t_codec.Fp8Codec(t_codec.FP8Format(exp=2, mant=1))


def test_stacked_alpha_uses_full_tile_layout():
    """A non-scalar clip value forces the per-element (R, LANE) alpha layout;
    decode(encode(x)) of on-grid values then returns them exactly."""
    w = torch.linspace(-1, 1, 3000).reshape(3, 1000)
    tp = {"l": {"w": w, "w_qa": torch.tensor([[0.5], [1.0], [2.0]])}}
    spec = t_wire.make_wire_spec(tp)
    assert not spec.alpha_cols_ok
    once = t_wire.decode(t_wire.encode(tp, spec, None, mode="det"), spec)
    twice = t_wire.decode(t_wire.encode(once, spec, None, mode="det"), spec)
    assert torch.equal(once["l"]["w"], twice["l"]["w"])
