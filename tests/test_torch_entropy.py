"""The port's static-table rANS (``kernels.ref`` twins, ``kernels.rans``,
``core.entropy``) against the live JAX reference.

Everything here is integer or exact: the tables, the coded buffers (the zero
tail past each lane's length included), the final states and lengths, and
the decoded symbols must equal the reference's EXACTLY, with no tolerance.
The reference's decode is checked both ways its own tests run it: the
``lax.scan`` fallback and the Pallas kernel in interpret mode. Streams: random
bytes, bytes drawn from the table (peaked, the matched case), the symbols the
table finds least probable, lengths around one row of 16 lanes, and the real
E4M3 and FP4 code streams of the format ablation's MLP (8832 and 4416 bytes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as r_codec
from repro.core import entropy as r_entropy
from repro.core import fp8 as r_fp8
from repro.core import wire as r_wire
from repro.kernels import rans as r_rans
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import entropy as t_entropy
from repro_torch.core import fp8 as t_fp8
from repro_torch.core import wire as t_wire
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import rans as t_rans

FMTS = [("e4m3", r_fp8.E4M3, t_fp8.E4M3), ("e5m2", r_fp8.E5M2, t_fp8.E5M2),
        ("fp4_e2m1", r_fp8.FP4_E2M1, t_fp8.FP4_E2M1),
        ("fp4_e3m0", r_fp8.FP4_E3M0, t_fp8.FP4_E3M0)]


@pytest.mark.parametrize("sigma", [t_entropy.SIGMA_PLAIN, t_entropy.SIGMA_DELTA])
@pytest.mark.parametrize("name,rfmt,tfmt", FMTS, ids=[f[0] for f in FMTS])
def test_byte_table_equals_reference(name, rfmt, tfmt, sigma):
    want = r_entropy.byte_table(rfmt, sigma)
    got = t_entropy.byte_table(tfmt, sigma)
    for w, g in zip(want, got):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert t_entropy.SIGMA_PLAIN == r_entropy.SIGMA_PLAIN
    assert t_entropy.SIGMA_DELTA == r_entropy.SIGMA_DELTA


def test_constants_and_sizes_equal_reference():
    for k in ("SCALE_BITS", "TAB", "L", "LANES", "RENORMS"):
        assert getattr(t_rans, k) == getattr(r_rans, k), k
    for n in (0, 1, 15, 16, 17, 8832, 136650):
        assert t_rans.n_steps(n) == r_rans.n_steps(n)
        assert t_rans.buf_cols(n) == r_rans.buf_cols(n)


def _mlp_codes(codec_name: str) -> np.ndarray:
    """The reference's code stream of the format ablation MLP's init weights."""
    p = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    spec = r_wire.make_wire_spec(p)
    return np.asarray(r_codec.get_codec(codec_name).encode(
        p, spec, jax.random.PRNGKey(1))["codes"]).astype(np.int64)


def _stream(kind: str, n: int, table) -> np.ndarray:
    rng = np.random.RandomState(n)
    freq, _, s2s = table
    if kind == "random":
        return rng.randint(0, 256, n)
    if kind == "peaked":
        return s2s[rng.randint(0, r_rans.TAB, n)]
    return np.repeat(np.argsort(freq, kind="stable")[:8], -(-n // 8))[:n]  # improbable


STREAMS = [(k, n) for k in ("random", "peaked", "improbable") for n in (1, 15, 16, 17, 333)]
STREAMS += [("mlp e4m3", None), ("mlp fp4_e2m1", None)]


def _case(kind, n):
    if kind.startswith("mlp"):
        name = kind.split()[1]
        fmt = t_fp8.E4M3 if name == "e4m3" else t_fp8.FP4_E2M1
        return _mlp_codes(name), r_entropy.byte_table(
            r_fp8.E4M3 if name == "e4m3" else r_fp8.FP4_E2M1, 0.28), fmt
    table = r_entropy.byte_table(r_fp8.FP4_E2M1, 0.2)
    return _stream(kind, n, table), table, t_fp8.FP4_E2M1


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a)).to(dtype)


@pytest.mark.parametrize("kind,n", STREAMS, ids=[f"{k}-{n}" for k, n in STREAMS])
def test_encode_and_decode_twins_equal_reference(kind, n):
    syms, (freq, cum, s2s), _ = _case(kind, n)
    n = len(syms)
    jf, jc, js = (jnp.asarray(a) for a in (freq, cum, s2s))
    r_buf, r_state, r_lens = r_rans.rans_encode(jnp.asarray(syms, jnp.int32), jf, jc)
    tf, tc, ts = _t(freq, torch.int32), _t(cum, torch.int32), _t(s2s, torch.int32)
    buf, state, lens = dispatch.rans_encode(_t(syms, torch.uint8), tf, tc)
    assert buf.dtype == torch.uint8 and state.dtype == lens.dtype == torch.int32
    np.testing.assert_array_equal(buf.numpy(), np.asarray(r_buf))   # zero tail included
    np.testing.assert_array_equal(state.numpy(), np.asarray(r_state))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(r_lens))
    out = dispatch.rans_decode(buf, state, lens, n, tf, tc, ts)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), syms)
    want = np.asarray(r_rans.rans_decode_jnp(r_buf, r_state, r_lens, n, jf, jc, js))
    np.testing.assert_array_equal(out.numpy(), want)
    pal = np.asarray(r_rans.rans_decode_pallas(r_buf, r_state, r_lens, n, jf, jc, js,
                                               interpret=True))
    np.testing.assert_array_equal(out.numpy(), pal)


def test_decode_twin_reads_clipped_positions_as_reference():
    """A buffer that does not come from the encode (random bytes, states and
    lengths, some lengths 0 so ``rpos`` starts at -1): the decode reads at
    ``clip(rpos, 0, cols - 1)`` as ``_decode_step`` does, so even garbage
    decodes to the reference's symbols."""
    rng = np.random.RandomState(5)
    freq, cum, s2s = r_entropy.byte_table(r_fp8.E4M3, 0.28)
    n, cols = 200, r_rans.buf_cols(200)
    buf = rng.randint(0, 256, (r_rans.LANES, cols))
    state = rng.randint(r_rans.L, 2 ** 31 - 1, r_rans.LANES)
    lens = rng.randint(0, cols + 1, r_rans.LANES)
    lens[:3] = 0
    want = np.asarray(r_rans.rans_decode_jnp(
        jnp.asarray(buf, jnp.uint8), jnp.asarray(state, jnp.int32),
        jnp.asarray(lens, jnp.int32), n, *(jnp.asarray(a) for a in (freq, cum, s2s))))
    got = ref.rans_decode(_t(buf, torch.uint8), _t(state, torch.int32),
                          _t(lens, torch.int32), n, _t(freq, torch.int32),
                          _t(cum, torch.int32), _t(s2s, torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


def _pair():
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    return rp, r_wire.make_wire_spec(rp), tp, t_wire.make_wire_spec(tp)


@pytest.mark.parametrize("inner", ["e4m3_det", "fp4_e2m1_det", "delta:e4m3_det"])
def test_rans_payload_equals_reference_on_det_codes(inner):
    """A deterministic inner codes the same bytes in both packages, so the
    whole rANS payload (planes, states, lengths, riders) and its traced size
    are the reference's."""
    rp, rs, tp, ts = _pair()
    rref = jax.tree.map(lambda a: a * 0.9, rp) if inner.startswith("delta") else None
    tref = convert.from_jax_params(jax.tree.map(np.asarray, rref), "cpu") if rref else None
    rc, tc = r_codec.get_codec("rans:" + inner), t_codec.get_codec("rans:" + inner)
    rpay = rc.encode(rp, rs, jax.random.PRNGKey(0), ref=rref)
    tpay = tc.encode(tp, ts, None, ref=tref)
    np.testing.assert_array_equal(tpay["codes"].numpy(), np.asarray(rpay["codes"]))
    for t, r in zip(tpay["rans"], rpay["rans"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    for t, r in zip(tpay["other"], rpay["other"]):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=1e-6)
    assert int(tc.payload_nbytes_traced(tpay, ts)) == int(rc.payload_nbytes_traced(rpay, rs))
    assert tc.payload_nbytes(ts) == rc.payload_nbytes(rs)


@pytest.mark.parametrize("inner", ["e4m3", "fp4_e2m1", "fp4_e3m0_det", "delta:fp4_e2m1",
                                   "delta:e4m3"])
def test_rans_codec_is_lossless_and_bound_dominates(inner):
    _, _, tp, ts = _pair()
    ref_tree = tp if inner.startswith("delta") else None
    ic, rc = t_codec.get_codec(inner), t_codec.get_codec("rans:" + inner)
    key = torch.tensor([3, 4], dtype=torch.int64).to(torch.uint32)
    want = ic.decode(ic.encode(tp, ts, key, ref=ref_tree), ts, ref=ref_tree)
    pay = rc.encode(tp, ts, key, ref=ref_tree)
    got = rc.decode(pay, ts, ref=ref_tree)
    for a, b in zip(tree.leaves(want), tree.leaves(got)):
        assert torch.equal(a, b)
    traced = int(rc.payload_nbytes_traced(pay, ts))
    assert 0 < traced <= rc.payload_nbytes(ts) == t_codec.leg_nbytes(rc, ts)
    assert rc.dynamic and not ic.dynamic
    assert ic.payload_nbytes_traced(None, ts) == ic.payload_nbytes(ts)


def test_rans_codec_tags_sigmas_and_validation():
    for name in ("rans", "rans:fp4", "rans:delta:e4m3", "rans:e5m2_det", "RANS:FP4_E3M0"):
        tc, rc = t_codec.get_codec(name), r_codec.get_codec(name)
        assert tc.tag == rc.tag and tc.table_sigma == rc.table_sigma, name
        assert tc.grid_fmt.exp == rc.grid_fmt.exp and tc.grid_fmt.mant == rc.grid_fmt.mant
    delta, plain = t_codec.get_codec("delta:e4m3"), t_codec.get_codec("fp4")
    assert t_entropy.RansCodec(delta).table_sigma == t_entropy.SIGMA_DELTA
    assert t_entropy.RansCodec(plain).table_sigma == t_entropy.SIGMA_PLAIN
    with pytest.raises(ValueError, match="grid codec"):
        t_codec.get_codec("rans:fp32")
    with pytest.raises(ValueError, match="grid codec"):
        t_entropy.RansCodec(t_codec.get_codec("rans:e4m3"))


def test_quantization_grid_equals_reference():
    for _, rfmt, tfmt in FMTS:
        for a in (1.0, 0.37):
            np.testing.assert_array_equal(t_fp8.quantization_grid(a, tfmt),
                                          r_fp8.quantization_grid(a, rfmt))


def test_rans_wrappers_take_the_twin_on_cpu_without_counting():
    from repro_torch.kernels import fp8_quant

    fp8_quant.reset_launches()
    freq, cum, s2s = (torch.from_numpy(a) for a in t_entropy.byte_table(t_fp8.E4M3, 0.28))
    syms = torch.arange(40, dtype=torch.uint8)
    buf, state, lens = t_rans.rans_encode(syms, freq, cum)
    assert torch.equal(t_rans.rans_decode(buf, state, lens, 40, freq, cum, s2s), syms)
    assert fp8_quant.LAUNCHES["rans_encode"] == fp8_quant.LAUNCHES["rans_decode"] == 0
