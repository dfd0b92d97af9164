"""The port's sub-byte wire (B8 twins, ``PackedFpCodec``), ``DeltaCodec`` and
the codec registry against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages. The
reference's B8 kernels run as its own tests run them on the CPU (the
Pallas bodies under ``interpret=True``), and its codecs through its default
jnp dispatch path.

Tolerances, and why (those of ``test_torch_fp8``): codes equal, except
adjacent-grid ties from ``log2``/``exp2`` ULP differences between math
libraries, at most 1e-5 of codes (seen: 0 on every case here); values
decoded from the SAME codes within relative 4e-6 (seen: 1.0e-7 for E2M1,
4.4e-7 for E3M0). A delta leg decodes ``ref + residual``, which may nearly
cancel, so there the bound is relative 4e-6 of the residual plus one f32
ULP of the sum (seen: at most 3.7e-9 absolute, on sums of 1e-5 to 1e-3
whose residuals are 2e-3 to 2e-2). Bytes and layouts are EXACT.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import codec as r_codec
from repro.core import fp8 as r_fp8
from repro.core import metrics as r_metrics
from repro.core import wire as r_wire
from repro.kernels import dispatch as r_dispatch
from repro.kernels import fp8_quant as r_kern
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import fp8 as t_fp8
from repro_torch.core import metrics as t_metrics
from repro_torch.core import wire as t_wire
from repro_torch.kernels import dispatch as t_dispatch
from repro_torch.kernels import ref as t_ref

VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
KEY = np.array([2718281828, 3141592653], np.uint32)
FMTS = {"e2m1": (r_fp8.FP4_E2M1, t_fp8.FP4_E2M1), "e3m0": (r_fp8.FP4_E3M0, t_fp8.FP4_E3M0)}


def _tkey(k=KEY) -> torch.Tensor:
    return torch.from_numpy(np.asarray(k, np.int64)).to(torch.uint32)


def _assert_codes_close(port, ref, fmt):
    """Unfolded codes equal but for adjacent-grid ties."""
    port = t_ref.unfold_codes(torch.from_numpy(np.array(port)).reshape(1, -1), fmt).numpy()
    ref = t_ref.unfold_codes(torch.from_numpy(np.array(ref)).reshape(1, -1), fmt).numpy()
    diff = port != ref
    assert int(diff.sum()) <= int(TIE_FRAC * ref.size)
    assert np.all(np.abs(port[diff] - ref[diff]) == 1)


def _assert_values_close(port, ref):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bad = int(np.sum(np.abs(port - ref) > VALUE_RTOL * np.abs(ref)))
    assert bad <= int(TIE_FRAC * ref.size), f"{bad} elements beyond rtol {VALUE_RTOL}"


def _tiles(rows, seed, n_last=517):
    """Random (rows, 1024) tiles whose last row holds an odd-length tail
    (``n_last`` real elements, then the zero fill) and a row-max column."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, 1024)) * 0.2).astype(np.float32)
    x[-1, n_last:] = 0.0
    col = (np.abs(x).max(axis=1, keepdims=True) * 0.9).astype(np.float32)
    return x, col


def test_fp4_formats_match_reference():
    for name, (rf, tf) in FMTS.items():
        assert (tf.exp, tf.mant, tf.bits, tf.max_exp_code) == (rf.exp, rf.mant, rf.bits,
                                                                rf.max_exp_code), name
        assert tf.mant_scale == rf.mant_scale and tf.mant_const == float(np.log2(rf.mant_scale))
    b = np.linspace(14.0, 20.0, 7).astype(np.float32)
    np.testing.assert_allclose(t_fp8.alpha_from_bias(torch.from_numpy(b)).numpy(),
                               np.asarray(r_fp8.alpha_from_bias(jnp.asarray(b))), rtol=4e-6)


@pytest.mark.parametrize("fmt", list(FMTS))
def test_fold_unfold_match_reference_bitwise(fmt):
    rf, tf = FMTS[fmt]
    codes = np.random.default_rng(1).integers(0, 16, (3, 1024)).astype(np.int32)
    packed = np.asarray(r_kern.fold_codes(jnp.asarray(codes), rf))
    tpacked = t_ref.fold_codes(torch.from_numpy(codes), tf)
    assert tpacked.dtype == torch.uint8 and tuple(tpacked.shape) == (3, 512)
    np.testing.assert_array_equal(tpacked.numpy(), packed)
    # little-endian: code 2j in the low nibble of byte j
    np.testing.assert_array_equal(packed, codes[:, 0::2] | (codes[:, 1::2] << 4))
    np.testing.assert_array_equal(t_ref.unfold_codes(tpacked, tf).numpy(),
                                  np.asarray(r_kern.unfold_codes(jnp.asarray(packed), rf)))
    np.testing.assert_array_equal(t_ref.unfold_codes(tpacked, tf).numpy(), codes)
    assert t_ref.codes_per_byte(tf) == r_kern.codes_per_byte(rf) == 2
    with pytest.raises(ValueError, match="byte-pack"):
        t_ref.codes_per_byte(t_fp8.FP8Format(exp=2, mant=2))


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_sub_pack_twins_match_reference_kernels(fmt, alpha_layout, stochastic):
    rf, tf = FMTS[fmt]
    x, col = _tiles(4, seed=2)
    a = col if alpha_layout == "column" else np.broadcast_to(col, x.shape).copy()
    k = KEY if stochastic else None
    rk = None if k is None else jnp.asarray(k)
    tk = None if k is None else _tkey(k)
    rc = np.asarray(r_kern.quant_pack_sub_tiles(jnp.asarray(x), jnp.asarray(a), rk, fmt=rf,
                                                interpret=True))
    tc = t_dispatch.quant_pack_sub_tiles(torch.from_numpy(x), torch.from_numpy(a), tk, fmt=tf)
    assert tc.dtype == torch.uint8 and tuple(tc.shape) == rc.shape == (4, 512)
    _assert_codes_close(tc.numpy(), rc, tf)
    # the reference's jnp dispatch path folds the same codes
    rj = np.asarray(r_dispatch.quant_pack_sub_tiles(jnp.asarray(x), jnp.asarray(a), rk, fmt=rf))
    _assert_codes_close(tc.numpy(), rj, tf)
    # the zero fill packs to code 0, so the odd tail's pad nibble is 0
    assert int(tc[-1, 517 // 2]) >> 4 == 0 and not tc[-1, 517 // 2 + 1:].any()
    # decoded from the SAME codes
    ru = np.asarray(r_kern.unpack_sub_tiles(jnp.asarray(rc), jnp.asarray(a), fmt=rf,
                                            interpret=True))
    tu = t_dispatch.unpack_sub_tiles(torch.from_numpy(np.array(rc)), torch.from_numpy(a), fmt=tf)
    assert tu.dtype == torch.float32 and tuple(tu.shape) == (4, 1024)
    _assert_values_close(tu.numpy(), ru)
    rju = np.asarray(r_dispatch.unpack_sub_tiles(jnp.asarray(rc), jnp.asarray(a), fmt=rf))
    _assert_values_close(tu.numpy(), rju)


@pytest.mark.parametrize("fmt", list(FMTS))
@pytest.mark.parametrize("stochastic", [False, True])
def test_sub_pack_transit_equals_fake_quant_at_the_format(fmt, stochastic):
    """Packing never changes a rounding decision: decode(encode(x)) is the
    B5 fake-quant at the FP4 format, within 1 f32 ULP."""
    _, tf = FMTS[fmt]
    x, col = _tiles(3, seed=3)
    x, col = torch.from_numpy(x), torch.from_numpy(col)
    k = _tkey() if stochastic else None
    wire_vals = t_ref.unpack_sub_tiles(t_ref.quant_pack_sub_tiles(x, col, k, tf), col, tf)
    q = t_ref.fake_quant_tiles(x, col, k, tf)
    aw = wire_vals.abs()
    assert bool(((q - wire_vals).abs() <= torch.nextafter(aw, aw + 1) - aw).all())


def test_sub_byte_wrappers_reject_whole_byte_formats():
    x = torch.zeros((1, 1024))
    col = torch.ones((1, 1))
    with pytest.raises(ValueError, match="one byte each"):
        t_dispatch.quant_pack_sub_tiles(x, col, None, fmt=t_fp8.E4M3)
    with pytest.raises(ValueError, match="one byte each"):
        t_dispatch.unpack_sub_tiles(torch.zeros((1, 1024), dtype=torch.uint8), col,
                                    fmt=t_fp8.E4M3)
    with pytest.raises(ValueError, match="several per byte"):
        t_dispatch.quant_pack_amax_tiles(x, col, None, fmt=t_fp8.FP4_E2M1)


# --- codecs on model trees ---------------------------------------------------


def _odd_tree(seed=0):
    """A tree with an odd-length quantized leaf (999 elements) beside an
    even one, so one FP4 byte holds a pad nibble."""
    rng = np.random.default_rng(seed)
    def dense(shape):
        w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
        return {"w": w, "w_qa": np.asarray(np.abs(w).max(), np.float32),
                "b": np.zeros(shape[-1], np.float32)}
    return {"a": dense((3, 333)), "b": dense((64, 10))}


@functools.lru_cache(maxsize=None)
def _pair(name):
    if name == "odd":
        rp = jax.tree.map(jnp.asarray, _odd_tree())
    else:
        rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(1))
    return rp, convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")


def _perturbed(rp, tp, scale=1e-2, seed=5):
    """A second tree near the first (a client model after training), the
    same numbers on both sides."""
    rng = np.random.default_rng(seed)
    flat = [np.asarray(l) for l in jax.tree_util.tree_leaves(rp)]
    new = [np.asarray(l + scale * rng.standard_normal(l.shape).astype(np.float32)
                      * np.abs(l).max(), np.float32) for l in flat]
    r2 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(rp),
                                      [jnp.asarray(v) for v in new])
    names = [n for n, _ in tree.flatten(tp)]
    return r2, tree.unflatten(names, [torch.from_numpy(v.copy()) for v in new])


def _assert_payloads_close(tpay, rpay, fmt):
    _assert_codes_close(tpay["codes"].numpy(), np.asarray(rpay["codes"]), fmt)
    assert len(tpay["other"]) == len(rpay["other"])
    for t, r in zip(tpay["other"], rpay["other"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))


def _assert_trees_close(ttree, rtree):
    ref = dict(tree.flatten(jax.tree.map(np.asarray, rtree)))
    for n, v in tree.flatten(ttree):
        _assert_values_close(v.numpy(), ref[n])


@pytest.mark.parametrize("name", ["odd", "mlp", "lenet"])
@pytest.mark.parametrize("codec", ["fp4_e2m1", "fp4_e3m0_det"])
def test_packed_codec_matches_reference(name, codec):
    rp, tp = _pair(name)
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    rc, tc = r_codec.get_codec(codec), t_codec.get_codec(codec)
    assert tc.tag == rc.tag
    rpay = rc.encode(rp, rs, jnp.asarray(KEY))
    tpay = tc.encode(tp, ts, _tkey())
    assert tpay["codes"].numel() == tc.code_nbytes(ts) == rc.code_nbytes(rs)
    _assert_payloads_close(tpay, rpay, tc.fmt)
    # decode the SAME payload on both sides
    same = {"codes": torch.from_numpy(np.array(rpay["codes"])), "other": tpay["other"]}
    _assert_trees_close(tc.decode(same, ts), rc.decode(rpay, rs))


@pytest.mark.parametrize("name", ["odd", "mlp"])
@pytest.mark.parametrize("codec", ["delta:e4m3", "delta:fp4_e2m1", "delta:fp4_e2m1_det"])
def test_delta_codec_matches_reference(name, codec):
    rp, tp = _pair(name)
    rp2, tp2 = _perturbed(rp, tp)
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    rc, tc = r_codec.get_codec(codec), t_codec.get_codec(codec)
    assert tc.tag == rc.tag
    rpay = rc.encode(rp2, rs, jnp.asarray(KEY), ref=rp)
    tpay = tc.encode(tp2, ts, _tkey(), ref=tp)
    _assert_payloads_close(tpay, rpay, tc.inner.fmt)
    # the residual clip values ride last, one per quantized leaf
    assert tuple(tpay["other"][-1].shape) == (len(ts.q_slots),)
    same = {"codes": torch.from_numpy(np.array(rpay["codes"])), "other": tpay["other"]}
    # ref + decoded residual: the residual within rtol 4e-6, plus the sum's
    # own rounding (one f32 ULP), since ref + residual may nearly cancel
    ref = dict(tree.flatten(jax.tree.map(np.asarray, rc.decode(rpay, rs, ref=rp))))
    base = dict(tree.flatten(tp))
    for n, v in tree.flatten(tc.decode(same, ts, ref=tp)):
        r = ref[n].astype(np.float64)
        res = np.abs(r - base[n].numpy())
        bound = VALUE_RTOL * res + np.spacing(np.abs(ref[n]).astype(np.float32))
        assert np.all(np.abs(v.numpy() - r) <= bound), n
    with pytest.raises(ValueError, match="ref"):
        tc.encode(tp2, ts, _tkey())


def test_registry_names_and_tags_match_reference():
    assert t_codec.registry_tags() == r_codec.registry_tags()
    names = ["e4m3", "e5m2_det", "fp4", "fp4_det", "fp4_e3m0", "fp4_e2m1_det", "fp32",
             "none", "delta", "delta:fp4", "delta:e5m2_det", "DELTA:FP4_E3M0"]
    for n in names:
        assert t_codec.get_codec(n).tag == r_codec.get_codec(n).tag, n
        assert t_codec.get_codec(n).quantized == r_codec.get_codec(n).quantized, n
    assert t_codec.get_codec("fp4") == t_codec.PackedFpCodec(t_fp8.FP4_E2M1, "rand")
    c = t_codec.Fp8Codec(t_fp8.E5M2, "det")
    assert t_codec.get_codec(c) is c
    for fmt, mode in ((t_fp8.E4M3, "rand"), (t_fp8.FP4_E3M0, "det"), (t_fp8.E4M3, "none")):
        rfmt = r_fp8.FP8Format(fmt.exp, fmt.mant)
        assert t_codec.codec_for(fmt, mode).tag == r_codec.codec_for(rfmt, mode).tag


def test_unported_and_bad_codecs_raise():
    # the rans: and ef: codecs are ported now: they resolve to the reference's
    # tags, and a delta over EF is refused as the reference refuses it
    for name in ("rans", "rans:fp4_e2m1", "ef:e4m3_det", "ef"):
        assert t_codec.get_codec(name).tag == r_codec.get_codec(name).tag
    with pytest.raises(ValueError, match="grid codec"):
        t_codec.get_codec("delta:ef:e4m3")
    with pytest.raises(KeyError, match="unknown codec"):
        t_codec.get_codec("fp6")
    with pytest.raises(TypeError):
        t_codec.get_codec(3)
    with pytest.raises(ValueError, match="sub-byte"):
        t_codec.PackedFpCodec(t_fp8.E4M3)
    with pytest.raises(ValueError, match="grid codec"):
        t_codec.DeltaCodec(t_codec.Fp32Codec())
    with pytest.raises(ValueError, match="downlink"):
        t_codec_link("delta:e4m3", "e4m3")


def t_codec_link(down, up):
    from repro_torch.core.engine import WireLink

    return WireLink(down, up)


CODECS = ["fp32", "e4m3", "e5m2_det", "fp4_e2m1", "fp4_e3m0_det", "delta:e4m3",
          "delta:fp4_e2m1", "delta:fp4_e3m0_det"]


@pytest.mark.parametrize("name", ["odd", "mlp", "lenet"])
def test_payload_bytes_are_exact(name):
    rp, tp = _pair(name)
    rs, ts = r_wire.make_wire_spec(rp), t_wire.make_wire_spec(tp)
    assert ts.alpha_shapes == rs.alpha_shapes
    for c in CODECS:
        rc, tc = r_codec.get_codec(c), t_codec.get_codec(c)
        assert t_codec.leg_nbytes(tc, ts) == r_codec.leg_nbytes(rc, rs), c
        assert tc.payload_nbytes(ts) == rc.payload_nbytes(rs), c
        assert tc.code_nbytes(ts) == rc.code_nbytes(rs), c
        assert t_metrics.payload_bytes(tp, codec=c) == r_metrics.payload_bytes(rp, codec=c), c
    for q, uq in ((True, None), (False, None), (True, False)):
        assert (t_metrics.round_bytes(tp, 3, q, uq)
                == r_metrics.round_bytes(rp, 3, q, uq)), (q, uq)
    assert (t_metrics.round_bytes(tp, 3, down_codec="fp4", up_codec="delta:fp4")
            == r_metrics.round_bytes(rp, 3, down_codec="fp4", up_codec="delta:fp4"))
    assert t_metrics.param_count(tp) == r_metrics.param_count(rp)


def test_fp4_payload_of_an_odd_leaf_is_ceil_half():
    _, tp = _pair("odd")
    spec = t_wire.make_wire_spec(tp)
    c = t_codec.get_codec("fp4")
    assert t_wire.code_sizes(spec, c.fmt) == [500, 320]    # ceil(999 / 2), 640 / 2
    pay = c.encode(tp, spec, _tkey())
    assert pay["codes"].numel() == 820
    # the last byte of the odd leaf: its high nibble is the zero pad
    assert int(pay["codes"][499]) >> 4 == 0
