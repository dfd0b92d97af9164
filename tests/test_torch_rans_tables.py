"""The rANS kernels' tables and arithmetic (``csrc/rans.cu``), replayed on the
CPU, and the cohort transit of ``core.entropy`` against the per-client path
and the live JAX reference.

The kernels cannot run here, so what they compute differently from the
twins is replayed in numpy and held to the twins EXACTLY (integers, no
tolerance): the packed slot table of the decode, the encode's reciprocal
table (``ref.rans_enc_table``) and its division-free step, the one-decision
renorm of both, and the decode's staged windows and the encode's emitted
bytes appended phase by phase, as the kernels lay them out (phases of a
few rows, so streams cross many phase boundaries; corrupted streams whose
lanes read past their first byte and their last column, the reference's
clipped reads). The cohort
transit is bitwise the per-client path on the CPU twins (messages, residual
rows, payloads, traced bytes) and, through it, the reference's (payload
bytes exact; messages within 16 f32 ULP, as ``tests/test_torch_ef.py``
states it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import rans as r_rans
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import codec as t_codec
from repro_torch.core import ef as t_ef
from repro_torch.core import entropy as t_entropy
from repro_torch.core import fp8 as t_fp8
from repro_torch.core import wire as t_wire
from repro_torch.core.engine import WireLink, _codec_transit
from repro_torch.kernels import ref
from repro_torch.kernels.ref import LANES, RANS_L as L, TAB, buf_cols, n_steps

GRIDS = [t_fp8.E4M3, t_fp8.E5M2, t_fp8.FP4_E2M1, t_fp8.FP4_E3M0]
TABLES = [(f, s) for f in GRIDS for s in (t_entropy.SIGMA_PLAIN, t_entropy.SIGMA_DELTA)]
TABLE_IDS = [f"e{f.exp}m{f.mant}-{s}" for f, s in TABLES]
F_ALL = np.arange(1, TAB - 255 + 1, dtype=np.int64)   # every frequency a table can hold


def _table(fmt, sigma):
    return tuple(torch.from_numpy(a) for a in t_entropy.byte_table(fmt, sigma))


def _enc_fields(freq, cum):
    t = ref.rans_enc_table(torch.as_tensor(freq), torch.as_tensor(cum)).numpy().astype(np.int64)
    w1 = t[:, 1]
    return t[:, 0] & 0xFFFFFFFF, w1 & 0x1FFF, (w1 >> 13) & 0xFFF, w1 >> 25


def _enc_step(x, rcp, bias, cmpl, shift):
    """The kernel's coding step in u32: x + bias + (mulhi(x, rcp) >> shift) * cmpl."""
    q = ((x * rcp) >> 32) >> shift
    return (x + bias + q * cmpl) & 0xFFFFFFFF


@pytest.mark.parametrize("fmt,sigma", TABLES, ids=TABLE_IDS)
def test_packed_decode_table_unpacks_to_the_twins_table(fmt, sigma):
    freq, cum, s2s = _table(fmt, sigma)
    e = ref.rans_dec_table(freq, cum, s2s)
    assert e.shape == (TAB,) and int(e.min()) >= 0 and int(e.max()) < 2 ** 32
    sym = e >> 24
    slot = torch.arange(TAB)
    assert torch.equal(sym, s2s.long())
    assert torch.equal(e & 0xFFF, freq.long()[sym])
    assert torch.equal((e >> 12) & 0xFFF, slot - cum.long()[sym])
    # a decode step from the packed entry is the twin's
    x = torch.from_numpy(np.random.RandomState(0).randint(L, 2 ** 31, 50000)).long()
    ex = e[x & (TAB - 1)]
    got = (ex & 0xFFF) * (x >> 12) + ((ex >> 12) & 0xFFF)
    s = s2s.long()[x & (TAB - 1)]
    assert torch.equal(got, freq.long()[s] * (x >> 12) + (x & (TAB - 1)) - cum.long()[s])


@pytest.mark.parametrize("states", ["L", "L+1", "f<<19 - 1", "2^31 - 1", "random"])
def test_reciprocal_step_is_the_division_for_every_frequency(states):
    """Every f in 1..3841 (cum 0 and a real cum): the quotient
    ``mulhi(x, rcp) >> shift`` is ``x // f`` (``x - 1`` for f == 1, whose bias
    takes the difference) and the step is ``((x // f) << 12) + x % f + cum``
    for the states the coder reaches, below ``f << 19``."""
    rng = np.random.RandomState(3)
    x = {"L": np.full_like(F_ALL, L), "L+1": np.full_like(F_ALL, L + 1),
         "f<<19 - 1": (F_ALL << 19) - 1, "2^31 - 1": np.full_like(F_ALL, 2 ** 31 - 1),
         "random": rng.randint(1, 2 ** 31, (64, F_ALL.size)).astype(np.int64)}[states]
    for cum in (np.zeros_like(F_ALL), rng.randint(0, TAB - F_ALL + 1)):
        rcp, bias, cmpl, shift = _enc_fields(F_ALL, cum)
        assert (cmpl == TAB - F_ALL).all() and (rcp < 2 ** 32).all()
        q = ((x * rcp) >> 32) >> shift
        np.testing.assert_array_equal(q, np.where(F_ALL == 1, x - 1, x // F_ALL))
        reach = x < (F_ALL << 19)           # after the renorm, x < f << 19
        got = _enc_step(x, rcp, bias, cmpl, shift)
        want = ((x // F_ALL) << 12) + x % F_ALL + cum
        np.testing.assert_array_equal(np.where(reach, got, 0), np.where(reach, want, 0))
        assert reach.any() or states == "2^31 - 1"    # above every f << 19: quotient only


def _decode_seq(x, b0, b1):
    """The reference's two renorm steps: (state, bytes read)."""
    n = np.zeros_like(x)
    for b in (b0, b1):
        need = x < L
        x = np.where(need, (x << 8) | b, x)
        n += need
    return x, n


def _decode_one(x, b0, b1):
    """The kernel's: n = (x < 2^23) + (x < 2^15), one select among 0, 1, 2 bytes."""
    one, two = x < L, x < (1 << 15)
    x = np.where(two, (x << 16) | (b0 << 8) | b1, np.where(one, (x << 8) | b0, x))
    return x, one.astype(np.int64) + two


@pytest.mark.parametrize("part", range(4))
def test_one_decision_decode_renorm_equals_two_steps(part):
    """Every decoded state in [2^11, 2^23) (a quarter a case) with random
    bytes, and random states above (no byte read)."""
    lo, hi = 1 << 11, 1 << 23
    step = (hi - lo) // 4
    x = np.arange(lo + part * step, hi if part == 3 else lo + (part + 1) * step, dtype=np.int64)
    rng = np.random.RandomState(part)
    x = np.concatenate([x, rng.randint(hi, 2 ** 31, 100000).astype(np.int64)])
    b0, b1 = rng.randint(0, 256, x.size), rng.randint(0, 256, x.size)
    xs, ns = _decode_seq(x, b0, b1)
    xo, no = _decode_one(x, b0, b1)
    np.testing.assert_array_equal(xo, xs)
    np.testing.assert_array_equal(no, ns)
    assert (xo >= L).all() and (xo < 2 ** 31).all()


def test_one_decision_encode_renorm_equals_two_steps():
    """Every f, at the emit thresholds (f << 19 and f << 27, one either side)
    and random states in [L, 2^31): the bytes out, their count and the state
    after, as the two sequential steps give them."""
    rng = np.random.RandomState(7)
    f = np.repeat(F_ALL, 40)
    edges = np.stack([(F_ALL << 19) - 1, F_ALL << 19, (F_ALL << 27) - 1, F_ALL << 27], 1)
    x = np.concatenate([rng.randint(L, 2 ** 31, (F_ALL.size, 36)), edges], 1).reshape(-1)
    keep = (x >= L) & (x < 2 ** 31)
    x, f = x[keep], f[keep]
    thresh = f << 19
    xs, out, ns = x.copy(), np.zeros_like(x), np.zeros_like(x)
    for _ in range(2):
        emit = xs >= thresh
        out |= np.where(emit, (xs & 0xFF) << (8 * ns), 0)
        xs = np.where(emit, xs >> 8, xs)
        ns += emit
    one, two = x >= thresh, (x >> 8) >= thresh
    np.testing.assert_array_equal(np.where(two, x & 0xFFFF, np.where(one, x & 0xFF, 0)), out)
    np.testing.assert_array_equal(one.astype(np.int64) + two, ns)
    np.testing.assert_array_equal(np.where(two, x >> 16, np.where(one, x >> 8, x)), xs)
    assert two.any() and (one & ~two).any() and (~one).any()


# --- the kernels' data layout, replayed at phases of a few rows ----------

ROWS = 8


def _window_words(prev, rows):
    """``rans.cu::window_words``."""
    return (2 * (prev + rows) + 2 + 3) // 4 + 1


def _kernel_decode(buf, state, lens, n, freq, cum, s2s, rows=ROWS):
    """``rans_decode_kernel`` lane by lane, at phases of ``rows`` rows: each
    lane's bytes staged in the order it consumes them (byte i of a window
    anchored at consumption index a is the row's byte at ``clip(lens - 1 - a
    - i, 0, cols - 1)``), the window of phase k + 1 anchored where phase k
    began and ``window_words`` long; a row reads the two bytes at its index
    and takes 0, 1 or 2 of them. Asserts every read lies in the staged
    words."""
    b = buf.numpy().astype(np.int64)
    cols, steps = b.shape[1], n_steps(n)
    tab = ref.rans_dec_table(freq, cum, s2s).numpy()
    out = np.zeros((steps, LANES), np.int64)
    phases = -(-steps // rows)
    rows_of = [min(rows, steps - k * rows) for k in range(phases)]
    for lane in range(LANES):
        row, ln = b[lane], int(lens[lane])

        def stage(a, words):
            return row[np.clip(ln - 1 - a - np.arange(4 * words), 0, cols - 1)]

        x, anchor, kk = int(state[lane]), 0, 0
        win = stage(0, _window_words(0, rows_of[0]))
        for k in range(phases):
            start = anchor + kk
            nxt = stage(start, _window_words(rows_of[k], rows_of[k + 1])) \
                if k + 1 < phases else None
            for t in range(k * rows, k * rows + rows_of[k]):
                e = int(tab[x & (TAB - 1)])
                assert kk + 1 < win.size, (lane, t, kk, win.size)
                b0, b1 = int(win[kk]), int(win[kk + 1])
                x = (e & 0xFFF) * (x >> 12) + ((e >> 12) & 0xFFF)
                one, two = x < L, x < (1 << 15)
                x = (x << 16) | (b0 << 8) | b1 if two else ((x << 8) | b0 if one else x)
                kk += int(one) + int(two)
                out[t, lane] = e >> 24
            kk, anchor, win = anchor + kk - start, start, nxt
    return torch.from_numpy(out.reshape(-1)[:n].astype(np.uint8))


def _kernel_encode(syms, freq, cum, rows=ROWS):
    """``rans_encode_kernel`` lane by lane, at phases of ``rows`` rows from
    the last row down: each row's table entry (``ref.rans_enc_table``), the
    one-decision emit packed as ``out | n << 16``, the division-free step;
    after each phase the emitted bytes appended to the lane's stream in
    coding order."""
    n = syms.numel()
    cols, steps = buf_cols(n), n_steps(n)
    sym_rows = np.zeros(steps * LANES, np.int64)
    sym_rows[:n] = syms.numpy()
    sym_rows = sym_rows.reshape(steps, LANES)
    rcp, bias, cmpl, shift = _enc_fields(freq, cum)
    buf = np.zeros((LANES, cols), np.uint8)
    state, lens = np.zeros(LANES, np.int64), np.zeros(LANES, np.int64)
    for lane in range(LANES):
        x, pos = L, 0
        for k in range(-(-steps // rows)):
            emit = []
            for t in range(steps - 1 - k * rows, max(-1, steps - 1 - (k + 1) * rows), -1):
                s = sym_rows[t, lane]
                thresh = int(TAB - cmpl[s]) << 19
                one, two = x >= thresh, (x >> 8) >= thresh
                emit.append((x & 0xFFFF) | 2 << 16 if two else ((x & 0xFF) | 1 << 16 if one
                                                                 else 0))
                x = x >> 16 if two else (x >> 8 if one else x)
                x = int(_enc_step(np.int64(x), rcp[s], bias[s], cmpl[s], shift[s]))
            for v in emit:
                for i in range(v >> 16):
                    buf[lane, pos] = (v >> (8 * i)) & 0xFF
                    pos += 1
        state[lane], lens[lane] = x, pos
    return (torch.from_numpy(buf), torch.from_numpy(state.astype(np.int32)),
            torch.from_numpy(lens.astype(np.int32)))


def _stream(kind, n, s2s, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randint(0, 256, (n,), generator=g).to(torch.uint8)
    if kind == "peaked":
        return s2s[torch.randint(0, TAB, (n,), generator=g)].to(torch.uint8)
    return torch.full((n,), 255, dtype=torch.uint8)     # the table's least likely end


STREAMS = [("random", 1), ("random", 17), ("peaked", 300), ("peaked", 2113),
           ("improbable", 260), ("random", 1500)]


@pytest.mark.parametrize("rows", [1, 3, 8, 64])
@pytest.mark.parametrize("kind,n", STREAMS, ids=[f"{k}-{n}" for k, n in STREAMS])
def test_kernel_layout_replay_equals_the_twins(kind, n, rows):
    """The encode's entries, emits and appends, and the decode's staged
    windows, at phases of ``rows`` rows, give the twins' buffers, states,
    lengths and symbols."""
    freq, cum, s2s = _table(t_fp8.E4M3, 0.28)
    syms = _stream(kind, n, s2s, n)
    want = ref.rans_encode(syms, freq, cum)
    got = _kernel_encode(syms, freq, cum, rows)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    buf, state, lens = want
    out = _kernel_decode(buf, state, lens, n, freq, cum, s2s, rows)
    assert torch.equal(out, syms)
    assert torch.equal(out, ref.rans_decode(buf, state, lens, n, freq, cum, s2s))


@pytest.mark.parametrize("corrupt", ["short lens", "long lens", "bytes", "zero lens"])
def test_kernel_window_replay_reads_clipped_positions_as_the_twin(corrupt):
    """Corrupted payloads, so lanes read past their first byte (clipped to
    column 0) or start past their last column (clipped to cols - 1): the
    staged windows give the twin's symbols."""
    freq, cum, s2s = _table(t_fp8.FP4_E2M1, 0.14)
    n = 700
    syms = _stream("peaked", n, s2s, 1)
    buf, state, lens = ref.rans_encode(syms, freq, cum)
    cols, rng = buf.shape[1], np.random.RandomState(2)
    if corrupt == "short lens":
        lens = torch.clamp(lens - torch.arange(LANES, dtype=torch.int32) * 3, min=0)
    elif corrupt == "long lens":
        lens = lens + torch.arange(LANES, dtype=torch.int32) * 7
    elif corrupt == "bytes":
        buf = buf.clone()
        buf[:, ::5] = torch.from_numpy(rng.randint(0, 256, buf[:, ::5].shape).astype(np.uint8))
    else:
        lens = torch.zeros_like(lens)
    if corrupt == "long lens":
        assert int(lens.max()) > cols
    want = ref.rans_decode(buf, state, lens, n, freq, cum, s2s)
    assert torch.equal(_kernel_decode(buf, state, lens, n, freq, cum, s2s), want)
    assert not torch.equal(want, syms)


# --- the cohort transit ---------------------------------------------------


def _clients(P=3, seed=0):
    """The MLP's reference init weights and P clients moved from it by numpy
    noise (port trees), with the reference's key words."""
    rp = r_small.init_mlp(jax.random.PRNGKey(seed), d_in=64, n_classes=10)
    rng = np.random.RandomState(1)
    clients = [convert.from_jax_params(jax.tree.map(lambda a: np.asarray(a) + np.asarray(
        rng.randn(*a.shape), np.float32) * np.float32(0.02), rp), "cpu") for _ in range(P)]
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(9), P))
    return rp, clients, torch.from_numpy(keys[:, :2].astype(np.int64)).to(torch.uint32)


def _same_tree(a, b):
    fa, fb = dict(tree.flatten(a)), dict(tree.flatten(b))
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _same_payload(a, b):
    assert torch.equal(a["codes"], b["codes"])
    for x, y in zip(a["rans"], b["rans"]):
        assert torch.equal(x, y)
    for x, y in zip(jax.tree.leaves(a["other"]), jax.tree.leaves(b["other"])):
        assert torch.equal(x, y)


@pytest.mark.parametrize("codec", ["rans:e4m3", "rans:delta:fp4_e2m1", "ef:rans:fp4_e2m1_det"])
def test_cohort_transit_equals_the_per_client_path_and_the_reference(codec):
    """Three clients through the uplink's cohort transit (``WireLink.up``, or
    ``ErrorFeedbackCodec.up_transit``): messages, residual rows, payloads
    and traced bytes bitwise those of the rANS codec's own ``encode`` /
    ``decode`` one client at a time, and each payload the reference's
    ``rans_encode`` of the same code stream (its decode gives the stream
    back). The stochastic grid codes themselves are compared with the
    reference by ``tests/test_torch_ef.py`` and ``tests/test_torch_pareto.py``."""
    rp, t_clients, k_words = _clients()
    spec = t_wire.make_wire_spec(t_clients[0])
    c = t_codec.get_codec(codec)
    ref_model = convert.from_jax_params(jax.tree.map(np.asarray, rp), "cpu")
    if codec.startswith("ef:"):
        rc = c.inner
        e = torch.from_numpy(np.random.RandomState(4).randn(3, spec.total).astype(np.float32)
                             * 0.01)
        msgs, new_e, payloads = c.up_transit(list(t_clients), spec, k_words, e)
        inner = []
        for i, (p, k) in enumerate(zip(t_clients, k_words)):
            comp = t_ef.add_resid(p, e[i], spec)
            pl = rc.encode(comp, spec, k)
            dec = rc.decode(pl, spec)
            _same_payload(payloads[i], pl)
            _same_tree(msgs[i], dec)
            assert torch.equal(new_e[i], t_ef.flatten_q(comp, spec) - t_ef.flatten_q(dec, spec))
            inner.append(rc.inner.encode(comp, spec, k)["codes"])
        nbytes = [c.payload_nbytes_traced(pl, spec) for pl in payloads]
    else:
        rc = c
        msgs, nbytes = WireLink(up_codec=codec).up(list(t_clients), spec, k_words,
                                                   ref=ref_model)
        payloads, inner = [], []
        for i, (p, k) in enumerate(zip(t_clients, k_words)):
            pl = c.encode(p, spec, k, ref=ref_model)
            m, nb = _codec_transit(c, p, spec, k, ref=ref_model)
            _same_tree(msgs[i], m)
            assert int(nbytes[i]) == int(nb)
            payloads.append(pl)
            inner.append(c.inner.encode(p, spec, k, ref=ref_model)["codes"])
    jf, jc, js = (jnp.asarray(t.numpy()) for t in rc.table("cpu"))
    for i, codes in enumerate(inner):
        r_buf, r_state, r_lens = r_rans.rans_encode(jnp.asarray(codes.numpy(), jnp.int32), jf, jc)
        np.testing.assert_array_equal(payloads[i]["codes"].numpy(), np.asarray(r_buf).reshape(-1))
        np.testing.assert_array_equal(payloads[i]["rans"][0].numpy(), np.asarray(r_state))
        np.testing.assert_array_equal(payloads[i]["rans"][1].numpy(), np.asarray(r_lens))
        np.testing.assert_array_equal(np.asarray(r_rans.rans_decode_jnp(
            r_buf, r_state, r_lens, codes.numel(), jf, jc, js)), codes.numpy())
        assert int(nbytes[i]) == int(np.asarray(r_lens).sum()) + (
            c.payload_nbytes(spec) - rc.code_nbytes(spec))
    assert all(0 < int(nb) <= c.payload_nbytes(spec) for nb in nbytes)


def test_cohort_wrappers_take_the_twins_on_cpu_without_counting():
    from repro_torch.kernels import dispatch, fp8_quant

    freq, cum, s2s = _table(t_fp8.E4M3, 0.28)
    syms = torch.stack([_stream("peaked", 333, s2s, s) for s in range(4)])
    fp8_quant.reset_launches()
    buf, state, lens = dispatch.rans_encode_many(syms, freq, cum)
    assert buf.shape == (4, LANES, buf_cols(333)) and state.shape == lens.shape == (4, LANES)
    for i in range(4):
        for a, b in zip((buf[i], state[i], lens[i]), ref.rans_encode(syms[i], freq, cum)):
            assert torch.equal(a, b)
    assert torch.equal(dispatch.rans_decode_many(buf, state, lens, 333, freq, cum, s2s), syms)
    assert fp8_quant.LAUNCHES["rans_encode"] == fp8_quant.LAUNCHES["rans_decode"] == 0
