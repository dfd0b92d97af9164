"""The port's dense LM path (configs, LM token data, ``models.common``,
``models.attention``, ``models.transformer``, a federated LM round and the
``bench.fed_lm`` driver) against the live JAX reference on reduced
TinyLlama, weights carried across by ``convert.from_jax_params``.

The reference runs its kernel path (``REPRO_KERNEL_BACKEND=interpret``):
there every QAT projection is the fused B10/B11 Pallas kernels, which the
port mirrors. Its default backend on this CPU (jnp) takes the ``aq``/``wq``
chain and a bf16 matmul instead, another function.

Tolerances, and the mechanism behind each:

* configs, token streams, wire bytes: exact.
* ``rms_norm``, ``rope``, ``flash_attention`` on bf16 inputs: one bf16
  ULP of the output (at most 2^-7 of its magnitude): both compute in f32
  and round once, but XLA's and torch's rsqrt / exp / sin / cos and the
  attention sums differ in the last f32 bits, which can move a bf16
  rounding. ``silu``: two ULPs, since XLA's bf16 logistic rounds otherwise
  than torch's sigmoid (705 of 2048 values one ULP apart at this seed).
* ``dense`` (fused path, bf16 activations): out and gx within one bf16
  ULP, gw within 1e-5 of its magnitude sum, the LSQ-scaled clip
  gradients within 1e-5 of their terms' magnitude sum (the B10/B11
  parity bounds of ``test_torch_qat_matmul``).
* the whole model in f32 without QAT (both packages' ``COMPUTE_DTYPE``
  patched to f32 for the test): the algorithm alone, loss to 1e-6 and every
  gradient to 1e-5 of its magnitude sum.
* the whole model as shipped (bf16, QAT on): FP8 activation codes sit on a
  grid 2^-4 apart, and bf16 carries 2^-8: XLA's bf16 logistic in
  ``silu(g) * u`` rounds otherwise than torch's sigmoid, and XLA:CPU may
  compute a fused chain of bf16 elementwise ops in f32 and round once
  where torch rounds after every op. Where
  that lands an activation on the other side of an FP8 midpoint its whole
  token row moves by a grid step, and the flips spread through the
  backward. Measured at this seed: loss 3.1e-4 relative; hidden states
  6.3e-2 of their magnitude sum; weight, norm and embedding gradients
  0.025-0.14 of their magnitude sum; clip gradients (LSQ-scaled sums that
  nearly cancel) up to 0.13 of the largest clip gradient. Bars: 2e-3, 0.1,
  0.25 and 0.25. In f32 (no bf16 rounding) the same flips remain, rarer:
  a few token rows a layer, and the gradients still 1-3% apart. Bars this
  wide cannot tell a small clip's gradient from a misrouted one, so a
  second, tie-free check holds the model's wiring exactly: every
  projection's weight, clip values (set apart per layer and site) and x
  size, call by call, against the reference's.
* one federated round (E4M3 stochastic wire, weighted mean, AdamW(1e-3),
  U = 2): AdamW moves every element by about lr a step whatever its
  gradient's size, so gradient noise becomes steps of lr either way, and a
  client weight that moves takes the other stochastic-rounding decision on
  the uplink: every quantized weight within one top-bin grid step (alpha /
  15) plus 4 lr U of the reference (measured 0.98 of a step), every other
  leaf within 4 lr U (measured 0.43 of it), the loss within 2e-3.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.common as r_common
import repro.models.transformer as r_tr
from repro import configs as r_configs
from repro import optim as r_optim
from repro.core import metrics as r_metrics
from repro.core.engine import FedConfig as RFed
from repro.core.engine import RoundEngine as REngine
from repro.core.qat import DISABLED as R_DISABLED
from repro.core.qat import QATConfig as RQAT
from repro.data.synthetic import synthetic_lm_tokens as r_tokens
from repro.models import attention as r_attn
from repro.models.registry import get_model as r_get_model
from repro_torch import configs as t_configs
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.bench import fed_lm
from repro_torch.core import engine as t_engine
from repro_torch.core import wire as t_wire
from repro_torch.core.fp8 import E4M3
from repro_torch.core.qat import DISABLED as T_DISABLED
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.data import synthetic_lm_tokens as t_tokens
from repro_torch.kernels import ref
from repro_torch.models import attention as t_attn
from repro_torch.models import common as t_common
from repro_torch.models import registry as t_registry
from repro_torch.models import transformer as t_tr
from test_torch_grid import reference_draws
from test_torch_qat_matmul import _clip_terms

ARCH = "tinyllama_1_1b"
REDUCED_LEG_BYTES = 145296          # metrics.payload_bytes, E4M3 wire, reduced
FULL_LEG_BYTES = 1100325844         # the same at full width
FULL_PARAMS = 1100048629
BF16_ULP = 2.0 ** -7          # a bf16 ULP, relative to the value, at most


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")


def _cfgs():
    return r_configs.reduced(r_configs.get(ARCH)), t_configs.reduced(t_configs.get(ARCH))


def _model_pair():
    rcfg, tcfg = _cfgs()
    rp = r_get_model(rcfg).init(jax.random.PRNGKey(0))
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    return rcfg, tcfg, rp, tp


def _batch(vocab, seed=0, b=4, t=64):
    s = r_tokens(seed, b * (t + 1), vocab).reshape(b, t + 1)
    return s[:, :-1], s[:, 1:]


def _np(t) -> np.ndarray:
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor) else
                      np.asarray(t, np.float32), np.float64)


def _rel_sum(port, ref_) -> float:
    p, r = _np(port), _np(ref_)
    return float(np.abs(p - r).sum() / max(np.abs(r).sum(), 1e-30))


def _port_grads(tp, loss_fn):
    names = [n for n, _ in tree.flatten(tp)]
    leaves = [t.detach().clone().requires_grad_() for t in tree.leaves(tp)]
    loss = loss_fn(tree.unflatten(names, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), dict(zip(names, grads))


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True])
def test_configs_equal_the_reference_field_for_field(reduced):
    r, t = r_configs.get(ARCH), t_configs.get(ARCH)
    if reduced:
        r, t = r_configs.reduced(r), t_configs.reduced(t)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(r, f.name), f.name
    assert t.hd == r.hd
    # the reference fields the port leaves out hold the values it implements
    assert r.window == 0 and not r.tie_embeddings and r.attention == "full"
    assert t_configs.get("tinyllama-1-1b") == t_configs.get(ARCH)


def test_unported_architectures_and_families_raise():
    assert t_configs.ARCH_IDS == [ARCH]
    for name in r_configs.ARCH_IDS[1:]:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_configs.get(name)
    with pytest.raises(ValueError, match="unknown architecture"):
        t_configs.get("gpt5")
    moe = t_configs.get(ARCH).replace(family="moe")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_configs.reduced(moe)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t_registry.get_model(moe)


@pytest.mark.parametrize("seed,vocab", [(0, 256), (3, 32000), (7, 100)])
def test_lm_tokens_match_draw_for_draw(seed, vocab):
    np.testing.assert_array_equal(t_tokens(seed, 5000, vocab), r_tokens(seed, 5000, vocab))


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _bf16(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _within_bf16_ulp(port, ref_):
    p, r = _np(port), _np(ref_)
    assert np.all(np.abs(p - r) <= BF16_ULP * np.abs(r) + 1e-6), np.abs(p - r).max()


def test_rms_norm_rope_and_flash_attention_match():
    jx, tx = _bf16((2, 16, 64), 0, 3.0)
    scale = np.random.default_rng(1).normal(size=64).astype(np.float32)
    _within_bf16_ulp(t_common.rms_norm(tx, torch.from_numpy(scale), 1e-6),
                       jax.jit(r_common.rms_norm)(jx, jnp.asarray(scale)))

    jq, tq = _bf16((2, 64, 4, 16), 2)
    pos = np.broadcast_to(np.arange(64)[None], (2, 64))
    _within_bf16_ulp(t_common.rope(tq, torch.from_numpy(pos.copy()), 10000.0),
                       jax.jit(r_common.rope)(jq, jnp.asarray(pos)))

    jk, tk = _bf16((2, 64, 2, 16), 3)
    jv, tv = _bf16((2, 64, 2, 16), 4)
    # attn_chunk 32 at 64 keys: two KV chunks of the online softmax, GQA 4 / 2
    out = t_attn.flash_attention(tq, tk, tv, chunk=32)
    want = jax.jit(lambda q, k, v: r_attn.flash_attention(q, k, v, causal=True,
                                                          chunk=32))(jq, jk, jv)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 64, 4, 16)
    _within_bf16_ulp(out, want)
    # silu: XLA's bf16 logistic is not torch's (a third of the sigmoids differ
    # by a bf16 ULP), so the product may sit two ULPs of its own away
    p, r = _np(t_common.activation(tx, "silu")), _np(
        jax.jit(lambda a: r_common.activation(a, "silu"))(jx))
    assert np.all(np.abs(p - r) <= 2 * BF16_ULP * np.abs(r) + 1e-6)


def test_dense_and_its_lsq_clip_gradients_match():
    """One fused projection with bf16 activations (B, T, D), the per-layer
    (1, 1) weight clip and scalar activation clip: output and all four
    gradients against the reference's VJP."""
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(2, 16, 64)) * 2).astype(np.float32)
    w = (rng.normal(size=(64, 48)) / 8).astype(np.float32)
    p = {"w": w, "w_qa": np.abs(w).max().reshape(1, 1), "x_qb": np.float32(3.0)}
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    rout, vjp = jax.vjp(lambda pp, xx: r_common.dense(pp, "w", xx, RQAT(), "x_qb"),
                        jax.tree.map(jnp.asarray, p), jx)
    g = (np.abs(rng.normal(size=rout.shape)) * np.sign(np.asarray(rout, np.float32)))
    jg = jnp.asarray(g.astype(np.float32)).astype(jnp.bfloat16)
    rgp, rgx = vjp(jg)

    tp = {k: torch.tensor(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(torch.bfloat16)
    tx.requires_grad_()
    out = t_common.dense(tp, "w", tx, TQAT(), "x_qb")
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 48)
    out.backward(torch.from_numpy(np.array(jg.astype(jnp.float32))).to(torch.bfloat16))
    _within_bf16_ulp(out, rout)
    _within_bf16_ulp(tx.grad, rgx)
    x32 = np.asarray(jx.astype(jnp.float32)).reshape(-1, 64)
    g32 = np.asarray(jg.astype(jnp.float32), np.float64).reshape(-1, 48)
    xq = ref.quant_det(torch.from_numpy(x32), torch.tensor(3.0)).double().numpy()
    wq = ref.quant_det(torch.from_numpy(w), torch.tensor(p["w_qa"])).double().numpy()
    mag = np.abs(xq).T @ np.abs(g32)
    assert np.all(np.abs(_np(tp["w"].grad) - _np(rgp["w"])) <= 1e-5 * mag + 1e-12)
    # the LSQ scale g = 1 / sqrt(N Q_max), N the elements of the un-reshaped x / w
    lsq_x = 1.0 / np.sqrt(x.size * 15)
    lsq_w = 1.0 / np.sqrt(w.size * 15)
    gb_bound = 1e-5 * lsq_x * _clip_terms(g32 @ wq.T, x32, 3.0, E4M3)
    ga_bound = 1e-5 * lsq_w * _clip_terms(xq.T @ g32, w, p["w_qa"], E4M3)
    assert tp["x_qb"].grad.shape == () and tp["w_qa"].grad.shape == (1, 1)
    assert abs(float(tp["x_qb"].grad) - float(rgp["x_qb"])) <= gb_bound
    assert abs(float(tp["w_qa"].grad[0, 0]) - float(rgp["w_qa"][0, 0])) <= ga_bound
    assert float(tp["x_qb"].grad) != 0.0 and float(tp["w_qa"].grad) != 0.0


def test_dense_takes_the_kernels_only_where_the_reference_does():
    x = torch.zeros(2, 3, 8)
    p = {"w": torch.zeros(8, 4), "w_qa": torch.ones(1, 1), "x_qb": torch.ones(())}
    assert t_common._fused_dense_ok(p, "w", x, TQAT(), "x_qb")
    assert not t_common._fused_dense_ok(p, "w", x, TQAT(), None)
    assert not t_common._fused_dense_ok(p, "w", x, TQAT(quantize_acts=False), "x_qb")
    assert not t_common._fused_dense_ok(p, "w", x, TQAT(mode="rand"), "x_qb")
    assert not t_common._fused_dense_ok(p, "w", x, T_DISABLED, "x_qb")
    stacked = dict(p, w_qa=torch.ones(3, 1, 1))
    assert not t_common._fused_dense_ok(stacked, "w", x, TQAT(), "x_qb")


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------


def test_init_lays_out_the_reference_tree():
    rcfg, tcfg = _cfgs()
    rshapes = jax.eval_shape(r_get_model(rcfg).init, jax.random.PRNGKey(0))
    tp = t_registry.get_model(tcfg).init(0, device="cpu")
    r_flat = dict(tree.flatten(jax.tree.map(lambda s: s.shape, rshapes)))
    t_flat = dict(tree.flatten(tp))
    assert list(r_flat) == list(t_flat)
    for name, leaf in t_flat.items():
        assert tuple(leaf.shape) == tuple(r_flat[name]), name
        assert leaf.dtype == torch.float32
    assert sum(v.numel() for v in t_flat.values()) == 143844
    # alpha = max|w| per layer; clips at 4.0
    blocks = tp["blocks"]
    torch.testing.assert_close(blocks["wq_qa"].reshape(-1),
                               blocks["wq"].abs().amax(dim=(1, 2)))
    assert torch.all(blocks["attn_qb"] == 4.0) and float(tp["head_qb"]) == 4.0


def test_model_in_f32_without_qat_is_the_reference_function(monkeypatch):
    """Both packages' COMPUTE_DTYPE patched to f32 and QAT off: the norms,
    RoPE, attention, residual stream, embedding and chunked CE alone."""
    for mod in (r_common, r_tr):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", jnp.float32)
    for mod in (t_common, t_tr):
        monkeypatch.setattr(mod, "COMPUTE_DTYPE", torch.float32)
    rcfg, tcfg, rp, tp = _model_pair()
    x, y = _batch(rcfg.vocab)
    batch_r = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    rh = jax.jit(lambda p: r_tr.forward_hidden(p, batch_r["tokens"], rcfg, R_DISABLED))(rp)
    th = t_tr.forward_hidden(tp, torch.from_numpy(x), tcfg, T_DISABLED)
    assert _rel_sum(th, rh) <= 1e-5
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: r_tr.train_loss(p, batch_r, rcfg, R_DISABLED)))(rp)
    tl, tg = _port_grads(tp, lambda p: t_tr.train_loss(
        p, {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}, tcfg, T_DISABLED))
    assert abs(tl - float(rl)) <= 1e-6 * abs(float(rl))
    for name, r in tree.flatten(jax.tree.map(np.asarray, rg)):
        if tg[name] is None:    # leaves no op reads: the clips, with QAT off
            assert not np.any(r), name
            continue
        assert _rel_sum(tg[name], r) <= 1e-5, name


def test_model_as_shipped_matches_within_the_fp8_tie_mechanism():
    rcfg, tcfg, rp, tp = _model_pair()
    x, y = _batch(rcfg.vocab)
    batch_r = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    rh = jax.jit(lambda p: r_tr.forward_hidden(p, batch_r["tokens"], rcfg, RQAT()))(rp)
    th = t_tr.forward_hidden(tp, torch.from_numpy(x), tcfg, TQAT())
    assert th.dtype == torch.bfloat16 and _rel_sum(th, rh) <= 0.1
    rl, rg = jax.jit(jax.value_and_grad(
        lambda p: r_tr.train_loss(p, batch_r, rcfg, RQAT())))(rp)
    tl, tg = _port_grads(tp, lambda p: t_registry.get_model(tcfg).train_loss(
        p, {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}, TQAT()))
    assert abs(tl - float(rl)) <= 2e-3 * abs(float(rl))
    rflat = dict(tree.flatten(jax.tree.map(np.asarray, rg)))
    clip_scale = max(np.abs(v).max() for n, v in rflat.items() if n.endswith(("_qa", "_qb")))
    for name, r in rflat.items():
        g = tg[name]
        if name == "embed_qa":      # the embedding is a gather, never quantized
            assert g is None and not np.any(r)
        elif name.endswith(("_qa", "_qb")):
            assert np.abs(_np(g) - r).max() <= 0.25 * clip_scale, name
        else:
            assert _rel_sum(g, r) <= 0.25, name


def _recording(mod, calls, concrete):
    """``mod.dense`` wrapped to record each call's wiring: the weight, its
    activation clip's key, x's and w's shapes (the LSQ scales' element
    counts), whether the fused path is taken, and the clip values used."""
    orig = mod.dense

    def dense(p, name, x, qcfg, act_site=None):
        static = (name, act_site, tuple(x.shape), tuple(p[name].shape),
                  mod._fused_dense_ok(p, name, x, qcfg, act_site))
        concrete(lambda b, a: calls.append(static + (float(b), float(a))),
                 p[act_site].reshape(()), p[name + "_qa"].reshape(()))
        return orig(p, name, x, qcfg, act_site)
    return dense


def test_model_as_shipped_wires_every_clip_as_the_reference(monkeypatch):
    """The tie-free half of the shipped-model check: with every activation
    clip set apart (per layer and site) and QAT on, each projection of the
    forward and the CE head reads the same weight, the same clip values and
    the same x size as the reference's, in the same order. A wrong
    act_site, layer slice or LSQ element count fails here exactly, where
    the gradient bars above cannot see it."""
    rcfg, tcfg, rp, _ = _model_pair()
    rng = np.random.default_rng(9)
    rp = {k: v for k, v in rp.items()}
    rp["blocks"] = dict(rp["blocks"])
    for k in [k for k in rp["blocks"] if k.endswith("_qb")]:
        rp["blocks"][k] = jnp.asarray(rng.uniform(2, 6, rp["blocks"][k].shape), jnp.float32)
    rp["head_qb"] = jnp.asarray(rng.uniform(2, 6, np.shape(rp["head_qb"])), jnp.float32)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    x, y = _batch(rcfg.vocab)
    r_calls, t_calls = [], []
    r_dense = _recording(r_common, r_calls, functools.partial(jax.debug.callback,
                                                              ordered=True))
    t_dense = _recording(t_common, t_calls, lambda fn, *a: fn(*a))
    for mod in (r_common, r_tr):
        monkeypatch.setattr(mod, "dense", r_dense)
    for mod in (t_common, t_tr):
        monkeypatch.setattr(mod, "dense", t_dense)
    batch_r = {"tokens": jnp.asarray(x), "labels": jnp.asarray(y)}
    jax.block_until_ready(jax.jit(lambda p: r_tr.train_loss(p, batch_r, rcfg, RQAT()))(rp))
    jax.effects_barrier()
    with torch.no_grad():
        t_registry.get_model(tcfg).train_loss(
            tp, {"tokens": torch.from_numpy(x), "labels": torch.from_numpy(y)}, TQAT())
    # 7 projections a layer, then the head once per CE chunk, all fused
    assert len(t_calls) == 7 * rcfg.n_layers + rcfg.ce_chunks
    assert all(c[4] for c in t_calls)
    assert t_calls == r_calls
    assert len({c[5] for c in t_calls}) == 4 * rcfg.n_layers + 1


# ---------------------------------------------------------------------------
# a federated round, the bytes, the driver
# ---------------------------------------------------------------------------


def test_lm_round_matches_the_reference_round():
    K, P, U, B = 4, 2, 2, 4
    lr = 1e-3
    rcfg, tcfg, rp, tp = _model_pair()
    xs, ys = fed_lm.client_data(K, U, 64, rcfg.vocab)
    rmodel, tmodel = r_get_model(rcfg), t_registry.get_model(tcfg)
    reng = REngine(lambda p, xb, yb, q, k: rmodel.train_loss(p, {"tokens": xb, "labels": yb}, q),
                   r_optim.adamw(lr, weight_decay=0.01),
                   RFed(n_clients=K, participation=P / K, local_steps=U, batch_size=B,
                        comm_mode="rand", qat=RQAT()))
    key = jax.random.PRNGKey(1)
    rstate, rm = jax.jit(reng.round_fn)(reng.init(rp), jnp.asarray(xs.numpy()),
                                        jnp.asarray(ys.numpy()), jnp.ones(K),
                                        jax.random.split(key)[1])
    teng = t_engine.RoundEngine(
        lambda p, xb, yb, q: tmodel.train_loss(p, {"tokens": xb, "labels": yb}, q),
        t_optim.adamw(lr, weight_decay=0.01),
        t_engine.FedConfig(n_clients=K, participation=P / K, local_steps=U, batch_size=B,
                           comm_mode="rand", qat=TQAT()), device="cpu")
    draws = reference_draws(key, 1, K, P, U, B, xs.shape[1])[0]
    tstate, tm = teng.round_fn(teng.init(tp), xs, ys, torch.ones(K), draws)
    assert tm["wire_bytes"] == int(rm["wire_bytes"]) == 2 * P * REDUCED_LEG_BYTES
    assert teng.round_bytes(tp) == 2 * P * REDUCED_LEG_BYTES
    assert abs(float(tm["local_loss"]) - float(rm["local_loss"])) <= \
        2e-3 * float(rm["local_loss"])
    rflat = dict(tree.flatten(jax.tree.map(np.asarray, rstate.params)))
    for name, v in tree.flatten(tstate.params):
        d = np.abs(_np(v) - rflat[name])
        qa = rflat.get(name + "_qa")
        if qa is not None and name != "embed_qa":
            assert d.max() <= float(np.max(qa)) / 15 + 4 * lr * U, name
        else:
            assert d.max() <= 4 * lr * U, name


@pytest.mark.parametrize("kind", ["plain", "ef", "scaled"])
def test_every_uplink_consumes_the_cohort_list(kind):
    """All three uplinks share one contract: the trained models leave the
    caller's list (the plain and scaled legs free each one once its payload
    is decoded, which a full-width round needs), and message i is client i's."""
    link = {"plain": t_engine.WireLink(),
            "ef": t_engine.WireLink(up_codec="ef:e4m3_det"),
            "scaled": t_engine.WireLink(up_scaling="delayed:4")}[kind]
    base = t_registry.get_model(t_configs.reduced(t_configs.get(ARCH))).init(0, device="cpu")
    spec = t_wire.make_wire_spec(base)
    P = 3
    clients = [tree.tree_map(lambda v, i=i: v * (i + 1), base) for i in range(P)]
    keys = t_engine._key_words(torch.Generator().manual_seed(0), P)
    if kind == "plain":
        msgs, nbytes = link.up(clients, spec, keys, ref=base)
        assert nbytes == [REDUCED_LEG_BYTES] * P
    elif kind == "ef":
        msgs, new_e, _ = link.up_ef(clients, spec, keys, torch.zeros(P, spec.total))
        assert new_e.shape == (P, spec.total)
    else:
        st = link.scales_init(base, spec)[1]
        msgs, amax = link.up_scaled(clients, spec, keys, st)
        assert amax.shape[0] == P
    assert clients == [] and len(msgs) == P
    for i, m in enumerate(msgs):
        ln = m["blocks"]["ln1"]     # unquantized: carried exactly
        assert torch.equal(ln, base["blocks"]["ln1"] * (i + 1))


def test_full_width_wire_bytes_from_shapes():
    """Full TinyLlama-1.1B, from shapes alone (no weights are made): the
    port's wire layout over the reference's init shapes gives the
    reference's byte integers."""
    rcfg = r_configs.get(ARCH)
    shapes = jax.eval_shape(r_get_model(rcfg).init, jax.random.PRNGKey(0))
    assert r_metrics.payload_bytes(shapes) == FULL_LEG_BYTES
    flat = tree.flatten(shapes)
    meta = tree.unflatten([n for n, _ in flat],
                          [torch.empty(s.shape, device="meta") for _, s in flat])
    spec = t_wire.make_wire_spec(meta)
    assert t_wire.payload_nbytes(spec) == FULL_LEG_BYTES
    assert spec.total + spec.n_other_elems == FULL_PARAMS
    cfg = t_engine.FedConfig(n_clients=8, participation=0.5, local_steps=8, batch_size=4)
    from repro_torch.core import metrics as t_metrics
    assert t_metrics.round_bytes_for(meta, cfg) == 4 * 2 * FULL_LEG_BYTES == 8802606752


def test_fed_lm_driver_at_a_tiny_scale():
    logs = []
    rows = fed_lm.run(reduced=True, rounds=2, clients=4, active=2, local_steps=1,
                      device="cpu", log=logs.append)
    assert [r["wire_bytes"] for r in rows] == [2 * 2 * REDUCED_LEG_BYTES] * 2
    assert all(np.isfinite(r["local_loss"]) for r in rows)
    assert "143844 parameters" in logs[0] and "e4m3 down / e4m3 up" in logs[0]
    with pytest.raises(NotImplementedError, match="only 'mean'"):
        fed_lm.run(reduced=True, rounds=1, server_opt="fedadam", device="cpu")
    assert fed_lm.codec_kw("delta:e4m3") == {"up_codec": "delta:e4m3"}
    assert fed_lm.codec_kw("fp4") == {"up_codec": "fp4", "down_codec": "fp4"}
    assert fed_lm.codec_kw("ef:fp4_e2m1_det") == {"up_codec": "ef:fp4_e2m1_det",
                                                  "down_codec": "fp4_e2m1_det"}


def test_fed_lm_driver_defaults_to_the_card():
    import inspect
    assert inspect.signature(fed_lm.run).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fed_lm.run(reduced=True, rounds=1)
