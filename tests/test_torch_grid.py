"""Whole federated rounds of the paper's method grid on the port against
the live JAX reference, and the port's Table 1 driver.

As in ``test_torch_fedsim``, :func:`reference_draws` replays the
reference's threefry key splits (``fedsim.py`` per round, ``engine.py:1487``
per stage, ``engine.py:391`` per local step, ``engine.py:733`` per uplink
client, ``wire.py:175-178`` for the wire key words) and hands the realized
numbers to the port, now with the UQ+ server's GD and grid key words
(``server_opt.py:131`` then ``_key_words``) and, for stochastic QAT, every
weight site's bits (``jax.random.bits(fold_in(k_q, site))``,
``models/small.py:42-49``) through the port's bits provider. The reference
runs jitted with its default jnp backend, except the ``rand-qat`` round,
which runs its kernel path (``REPRO_KERNEL_BACKEND=interpret``): its jnp
fallback draws other uniforms than the kernel path.

Tolerances, and why. Wire bytes are EXACTLY equal everywhere. The MLP
rounds (``uq+``, ``rand-qat``; SGD) and the ``fp32`` KWT round are held to
the bar of the ``uq`` rounds of ``test_torch_fedsim``: the loss history to
relative 1e-5; params to atol 1e-5 + rtol 1e-4 on all but at most 1e-3 of
the elements, and every quantized weight within one top-bin grid step
(alpha / 15) of the reference. The exceptions there are stochastic-rounding
decisions that flip where ``u`` falls between two values of ``y`` a few ULP
apart, and the first local step's clip boundary (the port's closed-form
backward sends a boundary element's whole gradient to ``w``; jnp autodiff
splits it 0.5/0.5). Two named mechanisms need more room on the KWT
(AdamW, lr 1e-3, U local steps):

* the attention KEY bias (``qkv.b[D:2D]``) has a zero gradient in exact
  arithmetic (softmax is invariant to a shift shared by all keys), so its
  gradient is rounding noise and AdamW turns the noise into steps of about
  lr either way: held within 2 lr U (seen: 0.35 of it);
* with QAT, AdamW moves each clip value by about lr whatever the size of
  its gradient, and the LSQ clip gradient of a weight site is a sum that
  nearly cancels, so its sign, and the client's alpha, follows last-bit
  differences: a client's uplink then decodes on a grid shifted by up to
  one step, and the server's GD moves each weight by up to about one more.
  The ``uq+`` KWT round is held to loss relative 3e-2 (seen over five
  seeds: 2.7e-3), every quantized weight within two top-bin grid steps
  (seen: 0.80 of one step), every other leaf within 4 lr U (seen: 0.27 of
  it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import metrics as r_metrics
from repro.core import server_opt as r_so
from repro.core.engine import FedConfig as RCfg
from repro.core.fedsim import FedSim as RSim
from repro.core.qat import DISABLED as R_DISABLED
from repro.core.qat import QATConfig as RQAT
from repro.core.qat import clip_value_mask as r_cvm
from repro.core.qat import weight_decay_mask as r_wdm
from repro.data import partition_iid as r_partition_iid
from repro.data import synthetic_classification as r_synth_cls
from repro.data import synthetic_images as r_synth_img
from repro.data import synthetic_sequences as r_synth_seq
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch import data as t_data
from repro_torch import optim as t_optim
from repro_torch.bench import common as t_common
from repro_torch.bench import table1 as t_table1
from repro_torch.core import engine as t_engine
from repro_torch.core.fedsim import FedSim as TSim
from repro_torch.core.qat import DISABLED as T_DISABLED
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.core.qat import clip_value_mask as t_cvm
from repro_torch.core.qat import weight_decay_mask as t_wdm
from repro_torch.core.server_opt import ServerOptConfig as TSO
from repro_torch.models import small as t_small


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(torch.uint32)


class ReplayQatBits:
    """The reference's site bits, replayed through the port's provider."""

    def __init__(self, k_q):          # k_q[client][step]: the step's QAT key
        self.k_q = k_q

    def provider(self, client, step):
        k = self.k_q[client][step]
        return lambda site, shape: _u32(np.asarray(jax.random.bits(
            jax.random.fold_in(k, site), shape=shape, dtype=jnp.uint32)))

    def to(self, device):
        return self


def reference_draws(key, rounds, K, P, U, B, n_per, so=None, qat_rand=False):
    out = []
    for _ in range(rounds):
        key, k_round = jax.random.split(key)
        k_sel, k_down, k_up, k_loc, k_srv = jax.random.split(k_round, 5)
        cohort = np.asarray(jax.random.permutation(k_sel, K)[:P])
        batches, k_q = [], []
        for k_loc_c in jax.random.split(k_loc, P):
            steps = [jax.random.split(k) for k in jax.random.split(k_loc_c, U)]
            batches.append([np.asarray(jax.random.randint(kb, (B,), 0, n_per))
                            for kb, _ in steps])
            k_q.append([kq for _, kq in steps])
        extra = {}
        if so is not None:
            k_gd, k_grid = jax.random.split(k_srv)
            extra = dict(gd_keys=_u32(np.asarray(r_so._key_words(k_gd, so.gd_steps))),
                         grid_keys=_u32(np.asarray(r_so._key_words(k_grid, so.n_grid))))
        if qat_rand:
            extra["qat_bits"] = ReplayQatBits(k_q)
        out.append(t_engine.RoundDraws(
            cohort=torch.from_numpy(cohort.astype(np.int64)),
            batches=torch.from_numpy(np.asarray(batches, np.int64)),
            down_key=_u32(np.asarray(k_down)[:2]),
            up_keys=_u32(np.asarray(jax.random.split(k_up, P))[:, :2]),
            **extra))
    return out


def _data(model):
    if model == "mlp":
        return r_synth_cls(0, 400, d=32, n_classes=10, noise=1.0)
    if model == "resnet":
        return r_synth_img(0, 160, n_classes=10, noise=0.45)
    return r_synth_seq(0, 160, n_classes=35, noise=0.9)


def _run_pair(model, rounds, method, K=4, c=0.5, U=3, B=8, seed_key=7, init_kw=None,
              acts=True):
    x, y = _data(model)
    cx, cy, nk = r_partition_iid(x, y, k=K, seed=0)
    init, apply = r_small.REGISTRY[model]
    rp = init(jax.random.PRNGKey(0), **(init_kw or {}))
    so = r_so.ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    base = dict(n_clients=K, participation=c, local_steps=U, batch_size=B)
    rmeth = {"uq+": dict(comm_mode="rand", qat=RQAT(quantize_acts=acts), server_opt=so),
             "uq": dict(comm_mode="rand", qat=RQAT(quantize_acts=acts)),
             "fp32": dict(comm_mode="none", qat=R_DISABLED),
             "rand-qat": dict(comm_mode="rand", qat=RQAT(mode="rand"))}[method]
    tmeth = {"uq+": dict(comm_mode="rand", qat=TQAT(quantize_acts=acts),
                         server_opt=TSO(enabled=True, gd_steps=5, lr=0.1, n_grid=20)),
             "uq": dict(comm_mode="rand", qat=TQAT(quantize_acts=acts)),
             "fp32": dict(comm_mode="none", qat=T_DISABLED),
             "rand-qat": dict(comm_mode="rand", qat=TQAT(mode="rand"))}[method]
    adamw = model in ("kwt", "matchbox")    # speech tasks: AdamW 1e-3 (bench/common.py)
    if adamw:
        ropt = r_optim.adamw(1e-3, weight_decay=0.1, wd_mask=r_wdm(rp), trust_mask=r_cvm(rp))
    else:
        ropt = r_optim.sgd(0.05, weight_decay=1e-3, wd_mask=r_wdm(rp), trust_mask=r_cvm(rp))
    rsim = RSim(rp, r_small.make_loss(apply), apply, ropt, RCfg(**base, **rmeth),
                jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(nk))
    key = jax.random.PRNGKey(seed_key)
    evald = (x[:64], y[:64])
    rh = rsim.run(rounds, key, eval_data=tuple(map(jnp.asarray, evald)), eval_every=1)

    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    tapply = t_small.REGISTRY[model][1]
    if adamw:
        topt = t_optim.adamw(1e-3, weight_decay=0.1, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    else:
        topt = t_optim.sgd(0.05, weight_decay=1e-3, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    cfg = t_engine.FedConfig(**base, **tmeth)
    tsim = TSim(tp, t_small.make_loss(tapply), tapply, topt, cfg, cx, cy, nk, device="cpu")
    draws = reference_draws(key, rounds, K, cfg.clients_per_round, U, B, cx.shape[1],
                            so=so if method == "uq+" else None,
                            qat_rand=method == "rand-qat")
    th = tsim.run(rounds, draws=draws, eval_data=evald, eval_every=1)
    return rsim, rh, tsim, th


def _assert_params_close(port: dict, ref, frac=1e-3):
    ref_flat = dict(tree.flatten(jax.tree.map(np.asarray, ref)))
    port_flat = dict(tree.flatten(port))
    n_bad = n_all = 0
    for name, v in port_flat.items():
        r, v = ref_flat[name], v.numpy()
        d = np.abs(v - r)
        n_bad += int(np.sum(d > 1e-5 + 1e-4 * np.abs(r)))
        n_all += r.size
        qa = name.rsplit(".", 1)[0] + ".w_qa"
        if name.endswith(".w") and qa in ref_flat:
            assert d.max() <= float(ref_flat[qa]) / 15 + 1e-5, name
    assert n_bad <= max(1, int(frac * n_all)), f"{n_bad} of {n_all} elements differ"


KWT_SMALL = dict(d_model=32, depth=1, n_classes=35)
RESNET_SMALL = dict(widths=(4, 8))
MATCHBOX_SMALL = dict(channels=16, blocks=2)
KWT_LR, U_STEPS = 1e-3, 3


def _key_bias(tp: dict):
    """``(name, slice)`` of each KWT layer's attention key bias."""
    out = []
    for layer, p in tp.items():
        if layer.startswith("layer"):
            d = p["qkv"]["b"].shape[0] // 3
            out.append((f"{layer}.qkv.b", slice(d, 2 * d)))
    return out


def _split_key_bias(port: dict, ref_np: dict):
    """Check the key biases (within 2 lr U) and drop them from both trees."""
    port_flat = dict(tree.flatten(port))
    ref_flat = dict(tree.flatten(ref_np))
    for name, sl in _key_bias(port):
        d = np.abs(port_flat[name].numpy()[sl] - ref_flat[name][sl])
        assert d.max() <= 2 * KWT_LR * U_STEPS, name
        port_flat[name] = port_flat[name].clone()
        port_flat[name][sl] = torch.from_numpy(ref_flat[name][sl].copy())
    return tree.unflatten(list(port_flat), list(port_flat.values()))


@pytest.mark.parametrize("model,method,rounds,init_kw", [
    ("mlp", "uq+", 2, None),
    ("mlp", "rand-qat", 2, None),
    ("kwt", "fp32", 1, KWT_SMALL),
    ("resnet", "uq", 1, RESNET_SMALL),
    ("resnet", "uq+", 1, RESNET_SMALL),
    ("matchbox", "uq", 1, MATCHBOX_SMALL),
    ("matchbox", "uq+", 1, MATCHBOX_SMALL),
])
def test_method_rounds_match_reference(model, method, rounds, init_kw, monkeypatch):
    if method == "rand-qat":
        monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    rsim, rh, tsim, th = _run_pair(model, rounds, method, init_kw=init_kw)
    assert tsim.bytes_per_round == rsim.bytes_per_round
    assert th.cumulative_bytes == rh.cumulative_bytes
    assert th.rounds == rh.rounds
    if model in PAPER_ROUND_BARS:
        _assert_within_paper_bars(model, method, rsim, rh, tsim, th)
        return
    np.testing.assert_allclose(th.loss, rh.loss, rtol=1e-5)
    ref = jax.tree.map(np.asarray, rsim.params)
    port = _split_key_bias(tsim.params, ref) if model == "kwt" else tsim.params
    _assert_params_close(port, ref)
    agg = t_engine.ServerOptAggregator if method == "uq+" else t_engine.MeanAggregator
    assert isinstance(tsim.engine.aggregator, agg)


# The paper's ResNet and MatchboxNet (reduced width, one round, both
# quantizers on): (loss rtol, quantized weights in top-bin grid steps, clip
# values ``*_qa``/``*_qb`` absolute, every other leaf absolute), each a modest
# margin above the worst seen over uq and uq+. Three mechanisms, none a fault
# of the port:
# * activation ties: the convolutions sum in another order than XLA's, so a
#   site input may land a few ULP across a grid midpoint and take the
#   neighbouring code (test_torch_paper_models shows one in a ResNet forward
#   pass); the sample's later activations, its loss and its gradient then move
#   by that code's step, every later local step starting from there. Seen:
#   ResNet loss 6.0e-4 relative, weights 0.60 of a grid step;
# * ResNet's f32 gradient noise: ten convolutions each under a GroupNorm of
#   one channel a group at width 4 amplify summation-order differences; its
#   fp32 round (no quantizers) leaves 29 of 3008 params beyond 1e-5 +
#   1e-4|ref|, 4.3e-5 at most; seen with QAT: clip values 4.9e-4 (the head's
#   w_qa, one wire step of its round's move), other leaves 7.2e-4 (a
#   GroupNorm scale), below most GroupNorm leaves' move in the round;
# * MatchboxNet trains with AdamW (speech-matchbox's optimizer), so the
#   KWT's mechanism above applies: seen loss 5.4e-5, weights 0.81 of a grid
#   step, clip values 2.3e-3 (uq+: the server's grid search lands one w_qa
#   on a neighbouring grid point), other leaves 3.4e-4, under a fifth of
#   what AdamW moves each bias and GroupNorm leaf in the round (2.4e-3 or
#   more), so a round that skipped one of those updates fails.
PAPER_ROUND_BARS = {"resnet": (1e-3, 0.75, 7.5e-4, 1e-3),
                    "matchbox": (1e-4, 1.0, 3e-3, 5e-4)}


def _assert_within_paper_bars(model, method, rsim, rh, tsim, th):
    loss_rtol, w_steps, clip, other = PAPER_ROUND_BARS[model]
    agg = t_engine.ServerOptAggregator if method == "uq+" else t_engine.MeanAggregator
    assert isinstance(tsim.engine.aggregator, agg)
    np.testing.assert_allclose(th.loss, rh.loss, rtol=loss_rtol)
    ref_flat = dict(tree.flatten(jax.tree.map(np.asarray, rsim.params)))
    for name, v in tree.flatten(tsim.params):
        d = float(np.abs(v.numpy() - ref_flat[name]).max())
        qa = name.rsplit(".", 1)[0] + ".w_qa"
        if name.endswith(".w") and qa in ref_flat:
            assert d <= w_steps * float(ref_flat[qa]) / 15, name
        elif name.endswith(("_qa", "_qb")):
            assert d <= clip, name
        else:
            assert d <= other, name


def test_kwt_uqplus_round_matches_reference_within_adamw_bounds():
    rsim, rh, tsim, th = _run_pair("kwt", 1, "uq+", init_kw=KWT_SMALL)
    assert isinstance(tsim.engine.aggregator, t_engine.ServerOptAggregator)
    assert tsim.bytes_per_round == rsim.bytes_per_round == 87152
    assert th.cumulative_bytes == rh.cumulative_bytes
    np.testing.assert_allclose(th.loss, rh.loss, rtol=3e-2)
    ref_flat = dict(tree.flatten(jax.tree.map(np.asarray, rsim.params)))
    for name, v in tree.flatten(tsim.params):
        d = float(np.abs(v.numpy() - ref_flat[name]).max())
        qa = name.rsplit(".", 1)[0] + ".w_qa"
        if name.endswith(".w") and qa in ref_flat:
            assert d <= 2 * float(ref_flat[qa]) / 15, name
        else:
            assert d <= 4 * KWT_LR * U_STEPS, name


@pytest.mark.parametrize("method", ["uq+", "rand-qat"])
def test_torch_native_draws_are_deterministic_and_train(method):
    x, y = t_data.synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = t_data.partition_iid(x, y, k=4, seed=0)
    cfg = t_common.method_cfg(method, 4, 0.5, 4, 8)

    def run():
        p = t_small.init_mlp(0, device="cpu")
        opt = t_optim.sgd(0.05, wd_mask=t_wdm(p), trust_mask=t_cvm(p))
        sim = TSim(p, t_small.make_loss(t_small.apply_mlp), t_small.apply_mlp, opt,
                   cfg, cx, cy, nk, device="cpu")
        return sim, sim.run(3, seed=3, eval_data=(x, y), eval_every=1)

    (s1, h1), (s2, h2) = run(), run()
    for (n, a), (_, b) in zip(tree.flatten(s1.params), tree.flatten(s2.params)):
        assert torch.equal(a, b), n
    assert h1.loss == h2.loss and h1.accuracy == h2.accuracy
    assert h1.cumulative_bytes == [7360 * 2 * 2 * r for r in (1, 2, 3)]
    assert all(np.isfinite(h1.loss)) and h1.loss[-1] < h1.loss[0]
    assert h1.best_accuracy() == max(h1.accuracy)
    assert h1.bytes_to_accuracy(h1.best_accuracy()) in h1.cumulative_bytes
    assert h1.bytes_to_accuracy(1.1) is None


def test_table1_driver_rows_carry_the_reference_bytes():
    """``repro_torch.bench.table1`` on the CPU at a tiny scale: one row per
    method and setting, each with the reference's exact bytes per round."""
    scale = dict(rounds=2, k=4, c=0.5, local_steps=2, batch=8, n_train=120, n_test=40)
    rows = t_table1.run(tasks=["cifar100-mlp"], device="cpu", scale=scale, eval_every=1)
    assert [(r["setting"], r["method"]) for r in rows] == [
        (s, m) for s in ("iid", "dir0.3") for m in ("fp32", "uq", "uq+")]
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=100)
    for r in rows:
        ref = r_metrics.round_bytes_for(rp, _ref_method_cfg(r["method"], 4, 0.5, 2, 8))
        assert type(r["bytes_per_round"]) is int and r["bytes_per_round"] == ref, r
        assert np.isfinite(r["final_acc"])
    assert {r["comm_gain"] for r in rows if r["method"] == "fp32"} == {1.0}


def test_bench_drivers_default_to_the_card():
    """``python -m repro_torch.bench.table1|table2|fig2|quickstart`` run on
    ``cuda`` unless told ``--device cpu``, and raise on a host without a GPU."""
    from repro_torch.bench import fig2 as t_fig2
    from repro_torch.bench import quickstart as t_quickstart
    from repro_torch.bench import table2 as t_table2

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_table1.main(["--tasks", "cifar100-mlp", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_table2.main(["--rounds", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_fig2.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_quickstart.main([])
    for init in (t_small.init_kwt, t_small.init_resnet, t_small.init_matchbox):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init(0)


def test_fig2_driver_rows_carry_the_reference_bytes():
    """``repro_torch.bench.fig2`` on the CPU at a tiny scale, 2 rounds: one
    row a method and round, its bytes a round and cumulative bytes the
    reference's integers (``benchmarks/fig2_curves.py``'s methods)."""
    from repro_torch.bench import fig2 as t_fig2

    scale = dict(rounds=2, eval_every=1, k=4, c=0.5, local_steps=2, batch=8, n_train=120,
                 n_test=40)
    rows = t_fig2.run(device="cpu", scale=scale)
    assert [(r["method"], r["round"]) for r in rows] == [
        (m, rd) for m in ("fp32", "bq", "uq", "uq+") for rd in (1, 2)]
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=100)
    grid = dict(t_fig2.METHODS)
    for r in rows:
        ref = r_metrics.round_bytes_for(rp, _ref_method_cfg(grid[r["method"]], 4, 0.5, 2, 8))
        assert r["bytes_per_round"] == ref and r["cumulative_bytes"] == r["round"] * ref, r
        assert r["mbytes"] == round(r["round"] * ref / 1e6, 3) and 0.0 <= r["acc"] <= 1.0


def test_quickstart_driver_carries_the_reference_bytes():
    """``repro_torch.bench.quickstart`` on the CPU for 2 rounds: FP32 FedAvg
    and FP8FedAvg-UQ at the reference's bytes a round
    (``examples/quickstart.py``: K = 20, C = 0.25, U = 20, B = 32) and
    cumulative bytes, finite accuracies."""
    from repro_torch.bench import quickstart as t_quickstart

    rows = t_quickstart.run(device="cpu", rounds=2)
    rp = r_small.init_mlp(jax.random.PRNGKey(0))
    base = dict(n_clients=20, participation=0.25, local_steps=20, batch_size=32)
    refs = (RCfg(comm_mode="none", qat=R_DISABLED, **base), RCfg(comm_mode="rand", qat=RQAT(),
                                                                  **base))
    assert [r["method"] for r in rows] == ["FP32 FedAvg", "FP8FedAvg-UQ"]
    for r, cfg in zip(rows, refs):
        ref = r_metrics.round_bytes_for(rp, cfg)
        assert r["bytes_per_round"] == ref and r["cumulative_bytes"] == [2 * ref], r
        assert r["rounds"] == [2] and 0.0 <= r["best_accuracy"] <= 1.0
    assert rows[0]["bytes_per_round"] > 3.7 * rows[1]["bytes_per_round"]


def _ref_method_cfg(method, k, c, u, b):
    """The reference's method grid (``benchmarks/common.py:74-95``)."""
    base = dict(n_clients=k, participation=c, local_steps=u, batch_size=b)
    so = r_so.ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    return {"fp32": lambda: RCfg(comm_mode="none", qat=R_DISABLED, **base),
            "uq": lambda: RCfg(comm_mode="rand", qat=RQAT(), **base),
            "uq+": lambda: RCfg(comm_mode="rand", qat=RQAT(), server_opt=so, **base),
            "det-cq": lambda: RCfg(comm_mode="det", qat=RQAT(), **base),
            "rand-qat": lambda: RCfg(comm_mode="rand", qat=RQAT(mode="rand"), **base),
            "qat-only": lambda: RCfg(comm_mode="none", qat=RQAT(), **base),
            "rand-qat-only": lambda: RCfg(comm_mode="none", qat=RQAT(mode="rand"), **base),
            }[method]()


@pytest.mark.parametrize("task", ["cifar10-lenet", "cifar100-mlp", "speech-kwt",
                                  "cifar10-resnet", "speech-matchbox"])
def test_method_grid_bytes_match_reference(task):
    """Every method of the grid, on every Table 1 task at full width, at the
    Table 1 (K=10, C=0.3) and Table 2 (K=12, C=0.3) cohorts: the port's
    bytes per round are the reference's integers."""
    from repro_torch.core import metrics as t_metrics

    t_task = t_common.TASKS[task]
    init = r_small.REGISTRY[t_task.model][0]
    kw = dict(d_in=64) if t_task.data_kind == "vector" else {}
    rp = init(jax.random.PRNGKey(0), n_classes=t_task.n_classes, **kw)
    tp, _ = t_common.make_model(t_task, 0, "cpu")
    for k in (10, 12):
        for m in t_common.METHODS:
            ref = r_metrics.round_bytes_for(rp, _ref_method_cfg(m, k, 0.3, 10, 32))
            port = t_metrics.round_bytes_for(tp, t_common.method_cfg(m, k, 0.3, 10, 32))
            assert port == ref, (task, k, m)
