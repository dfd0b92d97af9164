"""Whole federated rounds of the wire-format ablation on the port against the
live JAX reference, the cells' bytes, and the port's ablation driver.

Rounds replay the reference's draws (``test_torch_grid.reference_draws``:
cohort, batches and the wire key words of each leg); delta and scaling
draw nothing more. The reference runs jitted with its default jnp backend,
as its simulator does.

Tolerances, and why. Wire bytes are EXACTLY equal everywhere. Rounds are
held to the bar of ``test_torch_grid``: the loss history to relative 1e-5,
params to atol 1e-5 + rtol 1e-4 on all but at most 1e-3 of the elements,
and every quantized weight within one top-bin grid step of the reference
at the uplink's format (alpha / 15 for E4M3, alpha / 3 for FP4 E2M1). The
exceptions there are the first local step's clip boundary (the port's
closed-form backward sends a boundary element's whole gradient to ``w``;
jnp autodiff splits it 0.5/0.5) and stochastic-rounding decisions that
flip where ``u`` falls between two values of ``y`` a few ULP apart. Two
named mechanisms need more room:

* a delta uplink codes the residual ``params - ref``, a few local steps'
  updates and so much smaller than the weights, and training's last-bit
  differences are that much larger against the residual's grid: its
  decisions flip more often, each by one residual grid step: the delta
  cell is held to 5e-3 of the elements beyond the elementwise bar (seen: 11
  of 6928 after two rounds, 0 after one), with every weight within one
  top-bin step of the RESIDUAL's grid, the largest clip ``max|params -
  ref|`` its uplinks shipped over 3 (seen on ``fc1.w``: 0.0049 against a
  bar of 0.0192, i.e. 0.085 of the residual clip);
* a deterministic downlink after a mean of deterministic uplinks quantizes
  values that sit on the midpoint of two grid points, and XLA:CPU's
  ``exp2`` differs from the correctly rounded one (the port's, and CUDA's
  ``exp2f``) by a few ULP, which breaks those ties the other way
  (:func:`test_det_downlink_breaks_midpoint_ties_as_exp2_rounds`). The
  ``e4m3 det`` round is held at the full bar for its first round, where no
  value sits on a midpoint; the tie test holds two rounds to loss relative
  1e-2 (seen: 3.4e-3) and every weight within one grid step (seen: 0.033
  of alpha).
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import metrics as r_metrics
from repro.core.engine import FedConfig as RCfg
from repro.core.fedsim import FedSim as RSim
from repro.core.qat import QATConfig as RQAT
from repro.core.qat import clip_value_mask as r_cvm
from repro.core.qat import weight_decay_mask as r_wdm
from repro.data import partition_iid as r_partition_iid
from repro.data import synthetic_classification as r_synth_cls
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.bench import common as t_common
from repro_torch.bench import format_ablation as t_fa
from repro_torch.core import metrics as t_metrics
from repro_torch.core.engine import FedConfig as TCfg
from repro_torch.core.fedsim import FedSim as TSim
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.core.qat import clip_value_mask as t_cvm
from repro_torch.core.qat import weight_decay_mask as t_wdm
from repro_torch.models import small as t_small
from test_torch_grid import reference_draws

REPO = os.path.join(os.path.dirname(__file__), "..")
# the ablation sections this file covers (pareto: tests/test_torch_pareto.py)
FORMAT_SECTIONS = ("format", "scaling")

# the reference's bytes per round of each ablation cell (MLP d_in 64, 10
# classes, K=10, C=0.3), as BENCH_formats.json holds them
FORMAT_BYTES = {
    "fp32": 215424,
    **{f"{c}|{r}": 56448 for c in ("e4m3", "e5m2") for r in ("rand", "det")},
    **{f"{c}|{r}": 29952 for c in ("fp4_e2m1", "fp4_e3m0") for r in ("rand", "det")},
    "delta:e4m3|rand": 56484, "delta:e4m3|det": 56484,
    "delta:fp4_e2m1|rand": 29988, "delta:fp4_e2m1|det": 29988,
    "current": 56448, "delayed:4": 56520, "delayed:16:1": 56520,
    "frozen_down": 56412, "frozen_down+delayed_up": 56448,
}

E4M3_DET = dict(down_codec="e4m3_det", up_codec="e4m3_det")
# cell: (FedConfig overrides, rounds, fraction of elements allowed beyond the
# elementwise bar); see the module docstring for the two exceptions
ROUND_CELLS = {
    "fp4_e2m1 rand": (dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1"), 2, 1e-3),
    "delta:fp4_e2m1 rand": (dict(down_codec="fp4_e2m1", up_codec="delta:fp4_e2m1"),
                            2, 5e-3),
    "e4m3 det": (E4M3_DET, 1, 1e-3),
    "delayed:4": (dict(down_scaling="delayed:4", up_scaling="delayed:4"), 2, 1e-3),
    "frozen_down+delayed_up": (dict(down_scaling="frozen", up_scaling="delayed:4"),
                               2, 1e-3),
    "fp4_e2m1 delayed:4": (dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1",
                                down_scaling="delayed:4", up_scaling="delayed:4"), 2, 1e-3),
}


def _run_pair(kw, rounds=2, K=4, c=0.5, U=3, B=8, seed_key=7):
    x, y = r_synth_cls(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = r_partition_iid(x, y, k=K, seed=0)
    rp = r_small.init_mlp(jax.random.PRNGKey(0))
    base = dict(n_clients=K, participation=c, local_steps=U, batch_size=B)
    ropt = r_optim.sgd(0.05, weight_decay=1e-3, wd_mask=r_wdm(rp), trust_mask=r_cvm(rp))
    rsim = RSim(rp, r_small.make_loss(r_small.apply_mlp), r_small.apply_mlp, ropt,
                RCfg(**base, qat=RQAT(), **kw), jnp.asarray(cx), jnp.asarray(cy),
                jnp.asarray(nk))
    key = jax.random.PRNGKey(seed_key)
    evald = (x[:64], y[:64])
    rh = rsim.run(rounds, key, eval_data=tuple(map(jnp.asarray, evald)), eval_every=1)

    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    topt = t_optim.sgd(0.05, weight_decay=1e-3, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    cfg = TCfg(**base, qat=TQAT(), **kw)
    tsim = TSim(tp, t_small.make_loss(t_small.apply_mlp), t_small.apply_mlp, topt, cfg,
                cx, cy, nk, device="cpu")
    draws = reference_draws(key, rounds, K, cfg.clients_per_round, U, B, cx.shape[1])
    th = tsim.run(rounds, draws=draws, eval_data=evald, eval_every=1)
    return rsim, rh, tsim, th


def _assert_params_close(port: dict, ref, top_steps: int, frac=1e-3, clips=None):
    """The round bar (module docstring). Each quantized weight is held within
    one top-bin step of its grid: of the model's clip ``w_qa``, or, where
    ``clips`` names the leaf, of that clip (a delta uplink's residual grid)."""
    ref_flat = dict(tree.flatten(jax.tree.map(np.asarray, ref)))
    n_bad = n_all = 0
    for name, v in tree.flatten(port):
        r = ref_flat[name]
        d = np.abs(v.numpy() - r)
        n_bad += int(np.sum(d > 1e-5 + 1e-4 * np.abs(r)))
        n_all += r.size
        qa = name.rsplit(".", 1)[0] + ".w_qa"
        if name.endswith(".w") and qa in ref_flat:
            clip = (clips or {}).get(name, float(ref_flat[qa]))
            assert d.max() <= clip / top_steps + 1e-5, name
    assert n_bad <= max(1, int(frac * n_all)), f"{n_bad} of {n_all} elements differ"


def _record_delta_clips(monkeypatch) -> dict:
    """Patch the port's ``DeltaCodec.encode`` to keep, per quantized leaf,
    the largest residual clip any of its uplinks shipped."""
    from repro_torch.core import codec as t_codec

    clips: dict = {}
    encode = t_codec.DeltaCodec.encode

    def record(self, params, spec, key2, ref=None):
        pay = encode(self, params, spec, key2, ref=ref)
        for name, a in zip(spec.q_names, pay["other"][-1].tolist()):
            clips[name] = max(a, clips.get(name, 0.0))
        return pay

    monkeypatch.setattr(t_codec.DeltaCodec, "encode", record)
    return clips


def _top_steps(cfg) -> int:
    """Grid steps in the top bin of the uplink's format (15 E4M3, 3 E2M1)."""
    up = cfg.resolved_up_codec
    return 2 ** (getattr(up, "inner", up).fmt.mant + 1) - 1


@pytest.mark.parametrize("cell", list(ROUND_CELLS))
def test_format_rounds_match_reference(cell, monkeypatch):
    kw, rounds, frac = ROUND_CELLS[cell]
    clips = _record_delta_clips(monkeypatch)
    rsim, rh, tsim, th = _run_pair(kw, rounds=rounds)
    assert tsim.bytes_per_round == rsim.bytes_per_round
    assert th.cumulative_bytes == rh.cumulative_bytes
    np.testing.assert_allclose(th.loss, rh.loss, rtol=1e-5)
    _assert_params_close(tsim.params, rsim.params, _top_steps(tsim.cfg), frac, clips)
    # the scaling state: the same amax histories, bitwise
    if tsim.engine.link.scaled:
        for t_st, r_st in zip(tsim.state.scales, rsim.state.scales):
            if isinstance(t_st, torch.Tensor):
                np.testing.assert_allclose(t_st.numpy(), np.asarray(r_st), rtol=1e-5)


def test_det_downlink_breaks_midpoint_ties_as_exp2_rounds():
    """After a round of det uplinks the server model holds means of grid
    points, often exact midpoints. Encoding the reference's own post-round
    model, the port's det codes differ from the reference's only at such
    midpoints (the f64 value of ``y`` within 1e-5 of k + 1/2), by one code,
    and only where XLA:CPU's ``exp2`` and the correctly rounded one put the
    f32 ``y`` on either side; two rounds then stay within a grid step."""
    from repro.core import wire as r_wire
    from repro_torch.core import wire as t_wire

    rsim, _, _, _ = _run_pair(E4M3_DET, rounds=1)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rsim.params), device="cpu")
    rs, ts = r_wire.make_wire_spec(rsim.params), t_wire.make_wire_spec(tp)
    rc = np.asarray(r_wire.encode(rsim.params, rs, jnp.zeros(2, jnp.uint32),
                                  mode="det")["codes"]).astype(np.int64)
    tc = t_wire.encode(tp, ts, None, mode="det")["codes"].numpy().astype(np.int64)
    diff = np.nonzero(rc != tc)[0]
    assert 0 < diff.size <= 0.1 * rc.size
    assert np.all(np.abs(rc[diff] - tc[diff]) == 1)
    leaves = [t.numpy() for t in tree.leaves(tp)]
    x = np.concatenate([leaves[i].reshape(-1) for i in ts.q_slots])
    a = np.concatenate([np.full(leaves[i].size, leaves[ts.other_slots[ai]].item(), np.float32)
                        for i, ai in zip(ts.q_slots, ts.alpha_pos)])[diff]
    b = (np.float32(16.0) - np.log2(a) + np.float32(np.log2(2 - 2 ** -3))
         - np.float32(1.0)).astype(np.float32)
    xd = x[diff].astype(np.float64)
    p = np.maximum(np.floor(np.log2(np.abs(xd)) + b), 1.0)
    y = xd / np.exp2(p - b.astype(np.float64) - 3)
    assert np.all(np.abs(np.abs(y) - np.floor(np.abs(y)) - 0.5) < 1e-5)
    # the two runs then stay within a grid step of each other
    rsim, rh, tsim, th = _run_pair(E4M3_DET, rounds=2)
    assert th.cumulative_bytes == rh.cumulative_bytes
    np.testing.assert_allclose(th.loss, rh.loss, rtol=1e-2)
    _assert_params_close(tsim.params, rsim.params, 15, frac=1.0)


def test_frozen_downlink_is_bitwise_current():
    """Frozen scaling changes bytes only: the run equals the current one."""
    _, _, cur, hc = _run_pair({})
    _, _, frz, hf = _run_pair(dict(down_scaling="frozen"))
    assert hf.loss == hc.loss
    for (n, a), (_, b) in zip(tree.flatten(cur.params), tree.flatten(frz.params)):
        assert torch.equal(a, b), n
    assert frz.bytes_per_round == cur.bytes_per_round - 2 * 4 * 3  # P x 4 B x n_q


def _reference_benchmark():
    path = os.path.join(REPO, "benchmarks", "format_ablation.py")
    spec = importlib.util.spec_from_file_location("_ref_format_ablation", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_cells_follow_the_reference_benchmark():
    ref = _reference_benchmark()
    assert list(t_fa.CODECS) == ref.CODECS and list(t_fa.ROUNDINGS) == ref.ROUNDINGS
    assert [(c, dict(kw)) for c, kw in t_fa.SCALINGS] == ref.SCALINGS
    want = [("format", "fp32", dict(comm_mode="none"))]
    want += [("format", f"{c}|{r}", ref._legs(c, r)) for c in ref.CODECS for r in ref.ROUNDINGS]
    want += [("scaling", c, dict(comm_mode="rand", **kw)) for c, kw in ref.SCALINGS]
    assert t_fa.cells(FORMAT_SECTIONS) == want and len(want) == 18


@pytest.mark.parametrize("section,cell,kw", t_fa.cells(FORMAT_SECTIONS))
def test_cell_bytes_match_reference(section, cell, kw):
    """The 18 cells at the reference's configuration: the port's bytes per
    round are the reference's ``round_bytes_for`` and BENCH_formats.json's."""
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    tp = t_small.init_mlp(0, d_in=64, n_classes=10, device="cpu")
    assert t_metrics.param_count(tp) == 8976
    base = dict(n_clients=10, participation=0.3, local_steps=10, batch_size=32)
    ref = r_metrics.round_bytes_for(rp, RCfg(**base, qat=RQAT(), **kw))
    port = t_metrics.round_bytes_for(tp, TCfg(**base, qat=TQAT(), **kw))
    assert port == ref == FORMAT_BYTES[cell]


@pytest.mark.parametrize("kw,want", [
    (dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1"), 416910),
    (dict(down_codec="fp4_e2m1", up_codec="delta:fp4_e2m1"), 416970),
    (dict(down_scaling="delayed:4", up_scaling="delayed:4"), 826980),
    (dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1", down_scaling="delayed:4",
          up_scaling="delayed:4"), 417030),
    (dict(comm_mode="rand"), 826860),
])
def test_lenet_format_cells_bytes_match_reference(kw, want):
    """Full-width cifar10-lenet at Table 1's budget (K=10, C=0.3)."""
    rp = r_small.init_lenet(jax.random.PRNGKey(0))
    tp, _ = t_common.make_model(t_common.TASKS["cifar10-lenet"], 0, "cpu")
    base = dict(n_clients=10, participation=0.3, local_steps=10, batch_size=32)
    ref = r_metrics.round_bytes_for(rp, RCfg(**base, qat=RQAT(), **kw))
    assert t_metrics.round_bytes_for(tp, TCfg(**base, qat=TQAT(), **kw)) == ref == want


def test_mlp_fp4_with_delayed_scaling_bytes():
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    tp = t_small.init_mlp(0, d_in=64, n_classes=10, device="cpu")
    kw = dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1", down_scaling="delayed:4",
              up_scaling="delayed:4")
    base = dict(n_clients=10, participation=0.3)
    assert (t_metrics.round_bytes_for(tp, TCfg(**base, **kw))
            == r_metrics.round_bytes_for(rp, RCfg(**base, **kw)) == 30024)


TINY = dict(rounds=2, n=240, n_train=200, k=4, c=0.5, local_steps=2, batch=8, eval_every=1)


def test_format_driver_rows_carry_the_reference_bytes():
    """``repro_torch.bench.format_ablation`` on the CPU at a tiny scale: one
    row per cell, each with the reference's exact bytes per round."""
    rows = list(t_fa.iter_rows(device="cpu", sections=FORMAT_SECTIONS, scale=TINY))
    assert [r["comm_fmt"] for r in rows] == [
        c if s == "format" else f"e4m3|rand|{c}" for s, c, _ in t_fa.cells(FORMAT_SECTIONS)]
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    base = dict(n_clients=4, participation=0.5, local_steps=2, batch_size=8, qat=RQAT())
    fp32 = r_metrics.round_bytes_for(rp, RCfg(**base, comm_mode="none"))
    for (_, _, kw), r in zip(t_fa.cells(FORMAT_SECTIONS), rows):
        ref = r_metrics.round_bytes_for(rp, RCfg(**base, **kw))
        assert type(r["round_bytes"]) is int and r["round_bytes"] == ref, r
        assert r["comm_gain_vs_fp32"] == round(fp32 / ref, 3)
        assert 0.0 <= r["final_acc"] <= 1.0
    by = {r["comm_fmt"]: r for r in rows}
    assert by["fp32"]["comm_gain_vs_fp32"] == 1.0
    assert by["fp4_e2m1|rand"]["down_codec"] == "fp4_e2m1"
    assert by["delta:fp4_e2m1|det"]["up_codec"] == "delta:fp4_e2m1_det"
    # frozen scaling moves bytes only: its run is the current cell's, bit for bit
    assert by["e4m3|rand|frozen_down"]["acc_delta_vs_current"] == 0.0


def test_format_driver_sections_and_device():
    rows = list(t_fa.iter_rows(device="cpu", sections=("scaling",),
                                scale={**TINY, "rounds": 1}))
    assert [r["scaling"] for r in rows] == [c for c, _ in t_fa.SCALINGS]
    # pareto is a section now (tests/test_torch_pareto.py); an unknown one raises
    with pytest.raises(ValueError, match="pareto"):
        list(t_fa.iter_rows(device="cpu", sections=("bogus",)))
    with pytest.raises(SystemExit):
        t_fa.main(["--sections", "bogus"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_fa.main(["--rounds", "1"])
