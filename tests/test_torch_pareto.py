"""The format ablation's ``pareto`` rows on the port against the live JAX
reference: whole error-feedback and rANS rounds, every cell's byte bound,
and the port's ablation runner.

Rounds replay the reference's draws (``test_torch_grid.reference_draws``);
EF and rANS draw nothing more (the uplink encode keys are the plain wire's).
The reference runs jitted with its default jnp backend.

Tolerances, and why. Bytes are EXACT: every bound, and every round's
measured (traced) bytes wherever the two runs' codes agree. The E4M3 cells
are held to the bar of ``test_torch_grid`` (loss relative 1e-5; params atol
1e-5 + rtol 1e-4 on all but 1e-3 of the elements; every quantized weight
within one top-bin grid step), and the residual rows of ``e4m3|ef`` within
1e-6 absolute over four rounds, in which clients come back to the cohort and
use their memory (seen: 1.5e-7).

``fp4|ef+rans`` needs one named mechanism: on an FP4 E2M1 downlink many
weights take the top code, which decodes to the clip value ``alpha`` within
an f32 ULP, and the two packages' ``exp2`` put it on either side of
``alpha``. A weight one ULP above ``alpha`` lies outside the clip, so the
port's backward sends its gradient to ``alpha``, where the reference, seeing
``w == alpha``, splits it. The client's clip then moves differently (by
7e-6 on ``fc1``), which rescales that leaf's grid, moves every residual of
the leaf a little, and can flip a det code near a midpoint. Its first round
is held to the full bar (seen within it, residuals within 1e-6); each later
round is started from the reference's own state (params and
residual rows, ``convert.from_jax_client_state``), so that its codes, and
hence its bytes, can be compared exactly, and is held to loss relative 1e-3
(seen: 2.2e-4 in round 2, 3.2e-6 after), all but 1e-2 of the elements
within the elementwise bar (seen: 34 of 6928, 4.9e-3, in round 2; 0 after),
every weight and every residual within one top-bin step of its leaf's FP4
grid, ``alpha / 3`` (seen: 0.025 and 0.050 against 0.2).
"""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.core import metrics as r_metrics
from repro.core.engine import FedConfig as RCfg
from repro.core.qat import QATConfig as RQAT
from repro.data import partition_iid as r_partition_iid
from repro.data import synthetic_classification as r_synth_cls
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.bench import common as t_common
from repro_torch.bench import format_ablation as t_fa
from repro_torch.core import metrics as t_metrics
from repro_torch.core import wire as t_wire
from repro_torch.core.engine import FedConfig as TCfg
from repro_torch.core.fedsim import FedSim as TSim
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.core.qat import clip_value_mask as t_cvm
from repro_torch.core.qat import weight_decay_mask as t_wdm
from repro_torch.models import small as t_small
from test_torch_formats import _assert_params_close, _run_pair
from test_torch_grid import reference_draws

REPO = os.path.join(os.path.dirname(__file__), "..")
CELLS = {c: dict(down_codec=d, up_codec=u) for c, d, u in t_fa.PARETO}
# the reference's static bounds per round (MLP d_in 64, 10 classes, K=10, C=0.3)
PARETO_BYTES = {
    "e4m3|plain": 56448, "e4m3|delta": 56484, "e4m3|ef": 56448, "e4m3|rans": 110244,
    "e4m3|ef+rans": 110208, "fp4|plain": 29952, "fp4|delta": 29988, "fp4|ef": 29952,
    "fp4|rans": 57252, "fp4|ef+rans": 57216,
}
RESID_ATOL = 1e-6


def _assert_resid_close(tsim, rsim, atol):
    np.testing.assert_allclose(tsim.state.clients.resid.numpy(),
                               np.asarray(rsim.state.clients.resid), rtol=0, atol=atol)


@pytest.mark.parametrize("cell,rounds", [("e4m3|ef", 4), ("e4m3|rans", 3),
                                         ("e4m3|ef+rans", 2), ("fp4|ef+rans", 1)])
def test_pareto_rounds_match_reference(cell, rounds):
    """Whole rounds from the same init: exact per-round bytes (measured, on a
    rANS link), the loss history, params and, for EF, the residual rows."""
    rsim, rh, tsim, th = _run_pair(CELLS[cell], rounds=rounds)
    assert tsim.bytes_per_round == rsim.bytes_per_round
    assert th.cumulative_bytes == rh.cumulative_bytes
    if tsim.engine.dynamic:
        assert th.cumulative_bytes[-1] < rounds * tsim.bytes_per_round
    np.testing.assert_allclose(th.loss, rh.loss, rtol=1e-5)
    top = 15 if cell.startswith("e4m3") else 3
    _assert_params_close(tsim.params, rsim.params, top)
    if tsim.engine.link.up_is_ef:
        # a client sampled twice carries a nonzero row into its second round
        assert int((tsim.state.clients.resid.abs().sum(1) > 0).sum()) == len(
            {c for d in reference_draws(jax.random.PRNGKey(7), rounds, 4, 2, 3, 8, 100)
             for c in d.cohort.tolist()})
        _assert_resid_close(tsim, rsim, RESID_ATOL)


def _port_from_reference_state(kw, rstate, K=4, c=0.5, U=3, B=8):
    x, y = r_synth_cls(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = r_partition_iid(x, y, k=K, seed=0)
    tp = convert.from_jax_params(jax.tree.map(np.asarray, rstate.params), device="cpu")
    topt = t_optim.sgd(0.05, weight_decay=1e-3, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    cfg = TCfg(n_clients=K, participation=c, local_steps=U, batch_size=B, qat=TQAT(), **kw)
    tsim = TSim(tp, t_small.make_loss(t_small.apply_mlp), t_small.apply_mlp, topt, cfg,
                cx, cy, nk, device="cpu")
    clients = convert.from_jax_client_state(jax.tree.map(np.asarray, rstate.clients), "cpu")
    tsim.state = tsim.state._replace(clients=clients)
    return tsim, (x[:64], y[:64])


def test_fp4_ef_rans_rounds_from_the_reference_state():
    """Rounds 2-4 of ``fp4|ef+rans``, each started from the reference's state
    after the round before (module docstring): the same bytes each round."""
    kw = CELLS["fp4|ef+rans"]
    draws = reference_draws(jax.random.PRNGKey(7), 4, 4, 2, 3, 8, 100)
    prev, prev_h = _run_pair(kw, rounds=1)[:2]
    for r in (2, 3, 4):
        rsim, rh = _run_pair(kw, rounds=r)[:2]
        tsim, evald = _port_from_reference_state(kw, prev.state)
        th = tsim.run(1, draws=[draws[r - 1]], eval_data=evald, eval_every=1)
        assert th.cumulative_bytes[0] == rh.cumulative_bytes[-1] - prev_h.cumulative_bytes[-1]
        np.testing.assert_allclose(th.loss, rh.loss[-1:], rtol=1e-3)
        _assert_params_close(tsim.params, rsim.params, 3, frac=1e-2)
        t_res, r_res = tsim.state.clients.resid.numpy(), np.asarray(rsim.state.clients.resid)
        ws = t_wire.make_wire_spec(tsim.params)
        flat = dict(tree.flatten(jax.tree.map(np.asarray, rsim.params)))
        for name, off, shape in zip(ws.q_names, ws.q_offsets, ws.q_shapes):
            n = int(np.prod(shape))
            step = float(flat[name + "_qa"]) / 3
            assert np.abs(t_res[:, off:off + n] - r_res[:, off:off + n]).max() <= step, name
        prev, prev_h = rsim, rh


@pytest.mark.parametrize("cell", list(CELLS))
def test_pareto_cell_bounds_match_reference(cell):
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    tp = t_small.init_mlp(0, d_in=64, n_classes=10, device="cpu")
    base = dict(n_clients=10, participation=0.3, local_steps=10, batch_size=32)
    ref = r_metrics.round_bytes_for(rp, RCfg(**base, qat=RQAT(), **CELLS[cell]))
    port = t_metrics.round_bytes_for(tp, TCfg(**base, qat=TQAT(), **CELLS[cell]))
    assert port == ref == PARETO_BYTES[cell]


def test_lenet_ef_rans_bound_matches_reference():
    rp = r_small.init_lenet(jax.random.PRNGKey(0))
    tp, _ = t_common.make_model(t_common.TASKS["cifar10-lenet"], 0, "cpu")
    kw = CELLS["fp4|ef+rans"]
    base = dict(n_clients=10, participation=0.3, local_steps=10, batch_size=32)
    ref = r_metrics.round_bytes_for(rp, RCfg(**base, qat=RQAT(), **kw))
    assert t_metrics.round_bytes_for(tp, TCfg(**base, qat=TQAT(), **kw)) == ref == 827760


def _reference_benchmark():
    path = os.path.join(REPO, "benchmarks", "format_ablation.py")
    spec = importlib.util.spec_from_file_location("_ref_format_ablation_pareto", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pareto_cells_follow_the_reference_benchmark():
    assert [tuple(c) for c in t_fa.PARETO] == _reference_benchmark().PARETO
    assert [c for s, c, _ in t_fa.cells(("pareto",))] == [c for c, _, _ in t_fa.PARETO]


TINY = dict(rounds=2, n=240, n_train=200, k=4, c=0.5, local_steps=2, batch=8, eval_every=1)


def test_pareto_rows_at_a_tiny_scale():
    """``iter_rows(sections=("pareto",))`` on the CPU: every row has the
    reference's bound, the two-lane contract, and the reference's fields."""
    rows = list(t_fa.iter_rows(device="cpu", sections=("pareto",), scale=TINY))
    assert [r["comm_fmt"] for r in rows] == list(CELLS)
    rp = r_small.init_mlp(jax.random.PRNGKey(0), d_in=64, n_classes=10)
    base = dict(n_clients=4, participation=0.5, local_steps=2, batch_size=8, qat=RQAT())
    fp32 = r_metrics.round_bytes_for(rp, RCfg(**base, comm_mode="none"))
    for r in rows:
        cfg = RCfg(**base, **CELLS[r["comm_fmt"]])
        assert r["bench"] == "pareto"
        assert type(r["round_bytes"]) is int
        assert r["round_bytes"] == r_metrics.round_bytes_for(rp, cfg)
        m = r["measured_round_bytes"]
        if "rans" in r["comm_fmt"]:
            assert 0 < m < r["round_bytes"]
        else:
            assert m == r["round_bytes"]
        assert r["bits_per_param"] == round(m * 8 / (2 * 2 * 8976), 3)
        assert r["comm_gain_vs_fp32"] == round(fp32 / m, 3)
        assert 0.0 <= r["final_acc"] <= 1.0
        assert set(r) >= {"gain_to_acc_0p95", "acc_delta_vs_fp32", "down_codec", "up_codec"}
    by = {r["comm_fmt"]: r for r in rows}
    assert by["fp4|ef+rans"]["up_codec"] == "ef:rans:fp4_e2m1_det"
    assert by["e4m3|rans"]["down_codec"] == "rans:e4m3"
    # rANS is lossless: a rans cell trains exactly as its un-coded twin
    assert by["fp4|rans"]["final_acc"] == by["fp4|delta"]["final_acc"]
    assert by["e4m3|ef+rans"]["final_acc"] == by["e4m3|ef"]["final_acc"]


def test_dynamic_link_charges_measured_bytes_and_reports_the_bound():
    x, y = r_synth_cls(0, 240, d=64, n_classes=10, noise=1.6)
    cx, cy, nk = r_partition_iid(x[:200], y[:200], k=4, seed=0)
    tp = t_small.init_mlp(0, d_in=64, n_classes=10, device="cpu")
    opt = t_optim.sgd(0.1, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    cfg = TCfg(n_clients=4, participation=0.5, local_steps=2, batch_size=8, qat=TQAT(),
               **CELLS["e4m3|ef+rans"])
    sim = TSim(tp, t_small.make_loss(t_small.apply_mlp), t_small.apply_mlp, opt, cfg,
               cx, cy, nk, device="cpu")
    assert sim.engine.dynamic and sim.bytes_per_round == t_metrics.round_bytes_for(tp, cfg)
    per_round = []
    d = sim.engine.draw(torch.Generator().manual_seed(0), sim.nk, cx.shape[1])
    st, m = sim.engine.round_fn(sim.state, sim.client_data, sim.client_labels, sim.nk, d)
    assert isinstance(m["wire_bytes"], torch.Tensor) and m["wire_bytes"].dim() == 0
    per_round.append(int(m["wire_bytes"]))
    sim.state = st
    h = sim.run(2, seed=1, eval_data=(x[200:], y[200:]), eval_every=1)
    per_round += [h.cumulative_bytes[0], h.cumulative_bytes[1] - h.cumulative_bytes[0]]
    assert all(0 < b < sim.bytes_per_round for b in per_round)
    assert len(set(per_round)) > 1          # measured, not a constant
