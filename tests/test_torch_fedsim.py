"""Whole federated rounds of the port against the live JAX reference.

The reference draws its randomness with threefry, which torch cannot
reproduce, so :func:`reference_draws` replays the reference's key splits
(``fedsim.py`` per round, ``engine.py:1487`` per stage, ``engine.py:391``
per local step, ``engine.py:733`` per uplink client, ``wire.py:175-178``
for the key words) and hands the realized numbers to the port.

The reference runs its default jnp backend, jitted, as its simulator does.
Tolerance, and why: wire bytes are EXACTLY equal; the loss history agrees
to rtol 1e-5; params agree elementwise to atol 1e-5 + rtol 1e-4 on all but
at most 1e-3 of the elements (22 of 136940 on the LeNet round), and every
quantized weight lies within one top-bin grid step (alpha / 15) of the
reference. The exceptions are stochastic-rounding decisions that flip on
the wire when ``u`` falls between two values of ``y`` differing by a few ULP
(a flipped decision moves one client's element by one grid step; later
local steps then drift a little), and the first local step's clip
boundary: at ``alpha = max|w|`` the port's closed-form backward sends the
whole gradient of a boundary element to ``w`` where jnp autodiff splits it
0.5/0.5.
"""
import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core.engine import FedConfig as RCfg
from repro.core.fedsim import FedSim as RSim
from repro.core.qat import QATConfig as RQAT
from repro.core.qat import clip_value_mask as r_cvm
from repro.core.qat import weight_decay_mask as r_wdm
from repro.data import partition_iid as r_partition_iid
from repro.data import synthetic_classification as r_synth_cls
from repro.data import synthetic_images as r_synth_img
from repro.models import small as r_small
from repro_torch import convert, data as t_data, tree
from repro_torch import optim as t_optim
from repro_torch.core import engine as t_engine
from repro_torch.core.fedsim import FedSim as TSim
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.core.qat import clip_value_mask as t_cvm
from repro_torch.core.qat import weight_decay_mask as t_wdm
from repro_torch.models import small as t_small

REPO = os.path.join(os.path.dirname(__file__), "..")


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(torch.uint32)


def reference_draws(key, rounds, K, P, U, B, n_per):
    """The reference round's realized randomness, round by round."""
    out = []
    for _ in range(rounds):
        key, k_round = jax.random.split(key)
        k_sel, k_down, k_up, k_loc, _k_srv = jax.random.split(k_round, 5)
        cohort = np.asarray(jax.random.permutation(k_sel, K)[:P])
        batches = np.stack([
            np.stack([
                np.asarray(jax.random.randint(jax.random.split(k)[0], (B,), 0, n_per))
                for k in jax.random.split(k_loc_c, U)
            ])
            for k_loc_c in jax.random.split(k_loc, P)
        ])
        out.append(t_engine.RoundDraws(
            cohort=torch.from_numpy(cohort.astype(np.int64)),
            batches=torch.from_numpy(batches.astype(np.int64)),
            down_key=_u32(np.asarray(k_down)[:2]),
            up_keys=_u32(np.asarray(jax.random.split(k_up, P))[:, :2]),
        ))
    return out


def _data(model):
    if model == "mlp":
        x, y = r_synth_cls(0, 400, d=32, n_classes=10, noise=1.0)
    else:
        x, y = r_synth_img(0, 160, n_classes=10, noise=0.45)
    return x, y


def _run_pair(model, rounds, K=4, c=0.5, U=3, B=8, seed_key=7):
    x, y = _data(model)
    cx, cy, nk = r_partition_iid(x, y, k=K, seed=0)
    init, apply = r_small.REGISTRY[model]
    rp = init(jax.random.PRNGKey(0))
    base = dict(n_clients=K, participation=c, local_steps=U, batch_size=B,
                comm_mode="rand")
    ropt = r_optim.sgd(0.05, weight_decay=1e-3, wd_mask=r_wdm(rp), trust_mask=r_cvm(rp))
    rsim = RSim(rp, r_small.make_loss(apply), apply, ropt, RCfg(**base, qat=RQAT()),
                jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(nk))
    key = jax.random.PRNGKey(seed_key)
    evald = (x[:64], y[:64])
    rh = rsim.run(rounds, key, eval_data=tuple(map(jnp.asarray, evald)), eval_every=1)

    tp = convert.from_jax_params(jax.tree.map(np.asarray, rp), device="cpu")
    tapply = t_small.REGISTRY[model][1]
    topt = t_optim.sgd(0.05, weight_decay=1e-3, wd_mask=t_wdm(tp), trust_mask=t_cvm(tp))
    cfg = t_engine.FedConfig(**base, qat=TQAT())
    tsim = TSim(tp, t_small.make_loss(tapply), tapply, topt, cfg, cx, cy, nk,
                device="cpu")
    draws = reference_draws(key, rounds, K, cfg.clients_per_round, U, B, cx.shape[1])
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


@pytest.mark.parametrize("model,rounds", [("mlp", 2), ("lenet", 1)])
def test_uq_rounds_match_reference(model, rounds):
    rsim, rh, tsim, th = _run_pair(model, rounds)
    assert tsim.bytes_per_round == rsim.bytes_per_round
    assert th.cumulative_bytes == rh.cumulative_bytes
    assert th.rounds == rh.rounds
    np.testing.assert_allclose(th.loss, rh.loss, rtol=1e-5)
    _assert_params_close(tsim.params, rsim.params)


def test_torch_native_draws_are_deterministic_and_train():
    x, y = t_data.synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = t_data.partition_iid(x, y, k=4, seed=0)
    cfg = t_engine.FedConfig(n_clients=4, participation=0.5, local_steps=4, batch_size=8)

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


def test_data_copies_match_reference():
    from repro.data import partition_dirichlet as r_pd

    for t, r in ((t_data.synthetic_classification(3, 50), r_synth_cls(3, 50)),
                 (t_data.synthetic_images(3, 5), r_synth_img(3, 5))):
        for a, b in zip(t, r):
            np.testing.assert_array_equal(a, b)
    x, y = r_synth_cls(1, 300)
    for a, b in zip(t_data.partition_dirichlet(x, y, k=5, seed=2), r_pd(x, y, k=5, seed=2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t_data.partition_iid(x, y, k=5, seed=2), r_partition_iid(x, y, k=5, seed=2)):
        np.testing.assert_array_equal(a, b)


def test_fedconfig_rejects_unported_fields_and_bad_values():
    with pytest.raises(TypeError):
        t_engine.FedConfig(server_opt=object())
    with pytest.raises(ValueError, match="participation"):
        t_engine.FedConfig(participation=0.0)
    with pytest.raises(ValueError, match="comm_mode"):
        t_engine.FedConfig(comm_mode="fp4")
    with pytest.raises(TypeError):
        TQAT(bwd_fmt=None)
    with pytest.raises(ValueError, match="mode"):
        TQAT(mode="stochastic")


def test_entry_points_without_device_raise_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    p = t_small.init_mlp(0, device="cpu")
    opt = t_optim.sgd(0.05)
    cfg = t_engine.FedConfig(n_clients=2, participation=0.5, local_steps=1, batch_size=2)
    loss = t_small.make_loss(t_small.apply_mlp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.RoundEngine(loss, opt, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSim(p, loss, t_small.apply_mlp, opt, cfg, np.zeros((2, 4, 32), np.float32),
             np.zeros((2, 4), np.int32))


def test_chip_smoke_imports_nothing_of_jax_and_fails_without_a_card():
    path = os.path.join(REPO, "chip_smoke.py")
    src = open(path).read()
    mods = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")], mods
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run for real")
    out = subprocess.run([sys.executable, path], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
