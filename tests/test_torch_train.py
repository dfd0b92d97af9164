"""The one-device trainer on the port against the live JAX reference: the
token pipeline (``data.pipeline``), momentum SGD, ``launch.steps``'
optimizer and train step as shipped (bf16, QAT on) at opt_level 0, 1 and 2
with one and two microbatches, the launches a step makes, and the
``launch.train`` driver. Weights are carried across by
``convert.from_jax_params``; the reference runs its kernel path
(``REPRO_KERNEL_BACKEND=interpret``), which the port mirrors.

Tolerances, and the mechanism behind each:

* token windows: exact.
* SGD and the optimizers: relative 1e-6 (XLA:CPU may contract a multiply
  and an add into one rounding, torch rounds twice).
* the step as shipped: the FP8 activation-tie mechanism of
  ``test_torch_lm`` (bf16 rounds otherwise in the two frameworks, and an
  activation on the other side of an FP8 midpoint moves its token row a
  grid step): after two steps of the trainer's momentum SGD the loss within
  2e-3, each weight, norm and embedding leaf's change within 0.25 of its
  magnitude sum (measured up to 0.14 on the first step's gradients), each
  clip's change within 0.25 of the largest clip change plus an f32 ULP of
  the clip a step (at opt_level 0 the LSQ-scaled clip changes are a few
  ULP of the clip). The tie-free check
  of the same step, weight-only QAT in f32, is in
  ``test_torch_plane_quant``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as r_configs
from repro import optim as r_optim
from repro.core import qat as r_qat
from repro.core.qat import QATConfig as RQAT
from repro.data.pipeline import LMBatcher as RBatcher
from repro.data.pipeline import silo_stream as r_stream
from repro.launch import steps as r_steps
from repro.models.registry import get_model as r_get_model
from repro_torch import configs as t_configs
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.core import qat as t_qat
from repro_torch.core.qat import QATConfig as TQAT
from repro_torch.data import LMBatcher as TBatcher
from repro_torch.data import silo_stream as t_stream
from repro_torch.kernels import fp8_matmul, fp8_quant
from repro_torch.launch import steps as t_steps
from repro_torch.launch import train as t_train
from repro_torch.models import registry as t_registry

ARCH = "tinyllama_1_1b"
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def kernel_path(monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


def _f64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().double().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32), np.float64)


def _pair():
    rcfg = r_configs.reduced(r_configs.get(ARCH))
    tcfg = t_configs.reduced(t_configs.get(ARCH))
    rp = r_get_model(rcfg).init(jax.random.PRNGKey(0))
    return rcfg, tcfg, rp, convert.from_jax_params(_np_tree(rp), device="cpu")


# ---------------------------------------------------------------------------
# data and optimizers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,n_tokens,silo,seed,batch,seq", [
    (256, 4 * 65 * 64, 0, 0, 4, 64), (32000, 8 * 129 * 3, 2, 5, 8, 128),
    (100, 1000, 1, 3, 3, 17)])
def test_lm_batcher_and_silo_stream_match_window_for_window(vocab, n_tokens, silo, seed,
                                                            batch, seq):
    rs, ts = r_stream(vocab, n_tokens, silo, seed), t_stream(vocab, n_tokens, silo, seed)
    np.testing.assert_array_equal(ts, rs)
    rb, tb = RBatcher(rs, batch, seq), TBatcher(ts, batch, seq)
    assert tb.n_batches == rb.n_batches
    for step in range(tb.n_batches + 2):      # wraps around past the last window
        r, t = rb(step), tb(step)
        for k in ("tokens", "labels"):
            assert t[k].dtype == np.int32 and t[k].shape == (batch, seq)
            np.testing.assert_array_equal(t[k], r[k])


@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_momentum_sgd_matches_the_reference(nesterov, weight_decay):
    _, _, rp, tp = _pair()
    args = dict(momentum=0.9, weight_decay=weight_decay, nesterov=nesterov,
                trust_frac=0.02)
    ropt = r_optim.sgd(0.05, wd_mask=r_qat.weight_decay_mask(rp),
                       trust_mask=r_qat.clip_value_mask(rp), **args)
    topt = t_optim.sgd(0.05, wd_mask=t_qat.weight_decay_mask(tp),
                       trust_mask=t_qat.clip_value_mask(tp), **args)
    rs, ts = ropt.init(rp), topt.init(tp)
    assert all(t.dtype == torch.float32 and not t.any() for t in tree.leaves(ts))
    rng = np.random.default_rng(int(nesterov) + 2 * int(weight_decay > 0))
    for step in range(3):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         _np_tree(rp))
        rupd, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp, step)
        tupd, ts = topt.update(convert.from_jax_params(g, device="cpu"), ts, tp, step)
        for (n, r), (_, t) in zip(tree.flatten(_np_tree(rupd)), tree.flatten(tupd)):
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=1e-9, err_msg=n)
        for (n, r), (_, t) in zip(tree.flatten(_np_tree(rs)), tree.flatten(ts)):
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-6, atol=1e-9, err_msg=n)


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_make_optimizer_is_the_reference_optimizer(kind):
    """The same masks (weight decay on >= 2-D weights, the trust region on
    the clips) and hyperparameters: two updates agree."""
    _, _, rp, tp = _pair()
    ropt = r_steps.make_optimizer(jax.eval_shape(lambda: rp), kind=kind, lr=1e-3)
    topt = t_steps.make_optimizer(tp, kind=kind, lr=1e-3)
    rs, ts = ropt.init(rp), topt.init(tp)
    rng = np.random.default_rng(7)
    for step in range(2):
        g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                         _np_tree(rp))
        rupd, rs = ropt.update(jax.tree.map(jnp.asarray, g), rs, rp,
                               jnp.asarray(step, jnp.int32))
        tupd, ts = topt.update(convert.from_jax_params(g, device="cpu"), ts, tp, step)
        for (n, r), (_, t) in zip(tree.flatten(_np_tree(rupd)), tree.flatten(tupd)):
            np.testing.assert_allclose(t.numpy(), r, rtol=1e-5, atol=1e-9, err_msg=n)


# ---------------------------------------------------------------------------
# the train step as shipped
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("opt_level,accum", [(0, 1), (0, 2), (1, 1), (1, 2), (2, 1), (2, 2)])
def test_train_step_as_shipped_matches_within_the_fp8_tie_mechanism(opt_level, accum):
    lr = 1e-3
    rcfg, tcfg, rp, tp = _pair()
    ropt = r_steps.make_optimizer(jax.eval_shape(lambda: rp), kind="sgd", lr=lr)
    topt = t_steps.make_optimizer(tp, kind="sgd", lr=lr)
    rstep = jax.jit(r_steps.make_train_step(r_get_model(rcfg), ropt, RQAT(), accum=accum,
                                            opt_level=opt_level))
    tstep = t_steps.make_train_step(t_registry.get_model(tcfg), topt, TQAT(), accum=accum,
                                    opt_level=opt_level)
    batcher = RBatcher(r_stream(rcfg.vocab, 4 * 65 * 64, 0, 0), 4, 64)
    r_state, t_state, r_new, t_new = ropt.init(rp), topt.init(tp), rp, tp
    for step in range(2):
        b = batcher(step)
        r_new, r_state, rm = rstep(r_new, r_state, {k: jnp.asarray(v) for k, v in b.items()},
                                   jnp.asarray(step, jnp.int32))
        t_new, t_state, tm = tstep(t_new, t_state, {k: torch.from_numpy(v) for k, v in b.items()},
                                   step)
        assert tm["loss"].dtype == torch.float32 and tm["loss"].dim() == 0
        assert abs(float(tm["loss"]) - float(rm["loss"])) <= 2e-3 * abs(float(rm["loss"]))
    r0, t0 = dict(tree.flatten(_np_tree(rp))), dict(tree.flatten(tp))
    r_delta = {n: v.astype(np.float64) - r0[n] for n, v in tree.flatten(_np_tree(r_new))}
    t_delta = {n: _f64(v) - _f64(t0[n]) for n, v in tree.flatten(t_new)}
    clip_scale = max(np.abs(v).max() for n, v in r_delta.items() if n.endswith(("_qa", "_qb")))
    for n, r in r_delta.items():
        assert dict(tree.flatten(t_new))[n].dtype == torch.float32, n
        if n == "embed_qa" and opt_level == 0:     # the gather: never quantized there
            assert not np.any(r) and not np.any(t_delta[n])
        elif n.endswith(("_qa", "_qb")):
            # each side adds its update to an f32 clip: one ULP of it per step
            ulp = 2 * np.spacing(np.abs(r0[n]).astype(np.float32)).astype(np.float64)
            assert np.all(np.abs(t_delta[n] - r) <= 0.25 * clip_scale + ulp), n
        else:
            assert np.abs(t_delta[n] - r).sum() <= 0.25 * np.abs(r).sum(), n


def _counting(monkeypatch, mod, names):
    counts = dict.fromkeys(names, 0)
    for name in names:
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _name=name, **k):
            counts[_name] += 1
            return _real(*a, **k)
        monkeypatch.setattr(mod, name, wrapped)
    return counts


@pytest.mark.parametrize("opt_level,accum", [(0, 2), (1, 1), (1, 2), (2, 2)])
def test_a_step_launches_the_plane_pair_once_whatever_accum(monkeypatch, opt_level, accum):
    """opt_level >= 1: one B7 forward and one B7 backward a step, B1/B2 at
    every activation site of every microbatch (7 projections a layer and
    the head once a CE chunk), no B10/B11. opt_level 0: the reverse."""
    _, tcfg, _, tp = _pair()
    quant = _counting(monkeypatch, fp8_quant, ["quant_det_tiles", "quant_det_tiles_bwd",
                                               "quant_det", "quant_det_bwd"])
    mm = _counting(monkeypatch, fp8_matmul, ["qat_matmul", "qat_matmul_dx", "qat_matmul_dw"])
    step = t_steps.make_train_step(t_registry.get_model(tcfg),
                                   t_steps.make_optimizer(tp, lr=1e-3), TQAT(), accum=accum,
                                   opt_level=opt_level)
    b = TBatcher(t_stream(tcfg.vocab, 4 * 65 * 64, 0, 0), 4, 64)
    params, state = tp, t_steps.make_optimizer(tp, lr=1e-3).init(tp)
    sites = 7 * tcfg.n_layers + tcfg.ce_chunks
    for i in range(2):
        params, state, m = step(params, state, {k: torch.from_numpy(v) for k, v in b(i).items()},
                                i)
        assert np.isfinite(float(m["loss"]))
        n = i + 1
        if opt_level >= 1:
            assert quant["quant_det_tiles"] == quant["quant_det_tiles_bwd"] == n
            assert quant["quant_det"] == quant["quant_det_bwd"] == n * accum * sites
            assert set(mm.values()) == {0}
        else:
            assert quant["quant_det_tiles"] == quant["quant_det_tiles_bwd"] == 0
            assert quant["quant_det"] == quant["quant_det_bwd"] == 0
            assert set(mm.values()) == {n * accum * sites}


def test_the_plane_spec_is_built_once_per_trainer(monkeypatch):
    from repro_torch.core import plane as t_plane
    _, tcfg, _, tp = _pair()
    built = _counting(monkeypatch, t_plane, ["make_plane_spec"])
    opt = t_steps.make_optimizer(tp, lr=1e-3)
    step = t_steps.make_train_step(t_registry.get_model(tcfg), opt, TQAT())
    b = TBatcher(t_stream(tcfg.vocab, 4 * 17 * 8, 0, 0), 4, 16)
    params, state = tp, opt.init(tp)
    for i in range(3):
        params, state, _ = step(params, state, {k: torch.from_numpy(v) for k, v in b(i).items()},
                                i)
    assert built["make_plane_spec"] == 1


def test_quantize_once_is_the_identity_without_weight_qat():
    _, _, _, tp = _pair()
    for q in (t_qat.DISABLED, TQAT(quantize_weights=False)):
        out, qcfg = t_steps.quantize_params_once(tp, q)
        assert out is tp and qcfg is q
        out, qcfg = t_steps.quantize_params_once_per_leaf(tp, q)
        assert out is tp and qcfg is q
    with pytest.raises(ValueError, match="opt_level"):
        t_steps.make_train_step(None, None, TQAT(), opt_level=3)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


def test_trainer_runs_at_a_tiny_scale():
    logs = []
    out = t_train.run(reduced=True, steps=3, batch=4, seq=32, device="cpu", log=logs.append)
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"])) and out["tokens_per_step"] == 4 * 32
    assert out["n_params"] == 143844 and "143844 parameters" in logs[0]
    assert "peak_mem_bytes" not in out
    out0 = t_train.run(reduced=True, steps=2, batch=4, seq=32, device="cpu", opt_level=0,
                       qat=False, log=lambda s: None)
    assert all(np.isfinite(out0["losses"]))


def test_trainer_cli_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--reduced",
                          "--steps", "3", "--device", "cpu"], capture_output=True, text=True,
                         env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "step     1  loss" in res.stdout and res.stdout.strip().endswith("done")
    assert "batch 8 x 128 tokens, opt_level 1" in res.stdout


@pytest.mark.parametrize("argv,item", [(["--mesh", "pod"], "item 7"),
                                       (["--server-opt", "fedavgm"], "item 4"),
                                       (["--resume"], "item 6"),
                                       (["--ckpt-dir", "ckpt"], "item 6")])
def test_trainer_options_not_ported_raise(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        t_train.main(["--reduced", "--device", "cpu", *argv])


def test_trainer_defaults_are_the_reference_defaults():
    import inspect
    params = inspect.signature(t_train.run).parameters
    assert params["device"].default == "cuda"
    assert (params["steps"].default, params["batch"].default, params["seq"].default,
            params["lr"].default, params["opt_level"].default) == (50, 8, 128, 3e-4, 1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            t_train.run(reduced=True, steps=1)
