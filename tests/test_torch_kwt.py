"""The port's KWT transformer, AdamW, converter and sequence data against
the JAX reference.

The same reference params go through both packages (``from_jax_params``);
the reference runs under ``jax.jit``, as its simulator runs it.

Tolerances, and why:
* forward with QAT off, or with weight QAT only: within 1e-5 of the
  largest logit (matmuls, einsums and the LayerNorm variance sum in
  another order; the largest gap seen over six seeds is 7.0e-7 of it);
* forward with full QAT: at every activation site the port's quantized
  values equal the reference kernel's quantization of the same site input
  (``interpret``), except adjacent-grid ties at most 1e-5 of elements, as
  ``test_torch_fp8``. A tie moves one activation code, which attention
  spreads over every later logit (seen: 0.3-0.67 on two of six seeds), so
  the logits are held to the QAT-off tolerance only when no site tied;
* gradients with QAT off: each leaf within 2e-5 of its largest gradient
  magnitude (sums in another order; the largest gap seen over five seeds is
  1.2e-6 of it), the loss at relative 1e-5 (seen: 3.5e-7);
* one AdamW step: relative 1e-6 (atol 1e-9): the same arithmetic, with the
  bias corrections' ``b^t`` from another ``pow``;
* ``synthetic_sequences``: identical arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import qat as r_qat
from repro.data import synthetic_sequences as r_synth_seq
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.core import qat as t_qat
from repro_torch.data import synthetic_sequences as t_synth_seq
from repro_torch.models import small as t_small

LOGIT_TOL = 1e-5          # of max |logit|
VALUE_RTOL = 4e-6
TIE_FRAC = 1e-5
GRAD_TOL = 2e-5          # of each leaf's max |grad|


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _setup(batch=3, seed=0, **kw):
    rp = r_small.init_kwt(jax.random.PRNGKey(seed), **kw)
    x = np.random.default_rng(seed).standard_normal((batch, 32, 64)).astype(np.float32)
    y = np.random.default_rng(seed + 1).integers(0, 35, batch).astype(np.int32)
    return rp, convert.from_jax_params(_np_tree(rp), device="cpu"), x, y


def test_synthetic_sequences_identical_to_reference():
    for seed, n, kw in ((0, 40, {}), (3, 17, dict(t=16, feats=8, n_classes=5, noise=0.9))):
        for a, b in zip(t_synth_seq(seed, n, **kw), r_synth_seq(seed, n, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_kwt_init_tree_matches_reference():
    rp = r_small.init_kwt(jax.random.PRNGKey(0))
    tp = t_small.init_kwt(0, device="cpu")
    rflat, tflat = dict(tree.flatten(_np_tree(rp))), dict(tree.flatten(tp))
    assert list(rflat) == list(tflat)
    for n, v in tflat.items():
        assert tuple(v.shape) == rflat[n].shape and v.dtype == torch.float32, n
    assert t_qat.quantized_leaf_names(tp) == r_qat.quantized_leaf_names(rp)
    assert float(tp["layer1"]["fc2"]["w_qa"]) == float(tp["layer1"]["fc2"]["w"].abs().max())


QAT = {"off": (r_qat.DISABLED, t_qat.DISABLED),
       "weights": (r_qat.QATConfig(quantize_acts=False), t_qat.QATConfig(quantize_acts=False)),
       "full": (r_qat.QATConfig(), t_qat.QATConfig())}


def _site_ties(monkeypatch, tp, x, tcfg) -> tuple[np.ndarray, int]:
    """Run the port's forward recording every activation site's input and
    output; return the logits and the number of elements whose quantized
    value is not the reference kernel's on the same input (ties)."""
    from repro.kernels import fp8_quant as r_kern

    sites = []
    real = t_small.aq

    def recording_aq(xx, beta, cfg):
        out = real(xx, beta, cfg)
        if not (cfg.enabled and cfg.quantize_acts):
            return out
        b = t_qat._lsq_grad_scale(beta, xx.numel(), cfg.fmt)
        sites.append((xx.detach().numpy(), b.detach().numpy(), out.detach().numpy()))
        return out

    monkeypatch.setattr(t_small, "aq", recording_aq)
    logits = t_small.apply_kwt(tp, torch.from_numpy(x), tcfg).detach().numpy()
    ties = 0
    for xx, b, out in sites:
        ref = np.asarray(r_kern.quant_det(jnp.asarray(xx), jnp.asarray(b), interpret=True))
        bad = np.abs(out.astype(np.float64) - ref) > VALUE_RTOL * np.abs(ref)
        assert int(bad.sum()) <= max(1, int(TIE_FRAC * ref.size))
        ties += int(bad.sum())
    assert len(sites) == 10 if tcfg.quantize_acts else not sites
    return logits, ties


@pytest.mark.parametrize("qat", ["off", "weights", "full"])
def test_kwt_forward_matches_reference(qat, monkeypatch):
    rp, tp, x, _ = _setup()
    rcfg, tcfg = QAT[qat]
    ref = np.asarray(jax.jit(lambda p, xx: r_small.apply_kwt(p, xx, rcfg))(
        rp, jnp.asarray(x)))
    port, ties = _site_ties(monkeypatch, tp, x, tcfg)
    assert port.shape == ref.shape == (3, 35)
    if ties == 0:
        np.testing.assert_allclose(port, ref, rtol=0, atol=LOGIT_TOL * np.abs(ref).max())
    else:
        assert np.all(np.isfinite(port))


def test_kwt_loss_and_grads_match_reference_without_qat():
    rp, tp, x, y = _setup(batch=2, depth=1)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda pp, xx, yy: r_small.make_loss(r_small.apply_kwt)(pp, xx, yy, r_qat.DISABLED)
    ))(rp, jnp.asarray(x), jnp.asarray(y))
    names, leaves = zip(*tree.flatten(tp))
    leaves = [l.requires_grad_() for l in leaves]
    loss = t_small.make_loss(t_small.apply_kwt)(
        tree.unflatten(list(names), leaves), torch.from_numpy(x), torch.from_numpy(y),
        t_qat.DISABLED)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    ref = dict(tree.flatten(_np_tree(rgrads)))
    for n, g in zip(names, grads):
        g = np.zeros_like(ref[n]) if g is None else g.numpy()
        np.testing.assert_allclose(g, ref[n], rtol=0, err_msg=n,
                                   atol=GRAD_TOL * np.abs(ref[n]).max())


def test_adamw_step_and_converted_state_match_reference():
    """Two reference AdamW steps make a non-zero state; the state converts
    across, and one more step agrees (decay mask and clip trust region on)."""
    rp, tp, _, _ = _setup(depth=1)

    def grads(seed):
        rng = np.random.default_rng(seed)
        return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                            _np_tree(rp))

    ropt = r_optim.adamw(1e-3, weight_decay=0.1, wd_mask=r_qat.weight_decay_mask(rp),
                         trust_mask=r_qat.clip_value_mask(rp))
    topt = t_optim.adamw(1e-3, weight_decay=0.1, wd_mask=t_qat.weight_decay_mask(tp),
                         trust_mask=t_qat.clip_value_mask(tp))
    rstate = ropt.init(rp)
    for step in range(2):
        _, rstate = ropt.update(jax.tree.map(jnp.asarray, grads(step)), rstate, rp,
                                jnp.asarray(step, jnp.int32))
    tstate = convert.from_jax_adamw_state(jax.tree.map(np.asarray, rstate), device="cpu")
    assert isinstance(tstate, t_optim.AdamWState)
    g = grads(2)
    rupd, rstate = ropt.update(jax.tree.map(jnp.asarray, g), rstate, rp,
                               jnp.asarray(2, jnp.int32))
    tupd, tstate = topt.update(convert.from_jax_params(g, device="cpu"), tstate, tp, 2)
    for port, ref in ((tupd, rupd), (tstate.mu, rstate.mu), (tstate.nu, rstate.nu)):
        ref = dict(tree.flatten(_np_tree(ref)))
        for n, v in tree.flatten(port):
            np.testing.assert_allclose(v.numpy(), ref[n], rtol=1e-6, atol=1e-9, err_msg=n)
    # a fresh state is all zeros and the first step (t = 1) matches too
    rupd0, _ = ropt.update(jax.tree.map(jnp.asarray, g), ropt.init(rp), rp,
                           jnp.asarray(0, jnp.int32))
    tupd0, _ = topt.update(convert.from_jax_params(g, device="cpu"), topt.init(tp), tp, 0)
    ref = dict(tree.flatten(_np_tree(rupd0)))
    for n, v in tree.flatten(tupd0):
        np.testing.assert_allclose(v.numpy(), ref[n], rtol=1e-6, atol=1e-9, err_msg=n)
