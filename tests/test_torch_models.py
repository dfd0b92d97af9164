"""The port's models, masks and optimizer against the JAX reference.

The same reference params go through both packages (``from_jax_params``).
Forward passes compare at rtol 1e-4 / atol 1e-5 (convolutions and matmuls
sum in another order) against the reference under ``jax.jit``, as its
simulator runs it: op-by-op eager dispatch takes another ``log2`` path,
and on these LeNet inputs one activation code ties to its grid neighbour
there, moving the logits by 0.06. Gradients run the reference with
``REPRO_KERNEL_BACKEND=interpret``: at ``alpha = max|w|`` init an element may
sit on the clip boundary, where the Pallas backward (like the port's
kernel) sends the whole gradient to ``x`` while jnp autodiff splits it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.core import qat as r_qat
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch import optim as t_optim
from repro_torch.core import qat as t_qat
from repro_torch.models import small as t_small

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-6)


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _setup(name, batch=2, seed=0):
    init, apply = r_small.REGISTRY[name]
    p = init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    if name == "lenet":
        x = rng.uniform(0, 1, (batch, 32, 32, 3)).astype(np.float32)
    else:
        x = rng.standard_normal((batch, 32)).astype(np.float32)
    y = rng.integers(0, 10, batch).astype(np.int32)
    return p, apply, x, y


@pytest.mark.parametrize("name", ["mlp", "lenet"])
@pytest.mark.parametrize("qat_on", [True, False])
def test_forward_matches_reference(name, qat_on):
    p, apply, x, _ = _setup(name)
    rcfg = r_qat.QATConfig() if qat_on else r_qat.DISABLED
    tcfg = t_qat.QATConfig() if qat_on else t_qat.DISABLED
    ref = np.asarray(jax.jit(lambda pp, xx: apply(pp, xx, rcfg))(p, jnp.asarray(x)))
    tp = convert.from_jax_params(_np_tree(p), device="cpu")
    port = t_small.REGISTRY[name][1](tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(port.detach().numpy(), ref, **FWD)


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_loss_and_grads_match_reference(name, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    p, apply, x, y = _setup(name)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda pp, xx, yy: r_small.make_loss(apply)(pp, xx, yy, r_qat.QATConfig())
    ))(p, jnp.asarray(x), jnp.asarray(y))
    tp = convert.from_jax_params(_np_tree(p), device="cpu")
    names, leaves = zip(*tree.flatten(tp))
    leaves = [l.requires_grad_() for l in leaves]
    loss = t_small.make_loss(t_small.REGISTRY[name][1])(
        tree.unflatten(list(names), leaves), torch.from_numpy(x),
        torch.from_numpy(y), t_qat.QATConfig())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    ref = dict(tree.flatten(_np_tree(rgrads)))
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), ref[n], err_msg=n, **GRAD)


def test_group_norm_and_xent_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 5, 16)).astype(np.float32)
    p = {"scale": rng.standard_normal(16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    ref = np.asarray(r_small.group_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x)))
    port = t_small.group_norm({k: torch.from_numpy(v) for k, v in p.items()},
                              torch.from_numpy(x))
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    logits = rng.standard_normal((6, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 6).astype(np.int32)
    np.testing.assert_allclose(
        float(t_small.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(r_small.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_init_tree_and_masks_match_reference(name):
    rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(0))
    tp = t_small.REGISTRY[name][0](0, device="cpu")
    rflat = dict(tree.flatten(_np_tree(rp)))
    tflat = dict(tree.flatten(tp))
    assert list(rflat) == list(tflat)
    for n, v in tflat.items():
        assert tuple(v.shape) == rflat[n].shape and v.dtype == torch.float32, n
    # alpha = max|w| at init, beta = 4
    assert float(tp["head"]["w_qa"]) == float(tp["head"]["w"].abs().max())
    assert float(tp["head"]["x_qb"]) == 4.0
    assert t_qat.quantized_leaf_names(tp) == r_qat.quantized_leaf_names(rp)
    for rmask, tmask in ((r_qat.clip_value_mask, t_qat.clip_value_mask),
                         (r_qat.weight_decay_mask, t_qat.weight_decay_mask)):
        assert tree.flatten(tmask(tp)) == list(
            tree.flatten(jax.tree.map(bool, rmask(rp))))


def test_sgd_update_matches_reference():
    p, _, _, _ = _setup("mlp")
    g = jax.tree.map(lambda a: jnp.asarray(
        np.random.default_rng(a.size).standard_normal(a.shape).astype(np.float32)), p)
    ropt = r_optim.sgd(0.05, weight_decay=1e-3, wd_mask=r_qat.weight_decay_mask(p),
                       trust_mask=r_qat.clip_value_mask(p))
    rupd, _ = ropt.update(g, ropt.init(p), p, 0)
    rnew = r_optim.apply_updates(p, rupd)
    tp = convert.from_jax_params(_np_tree(p), device="cpu")
    tg = convert.from_jax_params(_np_tree(g), device="cpu")
    topt = t_optim.sgd(0.05, weight_decay=1e-3, wd_mask=t_qat.weight_decay_mask(tp),
                       trust_mask=t_qat.clip_value_mask(tp))
    tupd, _ = topt.update(tg, topt.init(tp), tp, 0)
    tnew = t_optim.apply_updates(tp, tupd)
    ref = dict(tree.flatten(_np_tree(rnew)))
    for n, v in tree.flatten(tnew):
        np.testing.assert_array_equal(v.numpy(), ref[n], err_msg=n)


def test_init_without_device_raises_on_cpu_only_host():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_small.init_lenet(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.from_jax_params({"w": np.zeros((2, 2), np.float32)})


def test_sgd_takes_the_reference_positional_order():
    """``sgd(lr, momentum, weight_decay, wd_mask, nesterov, trust_mask,
    trust_frac)`` as in the reference: ``sgd(0.1, 0.9)`` is momentum 0.9 (not
    weight decay 0.9), and ``trust_frac`` is honoured."""
    p, _, _, _ = _setup("mlp")
    tp0 = convert.from_jax_params(_np_tree(p), device="cpu")
    ropt, topt = r_optim.sgd(0.1, 0.9), t_optim.sgd(0.1, 0.9)
    g0 = jax.tree.map(lambda a: jnp.ones(a.shape, jnp.float32), p)
    (r1, rs), (t1, ts) = (ropt.update(g0, ropt.init(p), p, 0),
                          topt.update(convert.from_jax_params(_np_tree(g0), device="cpu"),
                                      topt.init(tp0), tp0, 0))
    r2, _ = ropt.update(g0, rs, p, 1)
    t2, _ = topt.update(convert.from_jax_params(_np_tree(g0), device="cpu"), ts, tp0, 1)
    for rupd, tupd, want in ((r1, t1, -0.1), (r2, t2, -0.1 * 1.9)):
        ref = dict(tree.flatten(_np_tree(rupd)))
        for n, v in tree.flatten(tupd):
            np.testing.assert_array_equal(v.numpy(), ref[n], err_msg=n)
            if not n.endswith(("_qa", "_qb")):   # clip updates sit in the trust region
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-6, err_msg=n)
    g = jax.tree.map(lambda a: jnp.asarray(
        np.random.default_rng(a.size + 1).standard_normal(a.shape).astype(np.float32)), p)
    args = (0.0, 1e-3, r_qat.weight_decay_mask(p), False, r_qat.clip_value_mask(p), 0.005)
    ropt = r_optim.sgd(0.05, *args)
    rupd, _ = ropt.update(g, ropt.init(p), p, 0)
    tp = convert.from_jax_params(_np_tree(p), device="cpu")
    tg = convert.from_jax_params(_np_tree(g), device="cpu")
    targs = (0.0, 1e-3, t_qat.weight_decay_mask(tp), False, t_qat.clip_value_mask(tp), 0.005)
    topt = t_optim.sgd(0.05, *targs)
    tupd, _ = topt.update(tg, topt.init(tp), tp, 0)
    ref = dict(tree.flatten(_np_tree(rupd)))
    for n, v in tree.flatten(tupd):
        np.testing.assert_array_equal(v.numpy(), ref[n], err_msg=n)
    # the trust region bites at 0.005: some clip update sits on its limit
    clipped = [n for n, v in tree.flatten(tupd) if n.endswith(("_qa", "_qb"))
               and float(v.abs()) == pytest.approx(
                   0.005 * float(dict(tree.flatten(tp))[n].abs()), rel=1e-6)]
    assert clipped
