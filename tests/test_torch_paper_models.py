"""The paper's ResNet and MatchboxNet on the port against the JAX reference.

The same reference params go through both packages (``from_jax_params``),
at the tolerances of ``test_torch_models``: forward passes at rtol 1e-4 /
atol 1e-5 against the reference under ``jax.jit`` (convolutions sum in
another order; eager jnp takes another ``log2`` path), gradients at
``GRAD`` against the reference's kernel path (``REPRO_KERNEL_BACKEND=
interpret``: at ``alpha = max|w|`` init an element may sit on the clip
boundary, where the Pallas backward, like the port's, sends the whole
gradient to ``x`` while jnp autodiff splits it). Gradients run at reduced
width: the reference's eager ResNet ``value_and_grad`` takes half a minute,
and even jitted the full model adds nothing the narrow one does not check.

XLA's ``"SAME"`` padding puts a stride-2 conv's odd pixel at the end (a 3x3
stride-2 conv on 16 or 32 pixels pads (0, 1)); PyTorch's symmetric
``padding=1`` gives the same output shape sampled one pixel off, which only
a comparison against ``lax.conv_general_dilated`` shows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import qat as r_qat
from repro.models import small as r_small
from repro_torch import convert, tree
from repro_torch.core import qat as t_qat
from repro_torch.models import small as t_small

FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=2e-4, atol=2e-6)
# a site's input deep in the net: eight convolutions and GroupNorms of f32
# rounding (GroupNorm divides small differences by small deviations) put one
# of 16384 inputs of ResNet's ninth site 2.2e-5 from the reference's
SITE_IN = dict(rtol=1e-4, atol=1e-4)
REDUCED = {"resnet": dict(widths=(4, 8)), "matchbox": dict(channels=16, blocks=2)}


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _setup(name, batch=2, seed=0, **init_kw):
    rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(seed), **init_kw)
    rng = np.random.default_rng(seed)
    if name == "resnet":
        x = rng.uniform(0, 1, (batch, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, batch).astype(np.int32)
    else:
        x = rng.standard_normal((batch, 32, 64)).astype(np.float32)
        y = rng.integers(0, 35, batch).astype(np.int32)
    return rp, x, y


_CONV = {"resnet": "_conv", "matchbox": "_conv1d"}


def _ref_sites(name, rp, x, rcfg, monkeypatch):
    """The reference's logits under ``jax.jit`` and, in call order, each conv
    site's ``(kwargs, input, aq(input), output)``, captured in the trace."""
    orig = getattr(r_small, _CONV[name])
    cap = []

    def rec(p, xx, qcfg, *args, **kw):
        y = orig(p, xx, qcfg, *args, **kw)
        cap.append((xx, r_qat.aq(xx, p["x_qb"], qcfg), y))
        return y

    monkeypatch.setattr(r_small, _CONV[name], rec)

    def run(pp, xx):
        cap.clear()
        return r_small.REGISTRY[name][1](pp, xx, rcfg), list(cap)

    out, sites = jax.jit(run)(rp, jnp.asarray(x))
    monkeypatch.setattr(r_small, _CONV[name], orig)
    return np.asarray(out), [tuple(np.asarray(a) for a in site) for site in sites]


def _port_sites(name, tp, x, tcfg, monkeypatch):
    """The port's logits and, in call order, each conv site's ``(params,
    layout kwargs, input, aq(input), output)``."""
    orig = getattr(t_small, _CONV[name])
    cap = []

    def rec(p, xx, qcfg, sites, *args, **kw):
        y = orig(p, xx, qcfg, sites, *args, **kw)
        cap.append((p, args, kw, xx.detach(), t_qat.aq(xx, p["x_qb"], qcfg).detach(),
                    y.detach()))
        return y

    monkeypatch.setattr(t_small, _CONV[name], rec)
    out = t_small.REGISTRY[name][1](tp, torch.from_numpy(x), tcfg)
    monkeypatch.setattr(t_small, _CONV[name], orig)
    return out.detach().numpy(), cap


def _ties(tq, rq, rx):
    """Elements where the port's activation code differs from the
    reference's on the same input: each must be an adjacent-grid tie (the
    input within 2e-6 of the midpoint of the two grid points: the packages'
    log2/exp2 differ in the last bits), at most two of them."""
    ties = np.abs(tq - rq) > 1e-5 * np.abs(rq) + 1e-7
    mid = (tq[ties] + rq[ties]) / 2
    assert ties.sum() <= 2, f"{ties.sum()} activation codes differ"
    assert np.all(np.abs(rx[ties] - mid) <= 2e-6 * np.abs(mid)), (rx[ties], mid)
    return ties


def _check_site(name, p, args, kw, rx, rq, qat_on, rng=None):
    """One conv site on the reference's own site input ``rx`` (``rq`` its
    activation codes there), in two parts so that an activation tie cannot
    hide the rest: the activation quantizer alone (values at FWD but for
    ties), then the conv with its weight quantizer on the reference's
    quantized input (output at FWD). With ``rng`` also the VJPs at GRAD
    under cotangents drawn from it (zero at a tie): the quantizer's to its
    input and clip value, the conv's to its input, weight, bias and weight
    clip."""
    r_conv, t_conv = getattr(r_small, _CONV[name]), getattr(t_small, _CONV[name])
    pn = {k: v.detach().numpy() for k, v in p.items()}
    if qat_on:
        xt = torch.from_numpy(rx).requires_grad_()
        bt = p["x_qb"].detach().clone().requires_grad_()
        tq = t_qat.aq(xt, bt, t_qat.QATConfig())
        ties = _ties(tq.detach().numpy(), rq, rx)
        np.testing.assert_allclose(tq.detach().numpy()[~ties], rq[~ties], **FWD)
        if rng is not None:
            ct = rng.standard_normal(rx.shape).astype(np.float32) * ~ties
            _, vjp = jax.vjp(jax.jit(lambda xx, bb: r_qat.aq(xx, bb, r_qat.QATConfig())),
                             jnp.asarray(rx), jnp.asarray(pn["x_qb"]))
            got = torch.autograd.grad(tq, [xt, bt], torch.from_numpy(ct))
            for k, g, w in zip(("x", "x_qb"), got, vjp(jnp.asarray(ct))):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k, **GRAD)
    rcfg = r_qat.QATConfig(quantize_acts=False) if qat_on else r_qat.DISABLED
    tcfg = t_qat.QATConfig(quantize_acts=False) if qat_on else t_qat.DISABLED
    r_kw = {**kw, **({"stride": args[0]} if args else {})}
    ry, vjp = jax.vjp(jax.jit(lambda pp, xx: r_conv(pp, xx, rcfg, **r_kw)),
                      jax.tree.map(jnp.asarray, pn), jnp.asarray(rq))
    pt = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in pn.items()}
    xt = torch.from_numpy(rq).requires_grad_()
    y = t_conv(pt, xt, tcfg, t_small._Sites(tcfg, None), *args, **kw)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ry), **FWD)
    if rng is not None:
        ct = rng.standard_normal(y.shape).astype(np.float32)
        rgp, rgx = vjp(jnp.asarray(ct))
        names = [k for k in pt if k != "x_qb"]
        got = torch.autograd.grad(y, [xt, *(pt[k] for k in names)], torch.from_numpy(ct))
        for k, g, w in zip(["x", *names], got, [rgx, *(rgp[k] for k in names)]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=k, **GRAD)


@pytest.mark.parametrize("name", ["resnet", "matchbox"])
@pytest.mark.parametrize("qat_on", [True, False])
def test_forward_matches_reference(name, qat_on, monkeypatch):
    """Logits at FWD (each conv site alone: ``test_site_vjps_match_reference``).
    Site inputs agree at SITE_IN up to the first activation code that
    differs: an adjacent-grid tie (ROADMAP §3; the convolutions sum in
    another order, so a site input may land a few ULP on the other side of a
    grid midpoint). Where one occurs (on these
    ResNet inputs one code of block 1b's first conv input does), at most two
    codes differ, each input within 2e-6 of its midpoint, and the logits,
    now a grid step apart at one input, are not compared."""
    rp, x, _ = _setup(name)
    rcfg = r_qat.QATConfig() if qat_on else r_qat.DISABLED
    tcfg = t_qat.QATConfig() if qat_on else t_qat.DISABLED
    ref, rsites = _ref_sites(name, rp, x, rcfg, monkeypatch)
    tp = convert.from_jax_params(_np_tree(rp), device="cpu")
    port, tsites = _port_sites(name, tp, x, tcfg, monkeypatch)
    assert port.shape == ref.shape == (2, 10 if name == "resnet" else 35)
    assert len(rsites) == len(tsites) > 0
    tie = None
    for i, ((rx, rq, _), (_, _, _, tx, tq, _)) in enumerate(zip(rsites, tsites)):
        np.testing.assert_allclose(tx.numpy(), rx, err_msg=f"site {i} input", **SITE_IN)
        if qat_on and _ties(tq.numpy(), rq, rx).any():
            tie = i
            break
    if tie is None:
        np.testing.assert_allclose(port, ref, **FWD)


@pytest.mark.parametrize("name", ["resnet", "matchbox"])
def test_loss_and_grads_match_reference(name, monkeypatch):
    """The whole model's loss and every gradient at reduced width with the
    weights quantized (the activation quantizers' ties, which would move
    every gradient behind them by a grid step, are left to the per-site
    test below)."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    rp, x, y = _setup(name, **REDUCED[name])
    apply = r_small.REGISTRY[name][1]
    rcfg, tcfg = r_qat.QATConfig(quantize_acts=False), t_qat.QATConfig(quantize_acts=False)
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda pp, xx, yy: r_small.make_loss(apply)(pp, xx, yy, rcfg)
    ))(rp, jnp.asarray(x), jnp.asarray(y))
    tp = convert.from_jax_params(_np_tree(rp), device="cpu")
    names, leaves = zip(*tree.flatten(tp))
    leaves = [leaf.requires_grad_() for leaf in leaves]
    loss = t_small.make_loss(t_small.REGISTRY[name][1])(
        tree.unflatten(list(names), leaves), torch.from_numpy(x), torch.from_numpy(y), tcfg)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(loss.item(), float(rloss), rtol=1e-5)
    ref = dict(tree.flatten(_np_tree(rgrads)))
    assert set(ref) == set(names)
    for n, leaf, g in zip(names, leaves, grads):
        g = torch.zeros_like(leaf) if g is None else g   # x_qb: no activation quantizer
        np.testing.assert_allclose(g.numpy(), ref[n], err_msg=n, **GRAD)


@pytest.mark.parametrize("name", ["resnet", "matchbox"])
def test_site_vjps_match_reference(name, monkeypatch):
    """Every conv site with both quantizers on, at reduced width, on the
    reference's own site inputs (the whole net's forward, jitted), as
    ``_check_site`` holds it: values at FWD, VJPs at GRAD against the
    reference's kernel path."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    rp, x, _ = _setup(name, **REDUCED[name])
    _, rsites = _ref_sites(name, rp, x, r_qat.QATConfig(), monkeypatch)
    tp = convert.from_jax_params(_np_tree(rp), device="cpu")
    _, tsites = _port_sites(name, tp, x, t_qat.QATConfig(), monkeypatch)
    assert len(rsites) == len(tsites)
    rng = np.random.default_rng(7)
    for (rx, rq, _), (p, args, kw, _, _, _) in zip(rsites, tsites):
        _check_site(name, p, args, kw, rx, rq, True, rng)


@pytest.mark.parametrize("name", ["resnet", "matchbox"])
def test_init_tree_and_masks_match_reference(name):
    rp = r_small.REGISTRY[name][0](jax.random.PRNGKey(0))
    tp = t_small.REGISTRY[name][0](0, device="cpu")
    rflat = dict(tree.flatten(_np_tree(rp)))
    tflat = dict(tree.flatten(tp))
    assert list(rflat) == list(tflat)
    for n, v in tflat.items():
        assert tuple(v.shape) == rflat[n].shape and v.dtype == torch.float32, n
    # a projection exactly where a block downsamples; alpha = max|w| at init
    assert [k for k, v in tp.items() if "proj" in v] == (
        ["block2a", "block3a"] if name == "resnet" else [])
    assert float(tp["stem"]["w_qa"]) == float(tp["stem"]["w"].abs().max())
    assert t_qat.quantized_leaf_names(tp) == r_qat.quantized_leaf_names(rp)
    for rmask, tmask in ((r_qat.clip_value_mask, t_qat.clip_value_mask),
                         (r_qat.weight_decay_mask, t_qat.weight_decay_mask)):
        assert tree.flatten(tmask(tp)) == list(
            tree.flatten(jax.tree.map(bool, rmask(rp))))
    # every leaf's init scale as the reference draws it (He normal, zero biases)
    for n, v in tflat.items():
        if n.endswith(".w"):
            np.testing.assert_allclose(float(v.std()), float(rflat[n].std()), rtol=0.35,
                                       err_msg=n)
        elif n.endswith(".b"):
            assert not v.any(), n


@pytest.mark.parametrize("hw", [16, 15])
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_lax(hw, k, stride):
    """``_conv`` against ``lax.conv_general_dilated(..., "SAME")`` with the
    quantizers off: at 16 pixels a stride-2 3x3 conv pads (0, 1), at 15 (1, 1)."""
    rng = np.random.default_rng(hw * 100 + k * 10 + stride)
    x = rng.standard_normal((2, hw, hw, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + b
    p = {"w": torch.from_numpy(w), "w_qa": torch.tensor(1.0), "b": torch.from_numpy(b)}
    port = t_small._conv(p, torch.from_numpy(x), t_qat.DISABLED,
                         t_small._Sites(t_qat.DISABLED, None), stride)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)
    if (hw, k, stride) == (16, 3, 2):
        assert t_small._same_pad(hw, k, stride) == (0, 1)
    if (hw, k, stride) == (15, 3, 2):
        assert t_small._same_pad(hw, k, stride) == (1, 1)


@pytest.mark.parametrize("k,depthwise", [(11, False), (13, True), (1, False), (3, True)])
def test_conv1d_same_padding_matches_lax(k, depthwise):
    """``_conv1d`` against ``lax.conv_general_dilated`` (NWC, WIO, stride 1,
    ``"SAME"``), depthwise as ``feature_group_count = C``, at the odd widths
    the models use and one more."""
    rng = np.random.default_rng(k)
    c = 6
    x = rng.standard_normal((2, 9, c)).astype(np.float32)
    w = rng.standard_normal((k, 1, c) if depthwise else (k, c, 5)).astype(np.float32)
    b = rng.standard_normal(c if depthwise else 5).astype(np.float32)
    ref = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1,), "SAME",
        dimension_numbers=("NWC", "WIO", "NWC"),
        feature_group_count=c if depthwise else 1)) + b
    p = {"w": torch.from_numpy(w), "w_qa": torch.tensor(1.0), "b": torch.from_numpy(b)}
    port = t_small._conv1d(p, torch.from_numpy(x), t_qat.DISABLED,
                           t_small._Sites(t_qat.DISABLED, None), depthwise=depthwise)
    np.testing.assert_allclose(port.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_lenet_conv_path_unchanged():
    """LeNet's stride-1 5x5 convs pad (2, 2) symmetrically and so take the
    one-call ``padding=`` route, as before the strided route existed."""
    assert t_small._same_pad(32, 5, 1) == (2, 2) and t_small._same_pad(16, 5, 1) == (2, 2)


@pytest.mark.parametrize("name", ["resnet"])
def test_stochastic_qat_sites_follow_the_reference_order(name, monkeypatch):
    """Stochastic QAT: the port's site numbers are the reference's ``_SITE``
    numbers. The reference's kernel path draws each weight site's bits from
    ``fold_in(key, site)``; the port's provider replays the same bits for the
    number it is handed, so the logits agree only if both number the sites
    alike (ResNet: stem, then each block's conv1, conv2 and proj)."""
    monkeypatch.setenv("REPRO_KERNEL_BACKEND", "interpret")
    rp, x, _ = _setup(name, **REDUCED[name])
    key = jax.random.PRNGKey(5)
    rcfg = r_qat.QATConfig(mode="rand")
    ref = np.asarray(jax.jit(lambda pp, xx: r_small.REGISTRY[name][1](pp, xx, rcfg, key=key))(
        rp, jnp.asarray(x)))
    seen = []

    def bits(site, shape):
        seen.append((site, shape))
        b = jax.random.bits(jax.random.fold_in(key, site), shape=shape, dtype=jnp.uint32)
        return torch.from_numpy(np.asarray(b).astype(np.int64)).to(torch.uint32)

    tp = convert.from_jax_params(_np_tree(rp), device="cpu")
    port = t_small.REGISTRY[name][1](tp, torch.from_numpy(x), t_qat.QATConfig(mode="rand"),
                                     bits=bits)
    np.testing.assert_allclose(port.detach().numpy(), ref, **FWD)
    if name == "resnet":
        blocks = [k for k in tp if k.startswith("block")]
        calls = ["stem"] + [f"{b}.{c}" for b in blocks
                            for c in ("conv1", "conv2", "proj") if c in tp[b]] + ["head"]
    else:
        blocks = [k[2:] for k in tp if k.startswith("dw")]
        calls = ["stem"] + [f"{c}{i}" for i in blocks for c in ("dw", "pw")] + ["head"]
    flat = dict(tree.flatten(tp))
    assert [s for s, _ in seen] == list(range(1, len(calls) + 1))
    assert [shape for _, shape in seen] == [tuple(flat[c + ".w"].shape) for c in calls]
