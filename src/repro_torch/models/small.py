"""The paper's own experiment models, the port of ``repro.models.small``.

All five of the reference's models: the MLP (test workhorse), LeNet with
GroupNorm (the paper's CIFAR model), the reduced ResNet with GroupNorm (the
stand-in for the paper's ResNet18), the MatchboxNet-style 1-D separable conv
net and the KWT-style tiny transformer (both keyword spotting). Params and
layouts match the reference so weights carry across through
``convert.from_jax_params``: dense weights are ``(d_in, d_out)``, conv
weights HWIO (1-D: WIO, depthwise ``(k, 1, C)``), activations NHWC (1-D:
NWC) at ``apply``'s boundary; convolutions permute to PyTorch's NCHW/OIHW
(NCW/OIW) internally and pad as XLA's ``"SAME"`` does. The ``_qa``/``_qb``
clipping values follow ``core.qat``.

``init_*(seed, ..., device)`` draws from a ``torch.Generator`` on the CPU
(reproducible across devices) and moves the params to ``device``;
``apply_*(params, x, qcfg, bits=None) -> logits``. ``bits`` is stochastic
QAT's :data:`core.qat.BitsFn`: every dense or conv layer is one weight
site, numbered 1, 2, ... in call order as the reference's site counter
(``_SITE``) numbers them, and in ``mode='rand'`` its weight quantizer takes
``bits(site, w.shape)``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.qat import BitsFn, QATConfig, alpha_like, aq, beta_init, wq
from ..device import resolve_device
from ..tree import tree_map


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _dense_init(g, d_in, d_out):
    w = torch.randn((d_in, d_out), generator=g) * float(np.sqrt(2.0 / d_in))
    return {"w": w, "w_qa": alpha_like(w), "b": torch.zeros(d_out)}


def _conv_init(g, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=g) * float(np.sqrt(2.0 / fan_in))
    return {"w": w, "w_qa": alpha_like(w), "b": torch.zeros(cout)}


def _gn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _to(params: dict, device) -> dict:
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(device=dev, dtype=torch.float32), params)


class _Sites:
    """Numbers the weight sites of one forward pass and fetches each site's
    random bits (None unless the weights are stochastically quantized)."""

    def __init__(self, qcfg: QATConfig, bits: BitsFn | None):
        self.n = 0
        self.bits = bits if qcfg.stochastic_weights else None

    def next(self, shape):
        self.n += 1
        return None if self.bits is None else self.bits(self.n, tuple(shape))


def _dense(p, x, qcfg, sites: _Sites):
    x = aq(x, p["x_qb"], qcfg) if "x_qb" in p else x
    return x @ wq(p["w"], p["w_qa"], qcfg, sites.next(p["w"].shape)) + p["b"]


def _same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial axis of ``n`` at kernel ``k``
    and stride ``s``: ``(lo, hi)``, the odd pixel at the end. A 3x3 stride-2
    conv on 32 pixels pads (0, 1), not PyTorch's symmetric (1, 1), which
    gives the same shape sampled one pixel off."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv(p, x, qcfg, sites: _Sites, stride=1):
    """``"SAME"`` conv of an NHWC activation with an HWIO kernel."""
    x = aq(x, p["x_qb"], qcfg) if "x_qb" in p else x
    w = wq(p["w"], p["w_qa"], qcfg, sites.next(p["w"].shape))
    (th, bh), (tw, bw) = (_same_pad(x.shape[1], w.shape[0], stride),
                          _same_pad(x.shape[2], w.shape[1], stride))
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if stride != 1:
        # oneDNN's CPU backward of a strided 1x1 conv on this channels-last
        # view of x frees memory twice (torch 2.13); a dense x takes another route
        xc = xc.contiguous()
    if th == bh and tw == bw:
        y = F.conv2d(xc, wc, stride=stride, padding=(th, tw))
    else:
        y = F.conv2d(F.pad(xc, (tw, bw, th, bh)), wc, stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"]


def _max_pool(x):
    """2x2 stride-2 VALID max pool of an NHWC activation."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def group_norm(p, x, groups=8, eps=1e-5):
    """GroupNorm over the channel-last axis with population variance, as
    the reference writes it (``min(groups, c)`` groups)."""
    c = x.shape[-1]
    g = min(groups, c)
    xg = x.reshape(*x.shape[:-1], g, c // g)
    dims = tuple(range(1, xg.dim() - 2)) + (xg.dim() - 1,)
    mean = xg.mean(dim=dims, keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=dims, keepdim=True)
    xg = (xg - mean) / torch.sqrt(var + eps)
    return xg.reshape(x.shape) * p["scale"] + p["bias"]


# ---------------------------------------------------------------------------
# MLP (unit/parity-test workhorse)
# ---------------------------------------------------------------------------


def init_mlp(seed=0, d_in=32, d_hidden=64, n_classes=10, depth=2, device="cuda"):
    g = _generator(seed)
    params = {}
    d = d_in
    for i in range(depth):
        layer = _dense_init(g, d, d_hidden)
        layer["x_qb"] = beta_init()
        params[f"fc{i}"] = layer
        d = d_hidden
    head = _dense_init(g, d, n_classes)
    head["x_qb"] = beta_init()
    params["head"] = head
    return _to(params, device)


def apply_mlp(params, x, qcfg: QATConfig, bits: BitsFn | None = None):
    sites = _Sites(qcfg, bits)
    h = x.reshape(x.shape[0], -1)
    i = 0
    while f"fc{i}" in params:
        h = torch.relu(_dense(params[f"fc{i}"], h, qcfg, sites))
        i += 1
    return _dense(params["head"], h, qcfg, sites)


# ---------------------------------------------------------------------------
# LeNet with GroupNorm (paper's CIFAR model)
# ---------------------------------------------------------------------------


def init_lenet(seed=0, in_ch=3, n_classes=10, device="cuda"):
    g = _generator(seed)
    params = {
        "conv1": {**_conv_init(g, 5, 5, in_ch, 6), "x_qb": beta_init()},
        "gn1": _gn_init(6),
        "conv2": {**_conv_init(g, 5, 5, 6, 16), "x_qb": beta_init()},
        "gn2": _gn_init(16),
        "fc1": {**_dense_init(g, 16 * 8 * 8, 120), "x_qb": beta_init()},
        "fc2": {**_dense_init(g, 120, 84), "x_qb": beta_init()},
        "head": {**_dense_init(g, 84, n_classes), "x_qb": beta_init()},
    }
    return _to(params, device)


def apply_lenet(params, x, qcfg: QATConfig, bits: BitsFn | None = None):
    # x: (B, 32, 32, C) float in [0, 1]
    sites = _Sites(qcfg, bits)
    h = torch.relu(group_norm(params["gn1"], _conv(params["conv1"], x, qcfg, sites)))
    h = _max_pool(h)
    h = torch.relu(group_norm(params["gn2"], _conv(params["conv2"], h, qcfg, sites)))
    h = _max_pool(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(_dense(params["fc1"], h, qcfg, sites))
    h = torch.relu(_dense(params["fc2"], h, qcfg, sites))
    return _dense(params["head"], h, qcfg, sites)


# ---------------------------------------------------------------------------
# Reduced ResNet (GroupNorm): the stand-in for the paper's ResNet18
# ---------------------------------------------------------------------------


def _block_init(g, cin, cout, stride):
    p = {
        "conv1": {**_conv_init(g, 3, 3, cin, cout), "x_qb": beta_init()},
        "gn1": _gn_init(cout),
        "conv2": {**_conv_init(g, 3, 3, cout, cout), "x_qb": beta_init()},
        "gn2": _gn_init(cout),
    }
    if stride != 1 or cin != cout:
        p["proj"] = {**_conv_init(g, 1, 1, cin, cout), "x_qb": beta_init()}
    return p


def init_resnet(seed=0, in_ch=3, n_classes=10, widths=(16, 32, 64), device="cuda"):
    g = _generator(seed)
    params = {
        "stem": {**_conv_init(g, 3, 3, in_ch, widths[0]), "x_qb": beta_init()},
        "gn0": _gn_init(widths[0]),
    }
    c = widths[0]
    for i, w in enumerate(widths, start=1):
        stride = 1 if w == widths[0] else 2
        params[f"block{i}a"] = _block_init(g, c, w, stride)
        params[f"block{i}b"] = _block_init(g, w, w, 1)
        c = w
    params["head"] = {**_dense_init(g, c, n_classes), "x_qb": beta_init()}
    return _to(params, device)


def _apply_block(p, x, qcfg, sites: _Sites):
    # a block downsamples exactly when it has a projection shortcut (the
    # widths grow monotonically); sites in the reference's order: conv1,
    # conv2, then proj
    stride = 2 if "proj" in p else 1
    h = torch.relu(group_norm(p["gn1"], _conv(p["conv1"], x, qcfg, sites, stride)))
    h = group_norm(p["gn2"], _conv(p["conv2"], h, qcfg, sites))
    if "proj" in p:
        x = _conv(p["proj"], x, qcfg, sites, stride)
    return torch.relu(h + x)


def apply_resnet(params, x, qcfg: QATConfig, bits: BitsFn | None = None):
    # x: (B, 32, 32, C)
    sites = _Sites(qcfg, bits)
    h = torch.relu(group_norm(params["gn0"], _conv(params["stem"], x, qcfg, sites)))
    i = 1
    while f"block{i}a" in params:
        h = _apply_block(params[f"block{i}a"], h, qcfg, sites)
        h = _apply_block(params[f"block{i}b"], h, qcfg, sites)
        i += 1
    return _dense(params["head"], h.mean(dim=(1, 2)), qcfg, sites)


# ---------------------------------------------------------------------------
# MatchboxNet-style 1-D separable conv net (keyword spotting)
# ---------------------------------------------------------------------------


def _conv1d_init(g, k, cin, cout, depthwise=False):
    if depthwise:
        w = torch.randn((k, 1, cin), generator=g) * float(np.sqrt(2.0 / k))
    else:
        w = torch.randn((k, cin, cout), generator=g) * float(np.sqrt(2.0 / (k * cin)))
    return {"w": w, "w_qa": alpha_like(w), "b": torch.zeros(cin if depthwise else cout)}


def _conv1d(p, x, qcfg, sites: _Sites, depthwise=False):
    """Stride-1 ``"SAME"`` conv of an NWC activation with a WIO kernel of odd
    width k, padded ``k // 2`` at both ends; a depthwise ``(k, 1, C)`` kernel
    convolves each channel alone."""
    x = aq(x, p["x_qb"], qcfg) if "x_qb" in p else x
    w = wq(p["w"], p["w_qa"], qcfg, sites.next(p["w"].shape))
    k = w.shape[0]
    assert k % 2 == 1, f"_conv1d takes an odd kernel width, got {k}"
    groups = x.shape[-1] if depthwise else 1
    y = F.conv1d(x.permute(0, 2, 1), w.permute(2, 1, 0), padding=k // 2, groups=groups)
    return y.permute(0, 2, 1) + p["b"]


def init_matchbox(seed=0, in_feats=64, channels=64, n_classes=35, blocks=3, device="cuda"):
    g = _generator(seed)
    params = {
        "stem": {**_conv1d_init(g, 11, in_feats, channels), "x_qb": beta_init()},
        "gn0": _gn_init(channels),
    }
    for i in range(blocks):
        params[f"dw{i}"] = {**_conv1d_init(g, 13, channels, channels, depthwise=True),
                            "x_qb": beta_init()}
        params[f"pw{i}"] = {**_conv1d_init(g, 1, channels, channels), "x_qb": beta_init()}
        params[f"gn{i + 1}"] = _gn_init(channels)
    params["head"] = {**_dense_init(g, channels, n_classes), "x_qb": beta_init()}
    return _to(params, device)


def apply_matchbox(params, x, qcfg: QATConfig, bits: BitsFn | None = None):
    # x: (B, T, F) mel-spectrogram-like features
    sites = _Sites(qcfg, bits)
    h = torch.relu(group_norm(params["gn0"], _conv1d(params["stem"], x, qcfg, sites)))
    i = 0
    while f"dw{i}" in params:
        r = _conv1d(params[f"dw{i}"], h, qcfg, sites, depthwise=True)
        r = _conv1d(params[f"pw{i}"], r, qcfg, sites)
        h = torch.relu(group_norm(params[f"gn{i + 1}"], r + h))
        i += 1
    return _dense(params["head"], h.mean(dim=1), qcfg, sites)


# ---------------------------------------------------------------------------
# KWT-style tiny transformer classifier (keyword spotting)
# ---------------------------------------------------------------------------


def init_kwt(seed=0, in_feats=64, d_model=64, n_heads=4, depth=2, n_classes=35,
             seq_len=32, device="cuda"):
    g = _generator(seed)
    params = {
        "embed": {**_dense_init(g, in_feats, d_model), "x_qb": beta_init()},
        "pos": torch.randn((seq_len + 1, d_model), generator=g) * 0.02,
        "cls": torch.zeros((1, 1, d_model)),
    }
    for i in range(depth):
        params[f"layer{i}"] = {
            "ln1": _gn_init(d_model),
            "qkv": {**_dense_init(g, d_model, 3 * d_model), "x_qb": beta_init()},
            "proj": {**_dense_init(g, d_model, d_model), "x_qb": beta_init()},
            "ln2": _gn_init(d_model),
            "fc1": {**_dense_init(g, d_model, 4 * d_model), "x_qb": beta_init()},
            "fc2": {**_dense_init(g, 4 * d_model, d_model), "x_qb": beta_init()},
        }
    params["head"] = {**_dense_init(g, d_model, n_classes), "x_qb": beta_init()}
    return _to(params, device)


def _layer_norm(p, x, eps=1e-5):
    """LayerNorm over the last axis with the population variance, as the
    reference writes it (``x.var(-1)``)."""
    mean = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mean) / torch.sqrt(var + eps) * p["scale"] + p["bias"]


def _kwt_layer(p, x, qcfg, sites: _Sites, n_heads=4):
    B, T, D = x.shape
    H = n_heads
    h = _layer_norm(p["ln1"], x)
    qkv = _dense(p["qkv"], h, qcfg, sites).reshape(B, T, 3, H, D // H)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    # plain einsums and a softmax, as the reference: a fused attention
    # kernel would change the arithmetic
    att = torch.einsum("bthd,bshd->bhts", q, k) / float(np.sqrt(D // H))
    att = torch.softmax(att, dim=-1)
    o = torch.einsum("bhts,bshd->bthd", att, v).reshape(B, T, D)
    x = x + _dense(p["proj"], o, qcfg, sites)
    h = _layer_norm(p["ln2"], x)
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(_dense(p["fc1"], h, qcfg, sites), approximate="tanh")
    return x + _dense(p["fc2"], h, qcfg, sites)


def apply_kwt(params, x, qcfg: QATConfig, bits: BitsFn | None = None, n_heads=4):
    # x: (B, T, F)
    sites = _Sites(qcfg, bits)
    h = _dense(params["embed"], x, qcfg, sites)
    cls = params["cls"].expand(h.shape[0], 1, h.shape[-1])
    h = torch.cat([cls, h], dim=1) + params["pos"][: h.shape[1] + 1]
    i = 0
    while f"layer{i}" in params:
        h = _kwt_layer(params[f"layer{i}"], h, qcfg, sites, n_heads)
        i += 1
    return _dense(params["head"], h[:, 0], qcfg, sites)


# ---------------------------------------------------------------------------
# Shared loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def make_loss(apply_fn):
    def loss(params, x, y, qcfg, bits=None):
        return softmax_xent(apply_fn(params, x, qcfg, bits=bits), y)

    return loss


REGISTRY = {
    "mlp": (init_mlp, apply_mlp),
    "lenet": (init_lenet, apply_lenet),
    "resnet": (init_resnet, apply_resnet),
    "matchbox": (init_matchbox, apply_matchbox),
    "kwt": (init_kwt, apply_kwt),
}
