"""The paper's own experiment models, the port of ``repro.models.small``.

This slice ports the MLP (test workhorse) and LeNet with GroupNorm (the
paper's CIFAR model). Params and layouts match the reference so weights
carry across through ``convert.from_jax_params``: dense weights are
``(d_in, d_out)``, conv weights HWIO, activations NHWC at ``apply``'s
boundary; convolutions permute to PyTorch's NCHW/OIHW internally. The
``_qa``/``_qb`` clipping values follow ``core.qat``.

``init_*(seed, ..., device)`` draws from a ``torch.Generator`` on the CPU
(reproducible across devices) and moves the params to ``device``;
``apply_*(params, x, qcfg) -> logits``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.qat import QATConfig, alpha_like, aq, beta_init, wq
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


def _dense(p, x, qcfg):
    x = aq(x, p["x_qb"], qcfg) if "x_qb" in p else x
    return x @ wq(p["w"], p["w_qa"], qcfg) + p["b"]


def _conv(p, x, qcfg):
    """Stride-1 "SAME" conv of an NHWC activation with an HWIO kernel."""
    x = aq(x, p["x_qb"], qcfg) if "x_qb" in p else x
    w = wq(p["w"], p["w_qa"], qcfg)
    kh, kw = w.shape[0], w.shape[1]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding=(kh // 2, kw // 2))
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


def apply_mlp(params, x, qcfg: QATConfig):
    h = x.reshape(x.shape[0], -1)
    i = 0
    while f"fc{i}" in params:
        h = torch.relu(_dense(params[f"fc{i}"], h, qcfg))
        i += 1
    return _dense(params["head"], h, qcfg)


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


def apply_lenet(params, x, qcfg: QATConfig):
    # x: (B, 32, 32, C) float in [0, 1]
    h = torch.relu(group_norm(params["gn1"], _conv(params["conv1"], x, qcfg)))
    h = _max_pool(h)
    h = torch.relu(group_norm(params["gn2"], _conv(params["conv2"], h, qcfg)))
    h = _max_pool(h)
    h = h.reshape(h.shape[0], -1)
    h = torch.relu(_dense(params["fc1"], h, qcfg))
    h = torch.relu(_dense(params["fc2"], h, qcfg))
    return _dense(params["head"], h, qcfg)


# ---------------------------------------------------------------------------
# Shared loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


def make_loss(apply_fn):
    def loss(params, x, y, qcfg):
        return softmax_xent(apply_fn(params, x, qcfg), y)

    return loss


REGISTRY = {
    "mlp": (init_mlp, apply_mlp),
    "lenet": (init_lenet, apply_lenet),
}
