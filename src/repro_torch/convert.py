"""Carry the reference's weights and optimizer state across to the port.

The port keeps the reference's param keys (``w``, ``w_qa``, ``x_qb``, ``b``,
``scale``, ``bias``, and KWT's ``pos``/``cls``) and layouts (dense
``(d_in, d_out)``, conv HWIO, KWT's ``(T + 1, D)`` positions and ``(1, 1, D)``
class token), so a reference param tree converted to numpy
(``jax.tree.map(np.asarray, p)``) maps one to one onto the port's dict of
tensors, and the wire's flat leaf order and bytes line up. The MLP, LeNet,
ResNet, MatchboxNet (1-D conv weights WIO, its depthwise ones (k, 1, C))
and KWT trees all convert this way.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.ef import ClientState
from .device import resolve_device
from .optim.adamw import AdamWState


def from_jax_params(np_tree, device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return conv(np_tree)


def from_jax_adamw_state(np_state, device="cuda") -> AdamWState:
    """The reference's ``AdamWState(mu, nu)`` (fields as numpy trees) ->
    the port's, each moment tree converted as :func:`from_jax_params`."""
    return AdamWState(mu=from_jax_params(np_state.mu, device),
                      nu=from_jax_params(np_state.nu, device))


def from_jax_client_state(np_state, device="cuda") -> ClientState:
    """The reference's error-feedback ``ClientState(resid)`` (``resid`` a numpy
    ``(n_clients, total)`` array) -> the port's, on ``device``; both lay a
    row out in the wire's quantized-leaf order."""
    return ClientState(resid=torch.from_numpy(
        np.array(np_state.resid, dtype=np.float32, copy=True)).to(resolve_device(device)))
