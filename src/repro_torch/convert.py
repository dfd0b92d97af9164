"""Carry the reference's weights across to the port.

The port keeps the reference's param keys (``w``, ``w_qa``, ``x_qb``, ``b``,
``scale``, ``bias``) and layouts (dense ``(d_in, d_out)``, conv HWIO), so a
reference param tree converted to numpy (``jax.tree.map(np.asarray, p)``)
maps one to one onto the port's dict of tensors, and the wire's flat leaf
order and bytes line up.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device


def from_jax_params(np_tree, device="cuda") -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``."""
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.from_numpy(np.array(v, copy=True)).to(dev)

    return conv(np_tree)
