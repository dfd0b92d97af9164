"""Quantization-aware-training plumbing, the port of ``repro.core.qat``.

Convention (shared with the reference): learnable clipping values live
inside the parameter tree as siblings of the tensor they clip —

* weight ``foo`` (ndim >= 2)      -> clipping scalar ``foo_qa`` (alpha)
* activation site ``bar``         -> clipping scalar ``bar_qb`` (beta)

Biases, norm parameters and the clip values themselves are never
weight-quantized. This slice ports deterministic QAT only (the paper's
default, Remark 4): the reference's ``mode='rand'`` (the Table 2 ablation)
waits for the ``quant_rand`` kernel pair, so ``QATConfig`` has no ``mode``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fp8 import E4M3, FP8Format
from .. import tree

QA_SUFFIX = "_qa"
QB_SUFFIX = "_qb"


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """How fake-quantization is applied during local (on-device) training."""

    enabled: bool = True
    quantize_weights: bool = True
    quantize_acts: bool = True
    fmt: FP8Format = E4M3


DISABLED = QATConfig(enabled=False, quantize_weights=False, quantize_acts=False)


def is_clip_key(name: str) -> bool:
    return name.endswith(QA_SUFFIX) or name.endswith(QB_SUFFIX)


def alpha_like(w: torch.Tensor) -> torch.Tensor:
    """Paper's alpha init: per-tensor max |w|."""
    return torch.max(torch.abs(w)).to(torch.float32)


def beta_init(value: float = 4.0) -> torch.Tensor:
    """Activation clipping init (refined online by the learnable beta)."""
    return torch.tensor(value, dtype=torch.float32)


def _lsq_grad_scale(alpha: torch.Tensor, n_elements: int,
                    fmt: FP8Format) -> torch.Tensor:
    """LSQ gradient scaling (Esser et al. 2020) for learnable clip values.

    Forward value is unchanged up to f32 rounding of ``a*g + a*(1-g)``,
    which the reference computes the same way; the gradient is scaled by
    ``g = 1/sqrt(N * Q_max)``.
    """
    g = 1.0 / float(np.sqrt(max(n_elements, 1) * (2 ** (fmt.mant + 1) - 1)))
    return alpha * g + (alpha * (1.0 - g)).detach()


def wq(w: torch.Tensor, alpha: torch.Tensor, cfg: QATConfig) -> torch.Tensor:
    """Fake-quantize a weight tensor for the forward pass (QAT)."""
    if not (cfg.enabled and cfg.quantize_weights):
        return w
    from ..kernels import dispatch

    alpha = _lsq_grad_scale(alpha, w.numel(), cfg.fmt)
    return dispatch.quantize_det(w, alpha, cfg.fmt)


def aq(x: torch.Tensor, beta: torch.Tensor, cfg: QATConfig) -> torch.Tensor:
    """Fake-quantize an activation tensor (deterministic, its own clip beta)."""
    if not (cfg.enabled and cfg.quantize_acts):
        return x
    from ..kernels import dispatch

    beta = _lsq_grad_scale(beta, x.numel(), cfg.fmt)
    return dispatch.quantize_det(x, beta, cfg.fmt)


def quantized_leaf_names(params: dict) -> set[str]:
    """Dotted paths of weight leaves that get FP8-quantized for communication."""
    entries = dict(tree.flatten(params))
    return {
        dotted for dotted, leaf in entries.items()
        if not is_clip_key(dotted.rsplit(".", 1)[-1])
        and leaf.dim() >= 2 and dotted + QA_SUFFIX in entries
    }


def clip_value_mask(params: dict) -> dict:
    """True for learnable clipping values (alpha/beta leaves) — the
    optimizers' trust-region guard clamps their per-step update."""
    names = [n for n, _ in tree.flatten(params)]
    return tree.unflatten(names, [is_clip_key(n.rsplit(".", 1)[-1]) for n in names])


def weight_decay_mask(params: dict) -> dict:
    """True for leaves that receive weight decay (>=2-D weights only)."""
    flat = tree.flatten(params)
    return tree.unflatten(
        [n for n, _ in flat],
        [(not is_clip_key(n.rsplit(".", 1)[-1])) and leaf.dim() >= 2
         for n, leaf in flat],
    )
