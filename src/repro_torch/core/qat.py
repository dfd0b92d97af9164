"""Quantization-aware-training plumbing, the port of ``repro.core.qat``.

Convention (shared with the reference): learnable clipping values live
inside the parameter tree as siblings of the tensor they clip —

* weight ``foo`` (ndim >= 2)      -> clipping scalar ``foo_qa`` (alpha)
* activation site ``bar``         -> clipping scalar ``bar_qb`` (beta)

Biases, norm parameters and the clip values themselves are never
weight-quantized. ``mode='det'`` is the paper's default (Remark 4);
``mode='rand'`` (the Table 2 ablation) quantizes each WEIGHT stochastically
through the ``quant_rand`` kernel pair (activations stay deterministic, as
in the reference).

Stochastic QAT needs random bits at every weight site. The reference draws
them inside the model from ``jax.random.bits(fold_in(key, site))``
(``models/small.py:42-49``); here the model is handed a :data:`BitsFn`,
``bits(site, shape)``, with sites numbered 1, 2, ... in the order the
forward pass reaches them, as the reference's site counter does. It returns
the site's u32 bits of ``shape``, or a ``kernels.ref.CounterKey`` from which
the kernels draw them. The engine's default hands out counter keys; parity
tests replay the reference's bits through the same hook.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from .fp8 import E4M3, FP8Format
from .. import tree

QA_SUFFIX = "_qa"
QB_SUFFIX = "_qb"
MODES = ("det", "rand")

BitsFn = Callable[[int, tuple], Any]  # (site, shape) -> u32 bits or a ref.CounterKey


@dataclasses.dataclass(frozen=True)
class QATConfig:
    """How fake-quantization is applied during local (on-device) training."""

    enabled: bool = True
    quantize_weights: bool = True
    quantize_acts: bool = True
    fmt: FP8Format = E4M3
    # paper default: deterministic QAT (Remark 4); 'rand' is the Table 2 ablation
    mode: str = "det"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"QATConfig.mode {self.mode!r}: one of {MODES}")

    @property
    def stochastic_weights(self) -> bool:
        """True when weight sites draw random bits (mode 'rand', weights on)."""
        return self.mode == "rand" and self.enabled and self.quantize_weights


DISABLED = QATConfig(enabled=False, quantize_weights=False, quantize_acts=False)


def is_clip_key(name: str) -> bool:
    return name.endswith(QA_SUFFIX) or name.endswith(QB_SUFFIX)


def alpha_like(w: torch.Tensor, stacked: bool = False) -> torch.Tensor:
    """Paper's alpha init: per-tensor max |w| (per layer when ``stacked``:
    shape ``(L, 1, ..., 1)`` over the leading layer axis)."""
    if stacked:
        return torch.amax(torch.abs(w), dim=tuple(range(1, w.dim())),
                          keepdim=True).to(torch.float32)
    return torch.max(torch.abs(w)).to(torch.float32)


def beta_init(value: float = 4.0, stacked_layers: int | None = None) -> torch.Tensor:
    """Activation clipping init (refined online by the learnable beta); one
    per layer, shape ``(L,)``, when ``stacked_layers`` is given."""
    if stacked_layers is None:
        return torch.tensor(value, dtype=torch.float32)
    return torch.full((stacked_layers,), value, dtype=torch.float32)


def _lsq_grad_scale(alpha: torch.Tensor, n_elements: int,
                    fmt: FP8Format) -> torch.Tensor:
    """LSQ gradient scaling (Esser et al. 2020) for learnable clip values.

    Forward value is unchanged up to f32 rounding of ``a*g + a*(1-g)``,
    which the reference computes the same way; the gradient is scaled by
    ``g = 1/sqrt(N * Q_max)``.
    """
    g = 1.0 / float(np.sqrt(max(n_elements, 1) * (2 ** (fmt.mant + 1) - 1)))
    return alpha * g + (alpha * (1.0 - g)).detach()


def wq(w: torch.Tensor, alpha: torch.Tensor, cfg: QATConfig,
       bits=None) -> torch.Tensor:
    """Fake-quantize a weight tensor for the forward pass (QAT); ``bits``
    (u32 of w's shape, or a ``ref.CounterKey``) are the site's random bits
    in ``mode='rand'``."""
    if not (cfg.enabled and cfg.quantize_weights):
        return w
    from ..kernels import dispatch

    alpha = _lsq_grad_scale(alpha, w.numel(), cfg.fmt)
    if cfg.mode == "rand":
        if bits is None:
            raise ValueError("stochastic QAT (mode='rand') needs the site's random bits")
        return dispatch.quantize_rand(w, alpha, bits, cfg.fmt)
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
