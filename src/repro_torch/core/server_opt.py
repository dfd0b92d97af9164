"""Server-side aggregation math, from ``repro.core.server_opt``.

This slice ports only ``weighted_mean``, the tail of ``MeanAggregator``
(FP8FedAvg-UQ). The UQ+ server optimizer (paper Eqs. 4-5) and its
``fake_quant_tiles`` kernel come with the next slice.
"""
from __future__ import annotations

import torch

from ..tree import tree_map


def weighted_mean(stacked: dict, nk: torch.Tensor) -> dict:
    """Federated average over the leading client axis with weights n_k/m."""
    w = nk / torch.sum(nk)

    def avg(leaf):
        wshape = (leaf.shape[0],) + (1,) * (leaf.dim() - 1)
        return torch.sum(leaf * w.reshape(wshape), dim=0)

    return tree_map(avg, stacked)
