"""Federated simulator (K clients on one device), the port of ``repro.core.fedsim``.

Drives a :class:`repro_torch.core.engine.RoundEngine` for ``R`` rounds,
threading the server state and tracking the exact uplink+downlink wire
bytes and the centralized test accuracy of the *quantized* server model —
the quantities in the paper's Table 1 / Figure 2.

Each round charges the ``wire_bytes`` its round function reports: the
static count, or on a dynamic (entropy-coded) link the measured coded bytes,
read with one host sync a round; ``bytes_per_round`` stays the static count
(the bound of a dynamic link).

Each round's randomness comes from a ``torch.Generator`` seeded by
``run(seed=...)``, or is injected per round with ``run(draws=[...])``.
Evaluation under stochastic QAT uses one fixed set of site bits (the
counter RNG with an all-zero key), as the reference evaluates with a fixed
key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .engine import CounterQatBits, FedConfig, RoundDraws, RoundEngine, ServerState
from ..device import resolve_device
from ..optim.base import Optimizer


@dataclasses.dataclass
class FedHistory:
    rounds: list[int] = dataclasses.field(default_factory=list)
    accuracy: list[float] = dataclasses.field(default_factory=list)
    loss: list[float] = dataclasses.field(default_factory=list)
    cumulative_bytes: list[int] = dataclasses.field(default_factory=list)

    def best_accuracy(self) -> float:
        return max(self.accuracy) if self.accuracy else 0.0

    def bytes_to_accuracy(self, threshold: float) -> int | None:
        """Cumulative bytes at the first eval reaching ``threshold`` (None if
        never): the paper's communication-gain numerator / denominator."""
        for acc, b in zip(self.accuracy, self.cumulative_bytes):
            if acc >= threshold:
                return b
        return None


def _as_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(a)
    return torch.as_tensor(a).to(device)


class FedSim:
    """Federated training loop with exact byte accounting.

    Client data (``(K, n_per, ...)`` arrays or tensors) is placed on
    ``device`` once.
    """

    def __init__(
        self,
        params: dict,
        loss_fn: Callable,           # (params, x, y, qat_cfg) -> scalar
        predict_fn: Callable,        # (params, x, qat_cfg) -> logits
        optimizer: Optimizer,
        cfg: FedConfig,
        client_data,                 # (K, n_per, ...)
        client_labels,               # (K, n_per)
        nk=None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.predict_fn = predict_fn
        self.client_data = _as_tensor(client_data, self.device)
        self.client_labels = _as_tensor(client_labels, self.device).long()
        self.nk = (
            _as_tensor(nk, self.device).to(torch.float32) if nk is not None
            else torch.full((cfg.n_clients,), float(self.client_data.shape[1]),
                            device=self.device)
        )
        self.engine = RoundEngine(loss_fn, optimizer, cfg, device=self.device)
        self.eval_kw = {}
        if cfg.qat.stochastic_weights:
            zero = torch.zeros((1, 1, 2), dtype=torch.int64).to(torch.uint32)
            self.eval_kw["bits"] = CounterQatBits(zero.to(self.device)).provider(0, 0)
        self.state: ServerState = self.engine.init(params)
        self.bytes_per_round = self.engine.round_bytes(params)

    @property
    def params(self) -> dict:
        return self.state.params

    @torch.no_grad()
    def evaluate(self, x, y, batch: int = 500) -> float:
        """Centralized test accuracy of the server model with the QAT
        quantizers active (the model the server ships is on the FP8 grid)."""
        x, y = _as_tensor(x, self.device), _as_tensor(y, self.device).long()
        correct = 0
        for i in range(0, x.shape[0], batch):
            logits = self.predict_fn(self.state.params, x[i:i + batch], self.cfg.qat,
                                     **self.eval_kw)
            correct += int((torch.argmax(logits, -1) == y[i:i + batch]).sum())
        return correct / x.shape[0]

    def run(
        self,
        rounds: int,
        seed: int = 0,
        eval_data=None,
        eval_every: int = 10,
        draws: list[RoundDraws] | None = None,
    ) -> FedHistory:
        """``rounds`` rounds; ``draws[r]`` (if given) is round r+1's
        randomness, otherwise it comes from a generator seeded by ``seed``."""
        if draws is not None and len(draws) < rounds:
            raise ValueError(f"{len(draws)} draws for {rounds} rounds")
        g = torch.Generator().manual_seed(int(seed))
        hist = FedHistory()
        total_bytes = 0
        n_per = self.client_data.shape[1]
        nk_host = self.nk.cpu()
        for r in range(1, rounds + 1):
            d = draws[r - 1] if draws is not None else self.engine.draw(g, nk_host, n_per)
            self.state, m = self.engine.round_fn(
                self.state, self.client_data, self.client_labels, self.nk, d)
            total_bytes += int(m["wire_bytes"])
            if eval_data is not None and (r % eval_every == 0 or r == rounds):
                hist.rounds.append(r)
                hist.accuracy.append(self.evaluate(*eval_data))
                hist.loss.append(float(m["local_loss"]))
                hist.cumulative_bytes.append(total_bytes)
        return hist
