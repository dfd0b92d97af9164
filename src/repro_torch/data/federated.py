"""Federated client partitioners (paper §4 Setup), numpy only.

A copy of the partitioners of ``repro.data.federated`` that the ported
tasks use:

* ``partition_iid``       — uniform shuffle split across K clients.
* ``partition_dirichlet`` — label skew via Dir(concentration) per client.

Both return ``(K, n_per, ...)`` arrays (balanced by resampling) plus the
true per-client example counts ``nk`` used as aggregation weights, and
match the reference draw for draw under the same seed.
"""
from __future__ import annotations

import numpy as np


def _tensorize(x, y, assignments, k, n_per, rng):
    xs, ys, nk = [], [], []
    for c in range(k):
        idx = np.where(assignments == c)[0]
        nk.append(max(len(idx), 1))
        if len(idx) == 0:
            idx = rng.integers(0, len(x), size=n_per)
        elif len(idx) < n_per:
            idx = np.concatenate([idx, rng.choice(idx, n_per - len(idx))])
        else:
            idx = rng.choice(idx, n_per, replace=False)
        xs.append(x[idx])
        ys.append(y[idx])
    return np.stack(xs), np.stack(ys), np.asarray(nk, np.float32)


def partition_iid(x, y, k: int, seed: int = 0, n_per: int | None = None):
    rng = np.random.default_rng(seed)
    n = len(x)
    n_per = n_per or n // k
    assignments = rng.permutation(n) % k
    return _tensorize(x, y, assignments, k, n_per, rng)


def partition_dirichlet(
    x, y, k: int, concentration: float = 0.3, seed: int = 0,
    n_per: int | None = None,
):
    rng = np.random.default_rng(seed)
    n = len(x)
    n_classes = int(y.max()) + 1
    n_per = n_per or n // k
    assignments = np.zeros(n, dtype=np.int64)
    for c in range(n_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        probs = rng.dirichlet(np.full(k, concentration))
        counts = rng.multinomial(len(idx), probs)
        splits = np.split(idx, np.cumsum(counts)[:-1])
        for client, s in enumerate(splits):
            assignments[s] = client
    return _tensorize(x, y, assignments, k, n_per, rng)
