"""Token-stream batching for LM training (next-token prediction), a numpy
copy of ``repro.data.pipeline``.

``LMBatcher`` cuts a flat token stream into (tokens, labels) batches with a
deterministic, restart-safe cursor: the batch index fully determines the
window, so a resumed step replays the exact stream position. ``silo_stream``
derives a distinct generator seed per federated silo. The same arguments
give the same windows as the reference, draw for draw.
"""
from __future__ import annotations

import numpy as np

from .synthetic import synthetic_lm_tokens


class LMBatcher:
    def __init__(self, stream: np.ndarray, batch: int, seq_len: int):
        self.stream = stream
        self.batch = batch
        self.seq_len = seq_len
        self.tokens_per_batch = batch * (seq_len + 1)
        self.n_batches = len(stream) // self.tokens_per_batch

    def __call__(self, step: int) -> dict:
        i = step % max(self.n_batches, 1)
        flat = self.stream[i * self.tokens_per_batch : (i + 1) * self.tokens_per_batch]
        window = flat.reshape(self.batch, self.seq_len + 1)
        return {
            "tokens": window[:, :-1].astype(np.int32),
            "labels": window[:, 1:].astype(np.int32),
        }


def silo_stream(vocab: int, n_tokens: int, silo: int, seed: int = 0) -> np.ndarray:
    return synthetic_lm_tokens(seed * 1000 + silo, n_tokens, vocab)
