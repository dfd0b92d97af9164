"""Synthetic datasets with real class structure (numpy only).

A copy of the generators of ``repro.data.synthetic`` that the ported tasks
use, kept here because the port imports nothing of the reference package.
The same seed gives the same arrays in both packages, so the two see
identical data.
"""
from __future__ import annotations

import numpy as np


def synthetic_classification(
    seed: int, n: int, d: int = 32, n_classes: int = 10, noise: float = 0.6
):
    """Gaussian class prototypes + heteroscedastic noise + nonlinearity."""
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(n_classes, d)).astype(np.float32)
    y = rng.integers(0, n_classes, size=n)
    x = protos[y] + noise * rng.normal(size=(n, d)).astype(np.float32)
    # mild nonlinearity so linear models don't saturate the task
    x = np.tanh(x) + 0.1 * x * x * np.sign(x)
    return x.astype(np.float32), y.astype(np.int32)


def synthetic_images(
    seed: int, n: int, hw: int = 32, channels: int = 3, n_classes: int = 10,
    noise: float = 0.35,
):
    """Class-conditional low-frequency pattern images (CIFAR-shaped, NHWC)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, hw), np.linspace(0, 1, hw), indexing="ij")
    freqs = rng.uniform(1.0, 5.0, size=(n_classes, channels, 2))
    phases = rng.uniform(0, 2 * np.pi, size=(n_classes, channels))
    templates = np.stack(
        [
            np.stack(
                [
                    np.sin(
                        2 * np.pi * (freqs[c, ch, 0] * xx + freqs[c, ch, 1] * yy)
                        + phases[c, ch]
                    )
                    for ch in range(channels)
                ],
                axis=-1,
            )
            for c in range(n_classes)
        ]
    ).astype(np.float32)  # (C, hw, hw, ch)
    y = rng.integers(0, n_classes, size=n)
    x = templates[y] + noise * rng.normal(size=(n, hw, hw, channels)).astype(
        np.float32
    )
    return (0.5 + 0.25 * x).astype(np.float32), y.astype(np.int32)


def synthetic_sequences(
    seed: int, n: int, t: int = 32, feats: int = 64, n_classes: int = 35,
    noise: float = 0.5,
):
    """Class-conditional temporal patterns (SpeechCommands MFCC-shaped)."""
    rng = np.random.default_rng(seed)
    carriers = rng.normal(size=(n_classes, t, feats)).astype(np.float32)
    # smooth over time so classes have temporal structure
    for _ in range(2):
        carriers = 0.5 * carriers + 0.25 * np.roll(carriers, 1, axis=1) + 0.25 * np.roll(
            carriers, -1, axis=1
        )
    y = rng.integers(0, n_classes, size=n)
    shift = rng.integers(0, t, size=n)
    x = np.stack([np.roll(carriers[yi], si, axis=0) for yi, si in zip(y, shift)])
    x = x + noise * rng.normal(size=x.shape).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def synthetic_lm_tokens(
    seed: int, n_tokens: int, vocab: int, order: int = 2
) -> np.ndarray:
    """Markov-chain token stream — a learnable LM corpus for the examples.

    A sparse ``order``-gram transition structure gives the model real
    signal: perplexity drops well below uniform when learned.
    """
    rng = np.random.default_rng(seed)
    branch = max(2, vocab // 64)
    # transition table: each context maps to `branch` likely next tokens
    n_ctx = min(vocab, 4096)
    nexts = rng.integers(0, vocab, size=(n_ctx, branch))
    out = np.empty(n_tokens, dtype=np.int32)
    state = int(rng.integers(0, n_ctx))
    for i in range(n_tokens):
        if rng.random() < 0.1:  # 10% noise
            tok = int(rng.integers(0, vocab))
        else:
            tok = int(nexts[state, int(rng.integers(0, branch))])
        out[i] = tok
        state = tok % n_ctx
    return out
