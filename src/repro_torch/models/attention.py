"""Flash-style chunked GQA attention, the port of
``repro.models.attention.flash_attention``.

The reference scans over KV chunks with an online-softmax carry (running
max, denominator, accumulator), so live memory is O(T x chunk) per head. It
is jnp outside any kernel there, so plain torch ops here, a Python loop over
the chunks in the scan's order. Queries are ``(B, T, H, hd)``, keys and
values ``(B, S, KV, hd)``; GQA repeats each KV head ``H // KV`` times
(head ``h = kv * G + g``). Sliding-window, block-local, MLA and decode
attention belong to the LM families not ported yet (ROADMAP §1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, KV, D) -> (B, S, H, D) by repeating each kv head G times."""
    G = n_heads // k.shape[2]
    return k if G == 1 else torch.repeat_interleave(k, G, dim=2)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    chunk: int = 1024) -> torch.Tensor:
    """Causal online-softmax attention from position 0, looped over KV
    chunks (flash-style); the reference's ``causal=True, q_offset=0,
    window=0`` case, the only one the train path calls."""
    B, T, H, D = q.shape
    S = k.shape[1]
    Dv = v.shape[-1]
    chunk = min(chunk, S)
    while S % chunk:
        chunk -= 1
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    qf = q.to(torch.float32) * (1.0 / np.sqrt(D))
    q_pos = torch.arange(T, device=q.device)
    m = torch.full((B, H, T), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, T), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, T, Dv), dtype=torch.float32, device=q.device)
    for j in range(S // chunk):
        kj = k[:, j * chunk:(j + 1) * chunk].to(torch.float32)
        vj = v[:, j * chunk:(j + 1) * chunk].to(torch.float32)
        k_pos = j * chunk + torch.arange(chunk, device=q.device)
        s = torch.einsum("bthd,bchd->bhtc", qf, kj)
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhtc,bchd->bhtd", p, vj)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)   # (B,H,T,Dv) -> (B,T,H,Dv)
