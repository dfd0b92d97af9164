"""Decoder-only LM, the dense part of ``repro.models.transformer``.

Stacked per-layer parameters under ``params["blocks"]`` (a leading layer
axis on every leaf, the reference's keys), a Python loop over the layers in
place of the reference's ``lax.scan`` (``transformer.py:306``): layer ``l``
hands each :func:`common.dense` the 2-D slice ``blocks[name][l]`` and its
one-element clips, so every QAT projection runs the fused B10/B11 kernels.
The stacked leaves are split with ``torch.unbind``, whose backward stacks
the 22 layers' gradients once. The reference's ``remat`` changes memory,
not values, and has no counterpart here.

QAT: every projection goes through ``common.dense``, which applies the
paper's deterministic FP8 fake-quant to its weight (per layer-tensor alpha)
and its input activations (per layer-site beta). Full causal GQA attention
only; the sliding-window, MLA, MoE and VLM variants, prefill and decode come
with the other LM families (ROADMAP §1 item 8).
"""
from __future__ import annotations

import torch

from .attention import flash_attention
from .common import (COMPUTE_DTYPE, activation, chunked_ce_loss, dense, put, rms_norm,
                     rope, winit)
from ..configs.base import ModelConfig
from ..core.qat import QATConfig, alpha_like, beta_init
from ..device import resolve_device
from ..tree import tree_map


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense" or cfg.attention != "full":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with {cfg.attention!r} attention is not "
            "ported yet (ROADMAP §1 item 8); the port runs dense full attention")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _init_attn(g: torch.Generator, cfg: ModelConfig, L: int) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p: dict = {}
    put(p, "wq", winit(g, (L, D, H * hd)))
    put(p, "wk", winit(g, (L, D, KV * hd)))
    put(p, "wv", winit(g, (L, D, KV * hd)))
    put(p, "wo", winit(g, (L, H * hd, D), fan_in=H * hd))
    p["attn_qb"] = beta_init(stacked_layers=L).to(g.device)
    p["o_qb"] = beta_init(stacked_layers=L).to(g.device)
    return p


def _init_ffn(g: torch.Generator, cfg: ModelConfig, L: int) -> dict:
    D, F = cfg.d_model, cfg.d_ff
    p: dict = {}
    put(p, "w_gate", winit(g, (L, D, F)))
    put(p, "w_up", winit(g, (L, D, F)))
    put(p, "w_down", winit(g, (L, F, D), fan_in=F))
    p["mlp_qb"] = beta_init(stacked_layers=L).to(g.device)
    p["down_qb"] = beta_init(stacked_layers=L).to(g.device)
    return p


def init_lm(seed: int | torch.Generator, cfg: ModelConfig, device="cuda") -> dict:
    """Random params of the dense decoder on ``device``, drawn with torch
    (on ``device`` from an integer seed, else on the generator's device);
    parity tests carry the reference's weights across instead."""
    _check_dense(cfg)
    dev = resolve_device(device)
    g = seed if isinstance(seed, torch.Generator) else \
        torch.Generator(device=dev).manual_seed(int(seed))
    L, D, V = cfg.n_layers, cfg.d_model, cfg.vocab
    ones = lambda *shape: torch.ones(shape, dtype=torch.float32, device=g.device)
    blocks = {"ln1": ones(L, D), "ln2": ones(L, D),
              **_init_attn(g, cfg, L), **_init_ffn(g, cfg, L)}
    embed = torch.randn((V, D), generator=g, device=g.device) * 0.02
    head, head_qa = winit(g, (D, V), fan_in=D, stacked=False)
    params = {
        "embed": embed,
        "embed_qa": alpha_like(embed),
        "blocks": blocks,
        "ln_f": ones(D),
        "lm_head": head,
        "lm_head_qa": head_qa,
        "head_qb": beta_init().to(g.device),
    }
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _attn_full_seq(p: dict, x: torch.Tensor, cfg: ModelConfig, qcfg: QATConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    """Train-time attention of one layer (``p`` is its slice)."""
    B, T, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = dense(p, "wq", x, qcfg, "attn_qb").reshape(B, T, H, hd)
    kk = dense(p, "wk", x, qcfg, "attn_qb").reshape(B, T, KV, hd)
    v = dense(p, "wv", x, qcfg, "attn_qb").reshape(B, T, KV, hd)
    q = rope(q, positions, cfg.rope_theta)
    kk = rope(kk, positions, cfg.rope_theta)
    out = flash_attention(q, kk, v, chunk=cfg.attn_chunk)
    return dense(p, "wo", out.reshape(B, T, H * hd), qcfg, "o_qb")


def _ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, qcfg: QATConfig) -> torch.Tensor:
    g = dense(p, "w_gate", x, qcfg, "mlp_qb")
    u = dense(p, "w_up", x, qcfg, "mlp_qb")
    return dense(p, "w_down", activation(g, cfg.act) * u, qcfg, "down_qb")


def _block_full(h: torch.Tensor, layer_p: dict, cfg: ModelConfig, qcfg: QATConfig,
                positions: torch.Tensor) -> torch.Tensor:
    x = rms_norm(h, layer_p["ln1"], cfg.norm_eps)
    h = h + _attn_full_seq(layer_p, x, cfg, qcfg, positions)
    x = rms_norm(h, layer_p["ln2"], cfg.norm_eps)
    return h + _ffn(layer_p, x, cfg, qcfg)


def _embed_inputs(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    emb = params["embed"].to(COMPUTE_DTYPE)
    return emb[tokens.to(torch.int64)]


def _layers(blocks: dict) -> list[dict]:
    """Per-layer views of the stacked blocks."""
    names = sorted(blocks)
    return [dict(zip(names, sl)) for sl in zip(*(torch.unbind(blocks[n]) for n in names))]


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                   qcfg: QATConfig) -> torch.Tensor:
    """(B, T, D) hidden states after the final norm (train path)."""
    _check_dense(cfg)
    h = _embed_inputs(params, tokens)
    B, T, _ = h.shape
    positions = torch.arange(T, device=h.device)[None, :].expand(B, T)
    for layer_p in _layers(params["blocks"]):
        h = _block_full(h, layer_p, cfg, qcfg, positions)
    return rms_norm(h, params["ln_f"], cfg.norm_eps)


def train_loss(params: dict, batch: dict, cfg: ModelConfig, qcfg: QATConfig) -> torch.Tensor:
    """batch: {'tokens': (B, T), 'labels': (B, T)}, label -1 masked."""
    h = forward_hidden(params, batch["tokens"], cfg, qcfg)
    return chunked_ce_loss(h, params, batch["labels"], qcfg, cfg.ce_chunks)
