"""Shared LM building blocks, the port of ``repro.models.common``: norms,
RoPE, the QAT projection, init helpers, chunked cross-entropy.

Params keep the reference's stacked per-layer layout (a leading layer axis,
``_qa`` clips of shape ``(L, 1, 1)``, ``_qb`` clips of shape ``(L,)``), so
``convert.from_jax_params`` carries reference weights across and the wire's
flat order lines up. Model code hands :func:`dense` one layer's slice: a 2-D
weight and one-element clips.

``COMPUTE_DTYPE`` is bf16, as in the reference: the residual stream,
attention inputs and projection outputs are bf16; norms, RoPE angles,
softmax and the QAT products compute in f32. The reference's sharding
hints (``hint``, ``sharding_rules``) are the identity on one device and are
not ported.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..core.qat import QATConfig, _lsq_grad_scale, alpha_like, aq, wq
from ..kernels import dispatch

COMPUTE_DTYPE = torch.bfloat16


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def winit(g: torch.Generator, shape: tuple, fan_in: int | None = None,
          stacked: bool = True):
    """Normal init scaled by ``1/sqrt(fan_in)`` + its clipping value (per
    layer when ``stacked`` and the weight has a layer axis), drawn from
    ``g`` on ``g``'s device."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    w = torch.randn(shape, generator=g, device=g.device) * float(np.sqrt(1.0 / fan_in))
    return w, alpha_like(w, stacked=stacked and len(shape) > 2)


def put(params: dict, name: str, w_and_alpha) -> None:
    w, a = w_and_alpha
    params[name] = w
    params[name + "_qa"] = a


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * scale).to(dt)


def _fused_dense_ok(p: dict, name: str, x: torch.Tensor, qcfg: QATConfig,
                    act_site: str | None) -> bool:
    """Can this projection take the fused QAT-matmul kernels?

    The reference's conditions (``common.py:92-111``): both quantizers on
    and deterministic, an activation clip present, a 2-D weight and
    one-element clips. Its last one, a Pallas backend, has no counterpart:
    the port always mirrors the reference's kernel path.
    """
    if not (qcfg.enabled and qcfg.quantize_weights and qcfg.quantize_acts
            and qcfg.mode == "det"):
        return False
    if act_site is None or act_site not in p:
        return False
    w = p[name]
    if w.dim() != 2 or x.dim() < 2:
        return False
    return p[name + "_qa"].numel() == 1 and p[act_site].numel() == 1


def dense(p: dict, name: str, x: torch.Tensor, qcfg: QATConfig,
          act_site: str | None = None) -> torch.Tensor:
    """QAT projection: optional activation fake-quant + weight fake-quant
    matmul; ``p[name]`` is ``(d_in, d_out)``, contracted with x's last axis.

    On the fused path the whole projection is ``dispatch.qat_matmul`` (B10
    forward, B11 backward) on f32 operands, and the output goes back to
    bf16. The LSQ gradient scale of the activation clip counts the elements
    of the un-reshaped ``x``, as the reference does. Otherwise it is
    ``aq``/``wq`` and a bf16 matmul, the reference's fallback chain.
    """
    if _fused_dense_ok(p, name, x, qcfg, act_site):
        w = p[name]
        beta = _lsq_grad_scale(p[act_site].to(torch.float32), x.numel(), qcfg.fmt)
        alpha = _lsq_grad_scale(p[name + "_qa"], w.numel(), qcfg.fmt)
        x2 = x.reshape(-1, x.shape[-1])
        out = dispatch.qat_matmul(x2.to(torch.float32), w.to(torch.float32), beta,
                                  alpha, qcfg.fmt)
        return out.reshape(*x.shape[:-1], w.shape[-1]).to(COMPUTE_DTYPE)
    if act_site is not None and act_site in p:
        x = aq(x, p[act_site].to(torch.float32), qcfg)
    w = p[name]
    if qcfg.enabled and qcfg.quantize_weights:
        w = wq(w.to(torch.float32), p[name + "_qa"], qcfg)
    return torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embeddings. x: (..., T, H, D_head), positions: (..., T)."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., T, half)
    ang = ang[..., None, :]                                    # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The FFN activation; ``silu`` is the ported configs' (the reference's
    ``gelu`` belongs to configs not ported yet)."""
    if kind == "silu":
        return F.silu(x)
    raise NotImplementedError(f"activation {kind!r}: only 'silu' is ported")


# ---------------------------------------------------------------------------
# Chunked cross-entropy (bounds large-vocab logits memory)
# ---------------------------------------------------------------------------


def chunked_ce_loss(h: torch.Tensor, head_p: dict, labels: torch.Tensor,
                    qcfg: QATConfig, n_chunks: int = 8) -> torch.Tensor:
    """Mean CE over unmasked tokens (label -1 is masked), computed over
    ``n_chunks`` chunks of the sequence axis so the (tokens x vocab) logits
    never materialize whole; a loop over the chunks replaces the
    reference's ``lax.map``. The head is ``lm_head`` (no ported config ties
    it to the embedding)."""
    B, T, D = h.shape
    n_chunks = min(n_chunks, T)
    while T % n_chunks:
        n_chunks -= 1
    tc = T // n_chunks
    losses, counts = [], []
    for c in range(n_chunks):
        hx, lx = h[:, c * tc:(c + 1) * tc], labels[:, c * tc:(c + 1) * tc]
        logits = dense(head_p, "lm_head", hx, qcfg, act_site="head_qb").to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lx, min=0).to(torch.int64)[..., None])[..., 0]
        mask = (lx >= 0).to(torch.float32)
        losses.append(torch.sum((logz - gold) * mask))
        counts.append(torch.sum(mask))
    return torch.sum(torch.stack(losses)) / torch.clamp(torch.sum(torch.stack(counts)), min=1.0)


def logits_head(h: torch.Tensor, head_p: dict, qcfg: QATConfig) -> torch.Tensor:
    """Full logits (decode path: single position, cheap)."""
    return dense(head_p, "lm_head", h, qcfg, act_site="head_qb").to(torch.float32)
