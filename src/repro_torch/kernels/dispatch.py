"""The seam between model / federated code and the FP8 kernels.

The port of ``repro.kernels.dispatch`` for this slice. Callers
(``core.qat.wq``/``aq``, ``core.wire``) never launch a kernel directly. The
path is chosen by the tensor's device alone, with no environment switch: a
CUDA tensor launches the hand-written kernel (or raises), a CPU tensor runs
the kernel's plain twin in ``kernels.ref``.

``quantize_det`` is a ``torch.autograd.Function``: the forward is the
``quant_det`` kernel, the backward the ``quant_det_bwd`` kernel (the paper's
straight-through estimator in closed form). At an element exactly on the
clip boundary (``|x| == alpha``, e.g. the largest weight right after the
``alpha = max|w|`` init) the closed form sends the whole gradient to ``x``,
as the reference's Pallas backward does; the reference's jnp autodiff
splits it 0.5/0.5 there (``repro/kernels/dispatch.py:34-38``).
"""
from __future__ import annotations

import torch

from . import fp8_quant
from ..core import fp8
from ..core.fp8 import E4M3, FP8Format


class _QuantDetSTE(torch.autograd.Function):
    """Q_det with a per-tensor scalar alpha: kernel forward, kernel backward."""

    @staticmethod
    def forward(ctx, x, alpha, fmt):
        ctx.fmt = fmt
        ctx.save_for_backward(x, alpha)
        return fp8_quant.quant_det(x, alpha, fmt)

    @staticmethod
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        gx, ga = fp8_quant.quant_det_bwd(x, alpha, g.contiguous(), ctx.fmt)
        return gx, ga.reshape(alpha.shape), None


def quantize_det(x: torch.Tensor, alpha: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Deterministic FP8 fake-quant through the kernel pair.

    On the CPU, stacked per-layer clipping values (more than one element)
    and a 0-dim ``x`` take the plain autograd chain of ``core.fp8``, as the
    reference dispatches them to jnp. On the card they raise: no kernel
    covers them yet, and a CUDA tensor never takes the plain path.
    """
    if x.dim() >= 1 and alpha.numel() == 1:
        return _QuantDetSTE.apply(x.contiguous(), alpha.to(torch.float32), fmt)
    if x.device.type != "cpu" or alpha.device.type != "cpu":
        raise NotImplementedError(
            f"quantize_det on {x.device.type}: the kernel takes x of rank >= 1 "
            f"and a one-element alpha, got x {tuple(x.shape)}, alpha "
            f"{tuple(alpha.shape)} (the stacked-alpha kernel is not ported yet)")
    return fp8.quantize_det(x, alpha, fmt)


def quant_pack_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """Quantize + pack the wire tile layout into uint8 codes, one launch."""
    return fp8_quant.quant_pack_tiles(x2, a2, key2, fmt)


def unpack_tiles(c2: torch.Tensor, a2: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Decode ``(R, LANE)`` uint8 code tiles back to f32 grid values."""
    return fp8_quant.unpack_tiles(c2, a2, fmt)
