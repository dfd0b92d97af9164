"""Fused FP8-QAT matrix products, the port of ``repro.kernels.fp8_matmul``.

Wrappers of the three kernels of ``csrc/qat_matmul.cu`` (built into the
library of ``kernels.fp8_quant``, counted in its ``LAUNCHES``), each named
after the Pallas kernel it replaces:

* :func:`qat_matmul`    — B10, ``Q_det(x; beta) @ Q_det(w; alpha)``;
* :func:`qat_matmul_dx` — B11, ``(gx, g_beta)``;
* :func:`qat_matmul_dw` — B11, ``(gw, g_alpha)``.

x is ``(M, K)``, w ``(K, N)`` and the cotangent g ``(M, N)``, all f32 and
contiguous; beta and alpha hold one f32 each (a 0-dim tensor or a ``(1,
1)`` slice of a stacked clip). Outputs are f32; the clip cotangents are
0-dim. A tensor on the CPU takes the twin in ``kernels.ref``; a CUDA tensor
launches the kernels. All three run on bf16 tensor cores over exact frames
of the quantized operands (and a three-way bf16 split of g), with a scratch
buffer that the wrapper allocates: B10's and dx's reduction is split across
blocks into it, dw keeps its tables and clip partials there and masks and
routes its product in the same kernel. They hold the twin's codes, not its
f32 sum order, and are bounded against the f64 product
(``ref.qat_matmul_f64``, ``qat_matmul_dx_f64``, ``qat_matmul_dw_f64``).
"""
from __future__ import annotations

import torch

from . import ref
from .fp8_quant import (_check, _check_scalar_alpha, _fmt_args, _launched, _on_cpu,
                        _stream, load)
from ..core.fp8 import E4M3, FP8Format

__all__ = ["qat_matmul", "qat_matmul_dx", "qat_matmul_dw"]


def _check_operands(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
                    alpha: torch.Tensor, g: torch.Tensor | None = None):
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x (M, K) and w (K, N) expected, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    _check(x, "x", torch.float32)
    _check(w, "w", torch.float32)
    _check_scalar_alpha(beta)
    _check_scalar_alpha(alpha)
    m, k = x.shape
    n = w.shape[1]
    if g is not None:
        _check(g, "g", torch.float32, (m, n))
    if max(m, k, n) >= 2 ** 31 or m * n >= 2 ** 31 or k * n >= 2 ** 31 or m * k >= 2 ** 31:
        raise ValueError(f"qat_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} exceed "
                         "the kernel's 32-bit dimensions")
    return m, k, n


_SCRATCH: dict = {}   # (op, M, K, N): f32 of the scratch the kernels take
_OPS = {"qat_matmul": 0, "qat_matmul_dx": 1, "qat_matmul_dw": 2}


def _scratch(lib, op: int, m: int, k: int, n: int, device) -> torch.Tensor:
    key = (op, m, k, n)
    if key not in _SCRATCH:
        _SCRATCH[key] = int(lib.repro_qat_matmul_scratch(op, m, k, n))
    return torch.empty(_SCRATCH[key], dtype=torch.float32, device=device)


def qat_matmul(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
               alpha: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """``Q_det(x; beta) @ Q_det(w; alpha)`` in f32, ``(M, N)``."""
    if _on_cpu(x, w, beta, alpha):
        return ref.qat_matmul(x, w, beta, alpha, fmt)
    m, k, n = _check_operands(x, w, beta, alpha)
    lib = load()
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    scratch = _scratch(lib, _OPS["qat_matmul"], m, k, n, x.device)
    rc = lib.repro_qat_matmul(x.data_ptr(), w.data_ptr(), beta.data_ptr(),
                              alpha.data_ptr(), out.data_ptr(), scratch.data_ptr(), m, k, n,
                              *_fmt_args(fmt), _stream())
    _launched(rc, "qat_matmul")
    return out


def _backward(name: str, out_shape: tuple, g, x, w, beta, alpha, fmt):
    m, k, n = _check_operands(x, w, beta, alpha, g)
    lib = load()
    out = torch.empty(out_shape, dtype=torch.float32, device=x.device)
    scratch = _scratch(lib, _OPS[name], m, k, n, x.device)
    gclip = torch.empty((), dtype=torch.float32, device=x.device)
    rc = getattr(lib, f"repro_{name}")(
        g.data_ptr(), x.data_ptr(), w.data_ptr(), beta.data_ptr(), alpha.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), gclip.data_ptr(), m, k, n,
        *_fmt_args(fmt), _stream())
    _launched(rc, name)
    return out, gclip


def qat_matmul_dx(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """Backward to the activations: ``(gx (M, K), g_beta)``."""
    if _on_cpu(g, x, w, beta, alpha):
        return ref.qat_matmul_dx(g, x, w, beta, alpha, fmt)
    return _backward("qat_matmul_dx", tuple(x.shape), g, x, w, beta, alpha, fmt)


def qat_matmul_dw(g: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                  beta: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format = E4M3):
    """Backward to the weights: ``(gw (K, N), g_alpha)``."""
    if _on_cpu(g, x, w, beta, alpha):
        return ref.qat_matmul_dw(g, x, w, beta, alpha, fmt)
    return _backward("qat_matmul_dw", tuple(w.shape), g, x, w, beta, alpha, fmt)
