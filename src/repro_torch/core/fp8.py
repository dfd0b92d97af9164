"""FP8 quantization core (paper Eq. 2-3), the port of ``repro.core.fp8``.

* ``quantize_det`` — deterministic round-to-nearest-even onto the FP8 grid
  with the straight-through estimator, written as the plain torch chain so
  autograd derives the paper's STE (round pass-through, exponent term
  detached, clip routing to ``alpha``). The kernel-backed version with a
  closed-form backward is ``kernels.dispatch.quantize_det``.
* ``quantize_rand`` — stochastic rounding (paper Eq. 3) over explicit u32
  random bits, STE-differentiable; the reference draws its uniforms from a
  ``jax.random`` key instead, the port's callers hand in the bits (the
  kernel-backed version is ``kernels.dispatch.quantize_rand``).
* ``pack_fp8`` / ``unpack_fp8`` — ``[sign|exp|mant]`` uint8 codes. Codes stay
  ``torch.uint8``: the paper's grid has no special values, and its ±alpha
  point reads as NaN through torch's float8 dtypes.

The flexible exponent bias is computed in f32 exactly as the reference does:

    b = 2^e - log2(alpha) + log2(2 - 2^-m) - 1
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

_ALPHA_FLOOR = 1e-12  # numerical guard: alpha must stay strictly positive


@dataclasses.dataclass(frozen=True)
class FP8Format:
    """A short float format: 1 sign bit, ``exp`` exponent bits, ``mant`` mantissa bits."""

    exp: int = 4
    mant: int = 3

    @property
    def bits(self) -> int:
        return 1 + self.exp + self.mant

    @property
    def mant_scale(self) -> float:
        """2 - 2^-m : ratio of the max mantissa value to 2^m."""
        return 2.0 - 2.0 ** (-self.mant)

    @property
    def mant_const(self) -> float:
        """log2(2 - 2^-m), the constant term of the exponent bias."""
        return float(np.log2(self.mant_scale))

    @property
    def max_exp_code(self) -> int:
        """Largest biased-exponent value p = floor(log2|x|+b) on the grid."""
        return 2 ** self.exp - 1


E4M3 = FP8Format(exp=4, mant=3)
E5M2 = FP8Format(exp=5, mant=2)
# Sub-byte ExMy formats on the same parametric grid; the wire packs two codes
# per byte (``kernels.fp8_quant.quant_pack_sub_tiles``, ``core.codec.PackedFpCodec``).
# E3M0 has no mantissa bit: mant_scale 1, mant_const 0, every nonzero code normal.
FP4_E2M1 = FP8Format(exp=2, mant=1)
FP4_E3M0 = FP8Format(exp=3, mant=0)


def exponent_bias(alpha: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Flexible exponent bias b for clipping value alpha (paper, below Eq. 2)."""
    alpha = torch.clamp(alpha, min=_ALPHA_FLOOR)
    return 2.0 ** fmt.exp - torch.log2(alpha) + fmt.mant_const - 1.0


def alpha_from_bias(b: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Inverse of :func:`exponent_bias`."""
    return torch.exp2(2.0 ** fmt.exp - 1.0 - b) * fmt.mant_scale


def _scale(x: torch.Tensor, alpha: torch.Tensor, fmt: FP8Format) -> torch.Tensor:
    """Per-element scale s_i (paper Eq. 2). Exponent term is detached."""
    b = exponent_bias(alpha, fmt)
    # |x| == 0 -> log2 = -inf -> floor = -inf -> subnormal branch; safe.
    p = torch.floor(torch.log2(torch.abs(x)) + b)
    p = torch.where(p > 1.0, p, torch.ones_like(p)).detach()
    return torch.exp2(p - b - fmt.mant)


def _round_ste(y: torch.Tensor) -> torch.Tensor:
    """Round-to-nearest-even with straight-through gradient."""
    return y + (torch.round(y) - y).detach()


def clip(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, -alpha, alpha)`` as the reference spells it."""
    return torch.minimum(torch.maximum(x, -alpha), alpha)


def quantize_det(x: torch.Tensor, alpha: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Deterministic FP8 fake-quant Q_det(x; alpha) (paper Eq. 2). STE-differentiable."""
    alpha = torch.clamp(alpha, min=_ALPHA_FLOOR)
    x_c = clip(x, alpha)
    s = _scale(x_c, alpha, fmt)
    return (s * _round_ste(x_c / s)).to(x.dtype)


def quantize_rand(x: torch.Tensor, alpha: torch.Tensor, bits: torch.Tensor,
                  fmt: FP8Format = E4M3) -> torch.Tensor:
    """Stochastic FP8 fake-quant Q_rand(x; alpha) (paper Eq. 3). Unbiased.

    Rounds up where ``u = bits * 2^-32`` falls below the fractional position
    between the two neighbouring grid points, so ``E[Q_rand(x)] ==
    clip(x, -a, a)``. STE-differentiable like :func:`quantize_det`.
    """
    alpha = torch.clamp(alpha, min=_ALPHA_FLOOR)
    x_c = clip(x, alpha)
    s = _scale(x_c, alpha, fmt)
    y = x_c / s
    fl = torch.floor(y)
    u = bits.to(torch.int64).to(torch.float32) * (1.0 / 4294967296.0)
    q = fl + (u < (y - fl)).to(y.dtype)
    return (s * (y + (q - y).detach())).to(x.dtype)


def pack_fp8(x: torch.Tensor, alpha: torch.Tensor,
             fmt: FP8Format = E4M3) -> torch.Tensor:
    """Encode values *already on the FP8 grid* into uint8 codes.

    Layout: [sign:1][exponent:fmt.exp][mantissa:fmt.mant] (MSB first);
    exponent fields 0 and 1 share the subnormal scale.
    """
    alpha = torch.clamp(alpha, min=_ALPHA_FLOOR)
    b = exponent_bias(alpha, fmt)
    sign = (x < 0).to(torch.int32)
    ax = torch.abs(x)
    pos = ax > 0
    p = torch.floor(torch.log2(torch.where(pos, ax, torch.ones_like(ax))) + b)
    p = torch.where(pos, p, torch.ones_like(p))
    p_eff = torch.clamp(p, 1.0, float(fmt.max_exp_code))
    s = torch.exp2(p_eff - b - fmt.mant)
    v = torch.round(ax / s).to(torch.int32)
    overflow = v >= 2 ** (fmt.mant + 1)
    at_max = p_eff >= float(fmt.max_exp_code)
    v = torch.where(overflow & at_max, torch.full_like(v, 2 ** (fmt.mant + 1) - 1),
                    torch.where(overflow, v // 2, v))
    p_eff = torch.where(overflow & ~at_max, p_eff + 1, p_eff)
    is_normal = v >= 2 ** fmt.mant
    f = torch.where(is_normal, p_eff, torch.zeros_like(p_eff)).to(torch.int32)
    m_field = torch.where(is_normal, v - 2 ** fmt.mant, v)
    code = (sign << (fmt.exp + fmt.mant)) | (f << fmt.mant) | m_field
    return code.to(torch.uint8)


def unpack_fp8(code: torch.Tensor, alpha: torch.Tensor,
               fmt: FP8Format = E4M3) -> torch.Tensor:
    """Decode uint8 codes produced by :func:`pack_fp8` back to f32 values."""
    alpha = torch.clamp(alpha, min=_ALPHA_FLOOR)
    b = exponent_bias(alpha, fmt)
    code = code.to(torch.int32)
    sign = (code >> (fmt.exp + fmt.mant)) & 0x1
    f = (code >> fmt.mant) & (2 ** fmt.exp - 1)
    m_field = code & (2 ** fmt.mant - 1)
    is_normal = f >= 1
    v = torch.where(is_normal, m_field + 2 ** fmt.mant, m_field)
    p_eff = torch.where(is_normal, f, torch.ones_like(f))
    s = torch.exp2(p_eff.to(torch.float32) - b - fmt.mant)
    mag = v.to(torch.float32) * s
    return torch.where(sign == 1, -mag, mag)


def quantization_grid(alpha: float, fmt: FP8Format = E4M3) -> np.ndarray:
    """All non-negative representable values for clipping value ``alpha``,
    sorted ascending from 0, in float64 (numpy, as the reference computes
    it; ``core.entropy`` builds its static tables from it)."""
    b = float(2.0 ** fmt.exp - np.log2(max(alpha, _ALPHA_FLOOR))
              + np.log2(fmt.mant_scale) - 1.0)
    vals = {0.0}
    # subnormals and exponent code 1 share the scale 2^(1 - b - m)
    s_sub = 2.0 ** (1.0 - b - fmt.mant)
    for v in range(1, 2 ** (fmt.mant + 1)):
        vals.add(v * s_sub)
    for p in range(2, fmt.max_exp_code + 1):
        s = 2.0 ** (p - b - fmt.mant)
        for v in range(2 ** fmt.mant, 2 ** (fmt.mant + 1)):
            vals.add(v * s)
    return np.asarray(sorted(vals))
