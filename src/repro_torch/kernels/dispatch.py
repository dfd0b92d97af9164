"""The seam between model / federated code and the FP8 kernels.

The port of ``repro.kernels.dispatch`` for the ported kernels. Callers
(``core.qat.wq``/``aq``, ``core.wire``, ``core.codec``) never launch a kernel
directly. The path is chosen by the tensor's device alone, with no
environment switch: a CUDA tensor launches the hand-written kernel (or
raises), a CPU tensor runs the kernel's plain twin in ``kernels.ref``.

``quantize_det`` and ``quantize_rand`` are ``torch.autograd.Function`` classes:
the forward is the ``quant_det`` / ``quant_rand`` kernel, the backward the
``quant_det_bwd`` / ``quant_rand_bwd`` kernel (the paper's straight-through
estimator in closed form). ``qat_matmul`` is one too: the forward is the B10
kernel ``Q_det(x; beta) @ Q_det(w; alpha)``, the backward the two B11 kernels
(dx, then dw), as ``repro/kernels/dispatch.py:206-245`` wires them.
``quant_det_plane`` (the trainer's once-a-step
weight fake-quant on the ``core.plane`` plane) is the B7 pair:
``quant_det_tiles`` forward, ``quant_det_tiles_bwd`` backward with the clip
cotangent per row, as ``repro/kernels/dispatch.py:404-435`` wires them.
``fake_quant_plane`` (the UQ+ server step) runs
the ``fake_quant_tiles`` kernel forward, and ``fake_quant_amax_plane`` its
B9 variant with the per-row raw max; their backward is the reference's
elementwise STE in plain torch, as the reference computes it in jnp outside
any kernel (``repro/kernels/dispatch.py:457-469, 518-529``). At an element exactly on the
clip boundary (``|x| == alpha``, e.g. the largest weight right after the
``alpha = max|w|`` init) the closed form sends the whole gradient to ``x``,
as the reference's Pallas backward does; the reference's jnp autodiff
splits it 0.5/0.5 there (``repro/kernels/dispatch.py:34-38``).
"""
from __future__ import annotations

import torch

from . import fp8_matmul, fp8_quant, ref
from . import rans as rans_kernel
from ..core import fp8
from ..core.fp8 import E4M3, FP4_E2M1, FP8Format


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
    """Deterministic FP8 fake-quant through the kernel pair; ``x`` f32 or
    bf16 (computed in f32, returned and differentiated in ``x.dtype``).

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


class _QuantRandSTE(torch.autograd.Function):
    """Q_rand with a per-tensor scalar alpha: kernel forward, kernel backward
    with the same bits. u32 bits are saved for the backward; a
    ``ref.CounterKey`` is kept instead (no bits tensor: the kernels draw
    them from the key on the card, the twins materialize them on the CPU)."""

    @staticmethod
    def forward(ctx, x, alpha, bits, fmt):
        ctx.fmt = fmt
        if isinstance(bits, ref.CounterKey):
            ctx.key = bits
            ctx.save_for_backward(x, alpha)
        else:
            ctx.key = None
            ctx.save_for_backward(x, alpha, bits)
        return fp8_quant.quant_rand(x, alpha, bits, fmt)

    @staticmethod
    def backward(ctx, g):
        x, alpha, *bits = ctx.saved_tensors
        bits = ctx.key if ctx.key is not None else bits[0]
        gx, ga = fp8_quant.quant_rand_bwd(x, alpha, bits, g.contiguous(), ctx.fmt)
        return gx, ga.reshape(alpha.shape), None, None


def quantize_rand(x: torch.Tensor, alpha: torch.Tensor, bits,
                  fmt: FP8Format = E4M3) -> torch.Tensor:
    """Stochastic (unbiased) FP8 fake-quant through the kernel pair.

    ``bits`` are u32 of x's shape, drawn by the caller (the reference draws
    them with ``jax.random.bits`` outside its kernel), or a
    ``ref.CounterKey``: the site's counter bits, which the kernels draw
    themselves on the card and the twins materialize on the CPU, bitwise
    the same. As for :func:`quantize_det`, stacked clipping values and a
    0-dim ``x`` take the plain chain on the CPU and raise on the card.
    """
    if x.dim() >= 1 and alpha.numel() == 1:
        if not isinstance(bits, ref.CounterKey):
            bits = bits.contiguous()
        return _QuantRandSTE.apply(x.contiguous(), alpha.to(torch.float32), bits, fmt)
    if x.device.type != "cpu" or alpha.device.type != "cpu":
        raise NotImplementedError(
            f"quantize_rand on {x.device.type}: the kernel takes x of rank >= 1 "
            f"and a one-element alpha, got x {tuple(x.shape)}, alpha "
            f"{tuple(alpha.shape)} (the stacked-alpha kernel is not ported yet)")
    return fp8.quantize_rand(x, alpha, ref.site_bits(bits, x.shape), fmt)


class _QatMatmulSTE(torch.autograd.Function):
    """The fused QAT product: B10 forward; B11 dx and dw backward, both run
    on every backward pass as the reference's VJP runs them."""

    @staticmethod
    def forward(ctx, x, w, beta, alpha, fmt):
        ctx.fmt = fmt
        ctx.save_for_backward(x, w, beta, alpha)
        return fp8_matmul.qat_matmul(x, w, beta, alpha, fmt)

    @staticmethod
    def backward(ctx, g):
        x, w, beta, alpha = ctx.saved_tensors
        g = g.contiguous()
        gx, gb = fp8_matmul.qat_matmul_dx(g, x, w, beta, alpha, ctx.fmt)
        gw, ga = fp8_matmul.qat_matmul_dw(g, x, w, beta, alpha, ctx.fmt)
        return gx, gw, gb.reshape(beta.shape), ga.reshape(alpha.shape), None


def qat_matmul(x: torch.Tensor, w: torch.Tensor, beta: torch.Tensor,
               alpha: torch.Tensor, fmt: FP8Format = E4M3) -> torch.Tensor:
    """``Q_det(x; beta) @ Q_det(w; alpha)`` with f32 accumulation through the
    B10/B11 kernels: 2-D f32 operands and one-element clips (a per-layer
    ``(1, 1)`` slice of a stacked clip is one). The clip gradients come back
    in the clips' own shapes. Other shapes raise: ``models.common.dense``
    sends only these here, and takes the ``aq``/``wq`` chain otherwise."""
    if x.dim() != 2 or w.dim() != 2 or beta.numel() != 1 or alpha.numel() != 1:
        raise ValueError(
            f"qat_matmul takes 2-D x and w and one-element clips, got x {tuple(x.shape)}, "
            f"w {tuple(w.shape)}, beta {tuple(beta.shape)}, alpha {tuple(alpha.shape)}")
    return _QatMatmulSTE.apply(x.contiguous(), w.contiguous(), beta.to(torch.float32),
                               alpha.to(torch.float32), fmt)


class _QuantDetPlaneSTE(torch.autograd.Function):
    """B7: ``quant_det_tiles`` forward, ``quant_det_tiles_bwd`` backward."""

    @staticmethod
    def forward(ctx, x2, a_col, fmt):
        ctx.fmt = fmt
        ctx.save_for_backward(x2, a_col)
        return fp8_quant.quant_det_tiles(x2, a_col, fmt)

    @staticmethod
    def backward(ctx, g):
        x2, a_col = ctx.saved_tensors
        gx, ga_row = fp8_quant.quant_det_tiles_bwd(x2, a_col, g.contiguous(), ctx.fmt)
        return gx, ga_row, None


def quant_det_plane(x2: torch.Tensor, a_col: torch.Tensor,
                    fmt: FP8Format = E4M3) -> torch.Tensor:
    """One-launch Q_det of the ``(R, LANE)`` f32 plane with its per-row
    ``(R, 1)`` alpha column; one-launch backward ``(gx, ga_row)``, the
    caller summing ``ga_row`` per segment (``core.plane.quantize_det``)."""
    return _QuantDetPlaneSTE.apply(x2.contiguous(), a_col, fmt)


def _plane_ste_bwd(ctx, g):
    """The paper's STE backward of a plane quantize-dequantize, elementwise
    from the saved forward output (``(q - y) * s == q_val - clip(x)``, so no
    random bits are replayed): the clip mask to the tiles, clip routing plus
    the scale term summed per row to the ``(R, 1)`` alpha column."""
    x2, a_col, q = ctx.saved_tensors
    a = torch.clamp(a_col, min=fp8._ALPHA_FLOOR)
    inside = (torch.abs(x2) <= a).to(torch.float32)
    gx = g * inside
    if not ctx.needs_input_grad[1]:   # UQ+'s Eq. 4 holds alpha fixed
        return gx, None, None, None
    xc = fp8.clip(x2, a)
    ga_row = torch.sum(
        g * (torch.sign(x2) * (1.0 - inside) + (q - xc) / a), dim=1, keepdim=True)
    return gx, ga_row, None, None


class _FakeQuantPlaneSTE(torch.autograd.Function):
    """``fake_quant_tiles`` forward; :func:`_plane_ste_bwd` backward."""

    @staticmethod
    def forward(ctx, x2, a_col, key2, fmt):
        q = fp8_quant.fake_quant_tiles(x2, a_col, key2, fmt)
        ctx.save_for_backward(x2, a_col, q)
        return q

    @staticmethod
    def backward(ctx, g):
        return _plane_ste_bwd(ctx, g)


def fake_quant_plane(x2: torch.Tensor, a_col: torch.Tensor,
                     key2: torch.Tensor | None, fmt: FP8Format = E4M3) -> torch.Tensor:
    """Differentiable one-launch quantize-dequantize of the ``(R, LANE)``
    plane with a per-row ``(R, 1)`` alpha column (STE gradients)."""
    return _FakeQuantPlaneSTE.apply(x2.contiguous(), a_col, key2, fmt)


class _FakeQuantAmaxPlaneSTE(torch.autograd.Function):
    """B9 ``fake_quant_amax_tiles`` forward ``(q, rowmax)``; the backward is
    :func:`_plane_ste_bwd` of ``q``, the row max's cotangent ignored (a
    monitoring byproduct, as the reference's VJP treats it)."""

    @staticmethod
    def forward(ctx, x2, a_col, key2, fmt):
        q, rowmax = fp8_quant.fake_quant_amax_tiles(x2, a_col, key2, fmt)
        ctx.save_for_backward(x2, a_col, q)
        ctx.mark_non_differentiable(rowmax)
        return q, rowmax

    @staticmethod
    def backward(ctx, g, _g_rowmax):
        return _plane_ste_bwd(ctx, g)


def fake_quant_amax_plane(x2: torch.Tensor, a_col: torch.Tensor,
                          key2: torch.Tensor | None, fmt: FP8Format = E4M3):
    """:func:`fake_quant_plane` and the per-row raw amax ``(R, 1)`` from one
    launch: ``(q, rowmax)``, differentiable in ``q`` (the same STE)."""
    return _FakeQuantAmaxPlaneSTE.apply(x2.contiguous(), a_col, key2, fmt)


def fake_quant_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """One-launch quantize-dequantize (f32 out, no codes). Equal to
    ``unpack_tiles(quant_pack_tiles(...))`` within 1 f32 ULP."""
    return fp8_quant.fake_quant_tiles(x2, a2, key2, fmt)


def quant_pack_tiles(x2: torch.Tensor, a2: torch.Tensor,
                     key2: torch.Tensor | None = None,
                     fmt: FP8Format = E4M3) -> torch.Tensor:
    """Quantize + pack the wire tile layout into uint8 codes, one launch."""
    return fp8_quant.quant_pack_tiles(x2, a2, key2, fmt)


def unpack_tiles(c2: torch.Tensor, a2: torch.Tensor,
                 fmt: FP8Format = E4M3) -> torch.Tensor:
    """Decode ``(R, LANE)`` uint8 code tiles back to f32 grid values."""
    return fp8_quant.unpack_tiles(c2, a2, fmt)


def quant_pack_sub_tiles(x2: torch.Tensor, a2: torch.Tensor,
                         key2: torch.Tensor | None = None,
                         fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """Quantize + pack at ``8 // fmt.bits`` codes per byte (FP4), one launch;
    the same per-element counter bits as :func:`quant_pack_tiles`."""
    return fp8_quant.quant_pack_sub_tiles(x2, a2, key2, fmt)


def quant_pack_sub_many(x3: torch.Tensor, a3: torch.Tensor,
                        keys: torch.Tensor | None = None,
                        fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """:func:`quant_pack_sub_tiles` of a cohort's ``(P, R, LANE)`` planes,
    each with its own alphas and ``(2,)`` key row, in one launch."""
    return fp8_quant.quant_pack_sub_many(x3, a3, keys, fmt)


def fake_quant_many(x2: torch.Tensor, a3: torch.Tensor,
                    keys: torch.Tensor | None = None,
                    fmt: FP8Format = E4M3) -> torch.Tensor:
    """:func:`fake_quant_tiles` of one plane at G clip slices ``a3``, each
    with its own ``(2,)`` key row, in one launch: ``(G, R, LANE)`` f32."""
    return fp8_quant.fake_quant_many(x2, a3, keys, fmt)


def unpack_sub_tiles(c2: torch.Tensor, a2: torch.Tensor,
                     fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """Decode sub-byte packed code tiles back to ``(R, LANE)`` f32 grid values."""
    return fp8_quant.unpack_sub_tiles(c2, a2, fmt)


def unpack_sub_many(c3: torch.Tensor, a3: torch.Tensor,
                    fmt: FP8Format = FP4_E2M1) -> torch.Tensor:
    """:func:`unpack_sub_tiles` of a cohort's ``(P, R, LANE // k)`` code
    planes, each with its own alphas, in one launch: ``(P, R, LANE)`` f32."""
    return fp8_quant.unpack_sub_many(c3, a3, fmt)


def quant_pack_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                          key2: torch.Tensor | None = None,
                          fmt: FP8Format = E4M3):
    """:func:`quant_pack_tiles` + the per-row raw amax ``(R, 1)`` from the
    same launch (delayed scaling's history row)."""
    return fp8_quant.quant_pack_amax_tiles(x2, a2, key2, fmt)


def quant_pack_sub_amax_tiles(x2: torch.Tensor, a2: torch.Tensor,
                              key2: torch.Tensor | None = None,
                              fmt: FP8Format = FP4_E2M1):
    """:func:`quant_pack_sub_tiles` + the per-row raw amax ``(R, 1)``."""
    return fp8_quant.quant_pack_sub_amax_tiles(x2, a2, key2, fmt)


def quant_pack_amax_many(x3: torch.Tensor, a3: torch.Tensor,
                         keys: torch.Tensor | None = None, fmt: FP8Format = E4M3):
    """The amax encode (FP8 or FP4 ``fmt``) of a cohort's ``(P, R, LANE)``
    planes, each with its own ``(2,)`` key row, in one launch: ``(codes,
    rowmax (P, R, 1))``; the alphas may be one slice expanded over P."""
    return fp8_quant.quant_pack_amax_many(x3, a3, keys, fmt)


def rans_encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                enc: torch.Tensor | None = None):
    """16-lane static-table rANS encode of the (n,) u8 ``syms``: ``(buf (16,
    cols) u8, state (16,) i32, lens (16,) i32)``, the encode kernel on a CUDA
    stream (``enc`` its reciprocal table, ``ref.rans_enc_table``), the
    step-for-step twin on a CPU one (the reference computes it in jnp,
    ``repro/kernels/rans.py:81``)."""
    return rans_kernel.rans_encode(syms, freq, cum, enc)


def rans_decode(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                freq: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor) -> torch.Tensor:
    """Decode an interleaved-rANS byte stream back to its (n,) u8 symbols: B12
    on a CUDA payload, the step-for-step twin on a CPU one."""
    return rans_kernel.rans_decode(buf, state, lens, n, freq, cum, slot2sym)


def rans_encode_many(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                     enc: torch.Tensor | None = None):
    """:func:`rans_encode` of a cohort's (B, n) same-table payloads in one
    launch: ``(buf (B, 16, cols), state (B, 16), lens (B, 16))``."""
    return rans_kernel.rans_encode_many(syms, freq, cum, enc)


def rans_decode_many(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                     freq: torch.Tensor, cum: torch.Tensor,
                     slot2sym: torch.Tensor) -> torch.Tensor:
    """:func:`rans_decode` of a cohort's payloads in one launch: (B, n) u8."""
    return rans_kernel.rans_decode_many(buf, state, lens, n, freq, cum, slot2sym)
