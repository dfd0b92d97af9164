"""Static-table interleaved rANS, the port of ``repro.kernels.rans``.

The range coder under :class:`repro_torch.core.entropy.RansCodec`: 16 lanes
of byte-renormalized rANS (``SCALE_BITS = 12``, states in ``[L, 2^31)`` with
``L = 2^23``, at most ``RENORMS = 2`` bytes per symbol and lane) against a
static frequency table that both ends compute from the quantization grid.
The symbols (the inner codec's u8 code stream) are zero-padded to whole rows
of ``LANES``; lane ``l`` codes symbols ``t * LANES + l``. The encode codes
rows in reverse, emitting low byte first; the decode runs forward and reads
each lane's bytes backward.

Wrappers of the two kernels of ``csrc/rans.cu`` (built into the library of
``kernels.fp8_quant``, counted in its ``LAUNCHES``):

* :func:`rans_decode` — B12, replacing ``rans.py::rans_decode_pallas``;
* :func:`rans_encode` — the encode, which the reference computes as a
  ``lax.scan`` with no kernel.

A tensor on the CPU takes the plain twin in ``kernels.ref`` (a loop over the
rows, step for step the reference's); a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import torch

from . import ref
from .fp8_quant import _check, _launched, _on_cpu, _stream, load
from .ref import LANES, RANS_L as L, RENORMS, SCALE_BITS, TAB, buf_cols, n_steps

__all__ = ["SCALE_BITS", "TAB", "L", "LANES", "RENORMS", "n_steps", "buf_cols",
           "rans_encode", "rans_decode"]


def _check_table(freq: torch.Tensor, cum: torch.Tensor) -> None:
    _check(freq, "freq", torch.int32, (256,))
    _check(cum, "cum", torch.int32, (256,))


def rans_encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor):
    """Encode (n,) u8 symbols against the (256,) int32 ``freq``/``cum`` table
    (sum 4096, every entry >= 1). Returns ``(buf, state, lens)``: the
    ``(LANES, buf_cols(n))`` u8 byte planes (lane ``l``'s stream is ``buf[l,
    :lens[l]]``, zeros after it), the final states and the byte counts, both
    ``(LANES,)`` int32."""
    if _on_cpu(syms, freq, cum):
        return ref.rans_encode(syms, freq, cum)
    _check(syms, "syms", torch.uint8)
    _check_table(freq, cum)
    n = syms.numel()
    cols = buf_cols(n)
    buf = torch.zeros((LANES, cols), dtype=torch.uint8, device=syms.device)
    state = torch.empty(LANES, dtype=torch.int32, device=syms.device)
    lens = torch.empty_like(state)
    rc = load().repro_rans_encode(syms.data_ptr(), n, n_steps(n), cols, freq.data_ptr(),
                                  cum.data_ptr(), buf.data_ptr(), state.data_ptr(),
                                  lens.data_ptr(), _stream())
    _launched(rc, "rans_encode")
    return buf, state, lens


def rans_decode(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                freq: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor) -> torch.Tensor:
    """Decode an :func:`rans_encode` payload back to its (n,) u8 symbols;
    ``slot2sym`` is the (4096,) int32 inverse of ``cum``."""
    if _on_cpu(buf, state, lens, freq, cum, slot2sym):
        return ref.rans_decode(buf, state, lens, n, freq, cum, slot2sym)
    _check(buf, "buf", torch.uint8)
    if buf.dim() != 2 or buf.shape[0] != LANES or buf.shape[1] < buf_cols(n):
        raise ValueError(f"buf must be ({LANES}, >= {buf_cols(n)}) for {n} symbols, "
                         f"got {tuple(buf.shape)}")
    _check(state, "state", torch.int32, (LANES,))
    _check(lens, "lens", torch.int32, (LANES,))
    _check_table(freq, cum)
    _check(slot2sym, "slot2sym", torch.int32, (TAB,))
    out = torch.empty(n, dtype=torch.uint8, device=buf.device)
    rc = load().repro_rans_decode(buf.data_ptr(), buf.shape[1], state.data_ptr(),
                                  lens.data_ptr(), n, n_steps(n), freq.data_ptr(),
                                  cum.data_ptr(), slot2sym.data_ptr(), out.data_ptr(),
                                  _stream())
    _launched(rc, "rans_decode")
    return out
