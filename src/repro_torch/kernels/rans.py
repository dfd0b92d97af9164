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
``kernels.fp8_quant``, counted in its ``LAUNCHES``), each over a cohort of
same-table payloads of one length in one launch (one block a payload):

* :func:`rans_decode_many` — B12, replacing ``rans.py::rans_decode_pallas``;
* :func:`rans_encode_many` — the encode, which the reference computes as a
  ``lax.scan`` with no kernel;
* :func:`rans_decode` / :func:`rans_encode` — one payload, a cohort of one.

A tensor on the CPU takes the plain twin in ``kernels.ref`` (a loop over the
rows, step for step the reference's; a loop over the payloads); a CUDA
tensor launches the kernel. :func:`chain_probe` runs the kernels' dependent
chains alone, for their chain bound; no path calls it.
"""
from __future__ import annotations

import torch

from . import ref
from .fp8_quant import _check, _launched, _on_cpu, _stream, load
from .ref import LANES, RANS_L as L, RENORMS, SCALE_BITS, TAB, buf_cols, n_steps

__all__ = ["SCALE_BITS", "TAB", "L", "LANES", "RENORMS", "n_steps", "buf_cols",
           "rans_encode", "rans_decode", "rans_encode_many", "rans_decode_many",
           "chain_probe"]


def _check_table(freq: torch.Tensor, cum: torch.Tensor) -> None:
    _check(freq, "freq", torch.int32, (256,))
    _check(cum, "cum", torch.int32, (256,))


def rans_encode_many(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                     enc: torch.Tensor | None = None):
    """Encode B payloads of n u8 symbols, ``syms`` (B, n), against one
    (256,) int32 ``freq``/``cum`` table (sum 4096, every entry >= 1).
    Returns ``(buf, state, lens)``: ``(B, LANES, buf_cols(n))`` u8 byte
    planes (payload b's lane l stream is ``buf[b, l, :lens[b, l]]``, zeros
    after it) and ``(B, LANES)`` int32 final states and byte counts, each
    payload's bitwise what :func:`rans_encode` gives alone. ``enc`` is
    ``ref.rans_enc_table(freq, cum)`` on the card (built here when None;
    ``core.entropy`` passes its cached one); the CPU twin does not read it."""
    if _on_cpu(syms, freq, cum):
        outs = [ref.rans_encode(s, freq, cum) for s in syms]
        return tuple(torch.stack(t) for t in zip(*outs))
    _check(syms, "syms", torch.uint8)
    if syms.dim() != 2 or syms.shape[0] < 1:
        raise ValueError(f"syms must be (B >= 1, n), got {tuple(syms.shape)}")
    _check_table(freq, cum)
    if enc is None:
        enc = ref.rans_enc_table(freq, cum)
    _check(enc, "enc", torch.int32, (256, 2))
    batch, n = syms.shape
    cols = buf_cols(n)
    buf = torch.zeros((batch, LANES, cols), dtype=torch.uint8, device=syms.device)
    state = torch.empty((batch, LANES), dtype=torch.int32, device=syms.device)
    lens = torch.empty_like(state)
    rc = load().repro_rans_encode(syms.data_ptr(), n, n_steps(n), cols, batch,
                                  enc.data_ptr(), buf.data_ptr(), state.data_ptr(),
                                  lens.data_ptr(), _stream())
    _launched(rc, "rans_encode")
    return buf, state, lens


def rans_decode_many(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                     freq: torch.Tensor, cum: torch.Tensor,
                     slot2sym: torch.Tensor) -> torch.Tensor:
    """Decode B :func:`rans_encode_many` payloads of one table back to their
    (B, n) u8 symbols: ``buf`` (B, LANES, >= buf_cols(n)), ``state`` and
    ``lens`` (B, LANES) int32; ``slot2sym`` is the (4096,) int32 inverse of
    ``cum``."""
    if _on_cpu(buf, state, lens, freq, cum, slot2sym):
        return torch.stack([ref.rans_decode(b, s, ln, n, freq, cum, slot2sym)
                            for b, s, ln in zip(buf, state, lens)])
    _check(buf, "buf", torch.uint8)
    if buf.dim() != 3 or buf.shape[0] < 1 or buf.shape[1] != LANES \
            or buf.shape[2] < buf_cols(n):
        raise ValueError(f"buf must be (B >= 1, {LANES}, >= {buf_cols(n)}) for {n} symbols, "
                         f"got {tuple(buf.shape)}")
    batch = buf.shape[0]
    _check(state, "state", torch.int32, (batch, LANES))
    _check(lens, "lens", torch.int32, (batch, LANES))
    _check_table(freq, cum)
    _check(slot2sym, "slot2sym", torch.int32, (TAB,))
    out = torch.empty((batch, n), dtype=torch.uint8, device=buf.device)
    rc = load().repro_rans_decode(buf.data_ptr(), buf.shape[2], state.data_ptr(),
                                  lens.data_ptr(), n, n_steps(n), batch, freq.data_ptr(),
                                  cum.data_ptr(), slot2sym.data_ptr(), out.data_ptr(),
                                  _stream())
    _launched(rc, "rans_decode")
    return out


def rans_encode(syms: torch.Tensor, freq: torch.Tensor, cum: torch.Tensor,
                enc: torch.Tensor | None = None):
    """Encode (n,) u8 symbols: :func:`rans_encode_many` of one payload,
    ``(buf (LANES, buf_cols(n)), state (LANES,), lens (LANES,))``."""
    if syms.dim() != 1:
        raise ValueError(f"syms must be (n,), got {tuple(syms.shape)}")
    buf, state, lens = rans_encode_many(syms.reshape(1, -1), freq, cum, enc)
    return buf[0], state[0], lens[0]


def rans_decode(buf: torch.Tensor, state: torch.Tensor, lens: torch.Tensor, n: int,
                freq: torch.Tensor, cum: torch.Tensor, slot2sym: torch.Tensor) -> torch.Tensor:
    """Decode one :func:`rans_encode` payload, ``buf`` (LANES, >=
    buf_cols(n)), back to its (n,) u8 symbols."""
    if buf.dim() != 2 or buf.shape[0] != LANES or buf.shape[1] < buf_cols(n):
        raise ValueError(f"buf must be ({LANES}, >= {buf_cols(n)}) for {n} symbols, "
                         f"got {tuple(buf.shape)}")
    return rans_decode_many(buf[None], state.reshape(1, -1), lens.reshape(1, -1), n, freq,
                            cum, slot2sym)[0]


def chain_probe(mode: str, iters: int, freq: torch.Tensor, cum: torch.Tensor,
                slot2sym: torch.Tensor, enc: torch.Tensor) -> torch.Tensor:
    """Launch ``rans_chain_kernel`` on the card: one warp running ``iters``
    dependent iterations of the decode's chain (``mode="decode"``: the
    shared table lookup, multiply-add and renorm select) or the encode's
    (``"encode"``: the renorm select, high multiply, shift and multiply-add),
    nothing else; returns the 32 final states. Its time over ``iters`` is
    the least time of one row; not counted in ``LAUNCHES`` (no path runs
    it)."""
    if mode not in ("decode", "encode"):
        raise ValueError(f"mode must be 'decode' or 'encode', got {mode!r}")
    if _on_cpu(freq, cum, slot2sym, enc):
        raise ValueError("chain_probe times the card's chain: tensors must be on CUDA")
    _check_table(freq, cum)
    _check(slot2sym, "slot2sym", torch.int32, (TAB,))
    _check(enc, "enc", torch.int32, (256, 2))
    out = torch.empty(32, dtype=torch.int32, device=freq.device)
    rc = load().repro_rans_chain(0 if mode == "decode" else 1, iters, freq.data_ptr(),
                                 cum.data_ptr(), slot2sym.data_ptr(), enc.data_ptr(),
                                 out.data_ptr(), _stream())
    if rc != 0:
        raise RuntimeError(f"rans_chain_kernel launch failed: CUDA error {rc}")
    return out
