"""Static-table entropy coding over the grid codecs' code streams, the port
of ``repro.core.entropy``.

The FP8/FP4 wire charges every code at its full width, but the codes are far
from uniform: weights are bell-shaped around zero and delta residuals more
peaked still. Codes are bin indices relative to the clip value, so under a
Gaussian value model ``x ~ N(0, (sigma * alpha)^2)`` each code's probability
is the mass of its rounding bin, whatever alpha is: the table depends on the
grid and ``sigma`` alone and never crosses the wire. :class:`RansCodec`
range-codes the inner codec's byte stream against it with the 16-lane rANS
coder of ``kernels.rans``, through ``kernels.dispatch.rans_encode`` and
``rans_decode``, or a cohort's uplink payloads in one launch of each
(:meth:`RansCodec.cohort_transit`, ``rans_encode_many`` / ``rans_decode_many``).

Frequencies sum to ``2^SCALE_BITS`` with every byte kept at >= 1, so any
stream decodes and the largest frequency stays at most ``4096 - 255`` (the
int32 bound of the coder). Sub-byte formats code the PACKED byte stream, the
byte's probability the product of its nibbles' (low nibble first). The table
is built in numpy, step for step the reference's (``np.argsort`` included,
whose tie order a torch sort would not reproduce), so both packages code
against the same integers.

Dynamic payloads: the coded size depends on the data, so ``payload_nbytes``
is the static bound (``16 * buf_cols(n)`` bytes of planes, ``8 * LANES`` of
state and lengths, the inner riders) that ``metrics`` reports, and
``payload_nbytes_traced`` the true size (``sum(lens)`` + the same
constants), which the engine charges to ``wire_bytes``.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from . import fp8
from .codec import DeltaCodec, Fp8Codec, WireCodec
from .fp8 import FP8Format
from ..kernels import dispatch
from ..kernels import rans as rans_kernel
from ..kernels import ref as kernel_ref
from ..kernels.ref import codes_per_byte

# value-scale priors in units of the clip (the reference's, fitted on real
# federated payloads): plain weight streams near 0.28, delta streams near 0.14
SIGMA_PLAIN = 0.28
SIGMA_DELTA = 0.14


def _one_sided_mass(z: np.ndarray) -> np.ndarray:
    """P(|X| <= z) for a standard normal X."""
    out = np.empty(z.shape, np.float64)
    for i, v in enumerate(z.reshape(-1)):
        out.reshape(-1)[i] = 1.0 if math.isinf(v) else math.erf(v / math.sqrt(2.0))
    return out


def _unpack_np(codes: np.ndarray, fmt: FP8Format) -> np.ndarray:
    """The codes' values at alpha = 1, in float64 (numpy ``unpack_fp8``)."""
    b = 2.0 ** fmt.exp + np.log2(fmt.mant_scale) - 1.0
    sign = (codes >> (fmt.exp + fmt.mant)) & 0x1
    f = (codes >> fmt.mant) & (2 ** fmt.exp - 1)
    m_field = codes & (2 ** fmt.mant - 1)
    is_normal = f >= 1
    v = np.where(is_normal, m_field + 2 ** fmt.mant, m_field)
    p_eff = np.where(is_normal, f, 1)
    s = 2.0 ** (p_eff.astype(np.float64) - b - fmt.mant)
    return np.where(sign == 1, -1.0, 1.0) * v * s


@functools.lru_cache(maxsize=None)
def code_probabilities(fmt: FP8Format, sigma: float) -> np.ndarray:
    """(2**bits,) probability of each grid code under the Gaussian value
    model; the two signed codes of a magnitude split its one-sided mass."""
    n_codes = 1 << (fmt.exp + fmt.mant + 1)
    vals = _unpack_np(np.arange(n_codes), fmt)
    grid = np.asarray(fp8.quantization_grid(1.0, fmt), np.float64)
    gidx = np.abs(grid[None, :] - np.abs(vals)[:, None]).argmin(axis=1)
    mids = 0.5 * (grid[1:] + grid[:-1])
    lo = np.concatenate([[0.0], mids])
    hi = np.concatenate([mids, [np.inf]])
    mass = _one_sided_mass(hi / sigma) - _one_sided_mass(lo / sigma)
    counts = np.bincount(gidx, minlength=len(grid)).astype(np.float64)
    return mass[gidx] / counts[gidx]


def _normalize_freqs(p: np.ndarray, tab: int) -> np.ndarray:
    """Probabilities -> integer frequencies summing to ``tab``, each >= 1
    (largest-remainder apportionment)."""
    scaled = p * tab
    f = np.maximum(1, np.floor(scaled).astype(np.int64))
    diff = tab - int(f.sum())
    if diff > 0:
        order = np.argsort(-(scaled - np.floor(scaled)))
        i = 0
        while diff > 0:
            f[order[i % len(f)]] += 1
            diff -= 1
            i += 1
    elif diff < 0:
        order = np.argsort(-f)
        i = 0
        while diff < 0:
            j = order[i % len(f)]
            if f[j] > 1:
                f[j] -= 1
                diff += 1
            i += 1
    return f


@functools.lru_cache(maxsize=None)
def byte_table(fmt: FP8Format, sigma: float):
    """The static rANS table of ``fmt``'s BYTE stream at value scale
    ``sigma``: ``(freq, cum, slot2sym)`` int32 numpy arrays of shapes
    (256,), (256,), (4096,)."""
    p = code_probabilities(fmt, float(sigma))
    k = codes_per_byte(fmt)
    if k > 1:
        mask = (1 << fmt.bits) - 1
        b = np.arange(256)
        pb = np.ones(256, np.float64)
        for j in range(k):
            pb = pb * p[(b >> (fmt.bits * j)) & mask]
    else:
        pb = p
    freq = _normalize_freqs(pb, rans_kernel.TAB)
    assert freq.sum() == rans_kernel.TAB and freq.min() >= 1
    assert freq.max() <= rans_kernel.TAB - 255
    cum = np.concatenate([[0], np.cumsum(freq)[:-1]])
    slot2sym = np.repeat(np.arange(256), freq)
    return freq.astype(np.int32), cum.astype(np.int32), slot2sym.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_table(fmt: FP8Format, sigma: float, device: str):
    return tuple(torch.from_numpy(a).to(device) for a in byte_table(fmt, sigma))


@functools.lru_cache(maxsize=None)
def _device_enc_table(fmt: FP8Format, sigma: float, device: str) -> torch.Tensor:
    freq, cum, _ = (torch.from_numpy(a) for a in byte_table(fmt, sigma))
    return kernel_ref.rans_enc_table(freq, cum).to(device)


@dataclasses.dataclass(frozen=True)
class RansCodec(WireCodec):
    """rANS over the inner grid codec's code stream (``rans:<inner>``).

    Lossless on the codes: the receiver decodes exactly the inner payload, so
    values are the inner codec's and only the wire size changes. The table's
    prior is ``SIGMA_DELTA`` over a delta inner, ``SIGMA_PLAIN`` otherwise.
    The payload is ``{"codes": coded planes,
    "other": inner riders, "rans": (state (LANES,) i32, lens (LANES,) i32)}``.
    """

    inner: WireCodec = Fp8Codec()

    dynamic = True

    def __post_init__(self):
        inner = self.inner
        grid = inner.inner if isinstance(inner, DeltaCodec) else inner
        if not isinstance(grid, Fp8Codec):  # includes PackedFpCodec
            raise ValueError(
                "RansCodec range-codes a grid codec's byte stream: inner must be "
                "Fp8Codec/PackedFpCodec or DeltaCodec over one; got "
                f"{type(inner).__name__}")

    @property
    def tag(self) -> str:
        return f"rans:{self.inner.tag}"

    @property
    def grid_fmt(self) -> FP8Format:
        inner = self.inner
        return inner.inner.fmt if isinstance(inner, DeltaCodec) else inner.fmt

    @property
    def table_sigma(self) -> float:
        return SIGMA_DELTA if isinstance(self.inner, DeltaCodec) else SIGMA_PLAIN

    def table(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(freq, cum, slot2sym)`` as int32 tensors on ``device``."""
        return _device_table(self.grid_fmt, self.table_sigma, str(torch.device(device)))

    def enc_table(self, device) -> torch.Tensor:
        """The encode kernel's reciprocal table (``ref.rans_enc_table``) on
        ``device``, built at first use."""
        return _device_enc_table(self.grid_fmt, self.table_sigma, str(torch.device(device)))

    def encode(self, params, spec, key2, ref=None):
        p = self.inner.encode(params, spec, key2, ref=ref)
        codes = p["codes"].contiguous()
        freq, cum, _ = self.table(codes.device)
        buf, state, lens = dispatch.rans_encode(codes, freq, cum, self.enc_table(codes.device))
        return {"codes": buf.reshape(-1), "other": p["other"], "rans": (state, lens)}

    def cohort_transit(self, inner_payloads: list[dict], spec, ref=None):
        """The rANS stage of a cohort's uplink: the inner codec's payloads
        (one a client, all of one length) range-coded in one encode launch
        and decoded in one decode launch, then inner-decoded against ``ref``
        straight from the decoded ``(P, n)`` symbols
        (:meth:`~repro_torch.core.codec.WireCodec.decode_many`: an FP4 inner
        in one launch). Returns ``(msgs, payloads)``: the received trees and
        each client's payload as :meth:`encode` gives it, bitwise those of
        :meth:`encode` and :meth:`decode` one client at a time."""
        codes = torch.stack([p["codes"].reshape(-1) for p in inner_payloads])
        dev = codes.device
        freq, cum, s2s = self.table(dev)
        buf, state, lens = dispatch.rans_encode_many(codes, freq, cum, self.enc_table(dev))
        syms = dispatch.rans_decode_many(buf, state, lens, self.inner.code_nbytes(spec), freq,
                                         cum, s2s)
        msgs = self.inner.decode_many([{"codes": s, "other": p["other"]}
                                       for s, p in zip(syms, inner_payloads)], spec, ref=ref,
                                      codes=syms)
        payloads = [{"codes": b.reshape(-1), "other": p["other"], "rans": (st, ln)}
                    for b, st, ln, p in zip(buf, state, lens, inner_payloads)]
        return msgs, payloads

    def decode(self, payload, spec, ref=None):
        buf = payload["codes"].reshape(rans_kernel.LANES, -1)
        state, lens = payload["rans"]
        freq, cum, s2s = self.table(buf.device)
        syms = dispatch.rans_decode(buf, state, lens, self.inner.code_nbytes(spec),
                                    freq, cum, s2s)
        return self.inner.decode({"codes": syms, "other": payload["other"]}, spec, ref=ref)

    def payload_nbytes(self, spec):
        # the static bound: full coded planes, per-lane state and length, and
        # the inner codec's FP32 riders
        return self.code_nbytes(spec) + 8 * rans_kernel.LANES + self._rider_nbytes(spec)

    def code_nbytes(self, spec):
        return rans_kernel.LANES * rans_kernel.buf_cols(self.inner.code_nbytes(spec))

    def _rider_nbytes(self, spec) -> int:
        return self.inner.payload_nbytes(spec) - self.inner.code_nbytes(spec)

    def payload_nbytes_traced(self, payload, spec) -> torch.Tensor:
        _, lens = payload["rans"]
        return (torch.sum(lens.to(torch.int64))
                + (8 * rans_kernel.LANES + self._rider_nbytes(spec)))
