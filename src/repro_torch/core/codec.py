"""Wire codecs, first slice of the port of ``repro.core.codec``.

A ``WireCodec`` owns one leg's compression and its byte accounting:
``encode(params, spec, key2) -> payload``, ``decode(payload, spec)``,
``payload_nbytes(spec)``. This slice ports the two codecs the paper's
method grid needs:

* :class:`Fp8Codec` — the flat-buffer FP8 wire of ``core.wire``: 1
  byte/element + FP32 riders, ``rounding`` 'rand' (unbiased stochastic
  rounding, Lemma 3) or 'det' (the biased Table-2 ablation);
* :class:`Fp32Codec` — the FP32 passthrough leg (FedAvg baseline).

``key2`` is the leg's ``(2,)`` u32 stochastic-rounding key (the reference
derives the same two words from a ``jax.random`` key). Packed FP4, delta,
schedules, entropy coding and error feedback wait for later slices.
"""
from __future__ import annotations

import dataclasses

import torch

from . import wire
from .fp8 import E4M3, FP8Format
from .. import tree


def _fp32_nbytes(spec: wire.WireSpec) -> int:
    """Bytes of one uncompressed model copy (every element at 4 bytes)."""
    return 4 * (spec.total + spec.n_other_elems)


class WireCodec:
    """Protocol base: one leg's wire compression."""

    quantized = True

    def encode(self, params: dict, spec: wire.WireSpec,
               key2: torch.Tensor | None) -> dict:
        raise NotImplementedError

    def decode(self, payload: dict, spec: wire.WireSpec) -> dict:
        raise NotImplementedError

    def payload_nbytes(self, spec: wire.WireSpec) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Fp32Codec(WireCodec):
    """FP32 passthrough — the FedAvg baseline leg (legacy ``mode='none'``)."""

    quantized = False

    def encode(self, params, spec, key2):
        return {"codes": torch.zeros(0, dtype=torch.uint8),
                "other": tuple(tree.leaves(params))}

    def decode(self, payload, spec):
        return tree.unflatten(list(spec.names), list(payload["other"]))

    def payload_nbytes(self, spec):
        return _fp32_nbytes(spec)


@dataclasses.dataclass(frozen=True)
class Fp8Codec(WireCodec):
    """The paper's FP8 wire (1 byte/element + FP32 riders) over ``core.wire``."""

    fmt: FP8Format = E4M3
    rounding: str = "rand"

    def __post_init__(self):
        if self.rounding not in ("rand", "det"):
            raise ValueError(f"rounding {self.rounding!r}: 'rand' or 'det'"
                             " (the FP32 leg is Fp32Codec, not a mode)")
        if self.fmt.bits != 8:
            raise ValueError(f"Fp8Codec packs 1 code/byte; {self.fmt.bits}-bit "
                             "formats are not ported yet")

    def encode(self, params, spec, key2):
        return wire.encode(params, spec, key2, fmt=self.fmt, mode=self.rounding)

    def decode(self, payload, spec):
        return wire.decode(payload, spec, fmt=self.fmt)

    def payload_nbytes(self, spec):
        return wire.payload_nbytes(spec)


def codec_for(fmt: FP8Format, mode: str) -> WireCodec:
    """The legacy ``(fmt, mode)`` pair -> codec (``mode='none'`` is FP32)."""
    if mode == "none":
        return Fp32Codec()
    return Fp8Codec(fmt, mode)


def leg_nbytes(codec: WireCodec, spec: wire.WireSpec) -> int:
    """Exact static bytes of one model copy on a leg using ``codec``; a tree
    with no quantized leaves rides FP32 whatever the codec says."""
    if codec.quantized and spec.q_slots:
        return codec.payload_nbytes(spec)
    return _fp32_nbytes(spec)
