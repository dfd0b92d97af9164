"""Exact wire-byte accounting, the port of ``repro.core.metrics``.

Payload sizes are owned by the wire codecs (``core.codec``): the FP8 wire
is 1 byte/element + FP32 riders, FP4 half a byte/element, a delta leg adds
one FP32 clip scalar per quantized leaf, an FP32 leg is 4 bytes/element,
and a scaling policy adds its rider delta (``core.scaling``). An
entropy-coded (``rans:``) leg counts its static bound here; the bytes it
really moved are measured by the round (``engine`` ``wire_bytes``). Both uplink
(P clients -> server) and downlink (server -> P clients) are counted,
matching Figure 1 of the paper. The paper's headline metric is the
communication gain: FP32 FedAvg bytes over the method's bytes, each up to
the round where the method reaches the comparison accuracy; the gain
itself is read off ``FedHistory.cumulative_bytes``.
"""
from __future__ import annotations

from typing import Any

from . import codec as codec_lib
from . import wire
from .. import tree


def payload_bytes(params: dict, quantized: bool = True, codec: Any = None) -> int:
    """Bytes to transmit one model copy with ``codec`` (a codec or registry
    name); ``None`` keeps the legacy boolean: the E4M3 wire when
    ``quantized``, else FP32."""
    codec = codec_lib.get_codec(codec if codec is not None
                                else ("e4m3" if quantized else "fp32"))
    return codec_lib.leg_nbytes(codec, wire.make_wire_spec(params))


def round_bytes(params: dict, n_clients: int, quantized: bool = True,
                up_quantized: bool | None = None, down_codec: Any = None,
                up_codec: Any = None) -> int:
    """Uplink + downlink bytes of one round with ``n_clients`` clients;
    ``up_quantized`` defaults to ``quantized``, and the codec arguments
    override the booleans."""
    down = payload_bytes(params, quantized, codec=down_codec)
    up = payload_bytes(params, quantized if up_quantized is None else up_quantized,
                       codec=up_codec)
    return n_clients * (down + up)


def round_bytes_for(params: dict, cfg: Any) -> int:
    """Static round bytes for a :class:`repro_torch.core.engine.FedConfig`:
    P x (down leg + up leg), each leg at its codec's payload size plus its
    scaling policy's rider delta."""
    spec = wire.make_wire_spec(params)
    down = codec_lib.leg_nbytes(cfg.resolved_down_codec, spec,
                                policy=cfg.resolved_down_scaling)
    up = codec_lib.leg_nbytes(cfg.resolved_up_codec, spec,
                              policy=cfg.resolved_up_scaling)
    return cfg.clients_per_round * (down + up)


def param_count(params: dict) -> int:
    return sum(leaf.numel() for leaf in tree.leaves(params))
