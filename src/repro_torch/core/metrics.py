"""Exact wire-byte accounting, the port of ``repro.core.metrics``.

Payload sizes are owned by the wire codecs (``core.codec``); both uplink
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


def round_bytes_for(params: dict, cfg: Any) -> int:
    """Static round bytes for a :class:`repro_torch.core.engine.FedConfig`:
    P x (down leg + up leg), each leg at its real payload size."""
    spec = wire.make_wire_spec(params)
    down = codec_lib.leg_nbytes(cfg.resolved_down_codec, spec)
    up = codec_lib.leg_nbytes(cfg.resolved_up_codec, spec)
    return cfg.clients_per_round * (down + up)
