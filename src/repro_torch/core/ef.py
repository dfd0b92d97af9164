"""EF21-style error feedback, the port of ``repro.core.ef``.

A biased (det) grid codec leaves a systematic rounding error that the
weighted mean never cancels. Error feedback keeps, per client, what
compression destroyed and adds it back before the next encode:

    compensated = client_params + e_i
    message     = Q(compensated)
    e_i        <- compensated - message

:class:`ErrorFeedbackCodec` (``ef:<inner>``) is that wrapper. The residual
must persist across rounds per client, so it cannot run through the
stateless ``encode``/``decode`` protocol (they raise): the engine keeps a
:class:`ClientState` in ``engine.ServerState.clients``, gathers the cohort's
rows, calls :meth:`ErrorFeedbackCodec.up_transit` and scatters the new rows
back. The residual covers the quantized leaves only (the FP32 riders lose
nothing). EF runs on the uplink only: the downlink's receivers are freshly
sampled clients with no memory of earlier broadcasts (``engine.WireLink``
rejects it there). A delta inner is rejected: its reference residual and
EF's memory residual are competing mechanisms.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from . import wire
from .codec import DeltaCodec, Fp8Codec, WireCodec
from .entropy import RansCodec
from .plane import f32, nelem
from .. import tree


class ClientState(NamedTuple):
    """Persistent per-client engine state: ``resid`` is the ``(n_clients,
    spec.total)`` f32 error-feedback memory, row i client i's flattened
    quantized-leaf residual, zero until its first transmission."""

    resid: torch.Tensor


def init_client_state(n_clients: int, spec: wire.WireSpec, device="cpu") -> ClientState:
    return ClientState(resid=torch.zeros((n_clients, spec.total), dtype=torch.float32,
                                         device=device))


def flatten_q(params: dict, spec: wire.WireSpec) -> torch.Tensor:
    """Quantized leaves -> one ``(spec.total,)`` f32 vector in ``spec.q_offsets``
    order (the code buffer's layout, no tile padding)."""
    leaves = tree.leaves(params)
    if not spec.q_slots:
        return torch.zeros(0, dtype=torch.float32, device=leaves[0].device)
    return torch.cat([f32(leaves[i].reshape(-1)) for i in spec.q_slots])


def add_resid(params: dict, e: torch.Tensor, spec: wire.WireSpec) -> dict:
    """``params + e`` on the quantized leaves only (the EF compensation),
    each cast back to its leaf's dtype."""
    leaves = list(tree.leaves(params))
    for qi, slot in enumerate(spec.q_slots):
        off, shape = spec.q_offsets[qi], spec.q_shapes[qi]
        leaves[slot] = (f32(leaves[slot]) + e[off:off + nelem(shape)].reshape(shape)
                        ).to(leaves[slot].dtype)
    return tree.unflatten(list(spec.names), leaves)


_NEEDS_ENGINE = (
    "ErrorFeedbackCodec is stateful (per-client residual memory) and cannot run "
    "through the stateless encode/decode protocol: drive it through "
    "engine.RoundEngine (uplink leg), which threads ClientState.resid, or call "
    "up_transit() with explicit residual rows")


@dataclasses.dataclass(frozen=True)
class ErrorFeedbackCodec(WireCodec):
    """Error feedback over a grid codec or a :class:`RansCodec` over one;
    byte accounting and ``dynamic`` are the inner codec's (EF adds nothing
    to the wire)."""

    inner: WireCodec = Fp8Codec()

    def __post_init__(self):
        inner = self.inner
        if isinstance(inner, DeltaCodec) or (isinstance(inner, RansCodec)
                                             and isinstance(inner.inner, DeltaCodec)):
            raise ValueError(
                "ErrorFeedbackCodec over DeltaCodec is not supported: EF memory "
                "residuals and delta reference residuals are competing mechanisms; "
                "use ef:<grid> or ef:rans:<grid>")
        if not isinstance(inner, (Fp8Codec, RansCodec)):
            raise ValueError("ErrorFeedbackCodec composes over a grid codec (Fp8Codec/"
                             f"PackedFpCodec) or RansCodec; got {type(inner).__name__}")

    @property
    def tag(self) -> str:
        return f"ef:{self.inner.tag}"

    @property
    def dynamic(self) -> bool:
        return self.inner.dynamic

    def up_transit(self, client_params: list[dict], spec: wire.WireSpec,
                   keys: torch.Tensor, e_sel: torch.Tensor):
        """One uplink leg of the cohort with residual memory: ``keys`` the
        ``(P, 2)`` u32 encode keys, ``e_sel`` the cohort's ``(P, spec.total)``
        residual rows. Returns ``(msgs, new_e, payloads)``: the decoded
        messages the server aggregates, the updated rows, and the inner
        payloads (read for a dynamic inner's traced bytes). Each client is
        compensated, then the cohort grid-coded through the grid codec's
        :meth:`~repro_torch.core.codec.WireCodec.encode_many` and
        :meth:`~repro_torch.core.codec.WireCodec.decode_many` (an FP4 grid:
        one launch each way); a :class:`RansCodec` inner range-codes the
        cohort between them in one launch each way
        (:meth:`RansCodec.cohort_transit`). Bitwise a client at a time."""
        rans = isinstance(self.inner, RansCodec)
        comps = [add_resid(p, e, spec) for p, e in zip(client_params, e_sel)]
        flat = [flatten_q(comp, spec) for comp in comps]
        inner = (self.inner.inner if rans else self.inner).encode_many(comps, spec, keys)
        del comps
        if rans:
            msgs, payloads = self.inner.cohort_transit(inner, spec)
        else:
            msgs, payloads = self.inner.decode_many(inner, spec), inner
        new_e = [f - flatten_q(m, spec) for f, m in zip(flat, msgs)]
        return msgs, torch.stack(new_e), payloads

    def encode(self, params, spec, key2, ref=None):
        raise ValueError(_NEEDS_ENGINE)

    def decode(self, payload, spec, ref=None):
        raise ValueError(_NEEDS_ENGINE)

    def fake_quant(self, params, spec, key2, ref=None):
        raise ValueError(_NEEDS_ENGINE)

    def payload_nbytes(self, spec):
        return self.inner.payload_nbytes(spec)

    def code_nbytes(self, spec):
        return self.inner.code_nbytes(spec)

    def payload_nbytes_traced(self, payload, spec):
        return self.inner.payload_nbytes_traced(payload, spec)
