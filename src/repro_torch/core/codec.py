"""Wire codecs, the port of ``repro.core.codec``.

A ``WireCodec`` owns one leg's compression and its byte accounting:

* ``encode(params, spec, key2, ref=None) -> {"codes": u8[n], "other":
  (leaf, ...)}`` — the payload a transmitter ships; ``codes`` is the
  compressed weight buffer (its length is the codec's business), ``other``
  the FP32 riders;
* ``decode(payload, spec, ref=None)`` — the tree a receiver rebuilds;
* ``encode_many`` / ``decode_many`` — the same for a cohort's payloads,
  each bitwise its single call's; the FP4 codecs take a chunk of clients in
  one launch each way;
* ``payload_nbytes(spec)`` / ``code_nbytes(spec)`` — exact bytes of one
  model copy / of its codes alone; ``tag`` is the registry name;
* ``payload_nbytes_traced(payload, spec)`` — the bytes of one concrete
  payload. A ``dynamic`` codec (entropy coding) has a data-dependent size:
  its ``payload_nbytes`` is then the static BOUND, which ``core.metrics``
  reports, and the engine charges ``wire_bytes`` from this traced lane.
  For every other codec the two lanes are the same number.

``key2`` is the leg's ``(2,)`` u32 stochastic-rounding key (the reference
derives the same two words from a ``jax.random`` key). ``ref`` is the
round's reference model, held by both ends of the leg; only
:class:`DeltaCodec` reads it. The codecs:

* :class:`Fp32Codec` — the FP32 passthrough leg (FedAvg baseline).
* :class:`Fp8Codec` — the flat-buffer FP8 wire of ``core.wire``: 1
  byte/element, ``rounding`` 'rand' (unbiased, Lemma 3) or 'det'.
* :class:`PackedFpCodec` — FP4 E2M1/E3M0 at 2 codes per byte through
  ``quant_pack_sub_tiles`` / ``unpack_sub_tiles``; a leaf of n elements
  takes ``ceil(n * bits / 8)`` bytes.
* :class:`DeltaCodec(inner)` — the inner grid codec over the residual
  ``params - ref``, each leaf clipped at its fresh ``max|params - ref|``,
  which rides as one ``(n_q,)`` FP32 rider. Uplink only.

Two wrappers come from their own modules: ``core.entropy.RansCodec``
(``rans:<inner>``, static-table rANS over the inner codec's code stream) and
``core.ef.ErrorFeedbackCodec`` (``ef:<inner>``, per-client residual memory,
uplink only, driven by the engine through ``up_transit``).

The grid codecs also take explicit scales (``encode_scaled`` /
``decode_scaled``) for the policies of ``core.scaling``: delayed scaling
ships its effective scales as one ``(n_q,)`` rider and takes next round's
amax from the encode launch (``encode_scaled_many``: a chunk of clients,
or the broadcast, in one launch); frozen scaling drops the alpha riders and
the receiver splices them back.

:func:`get_codec` resolves registry names (``e4m3``, ``e5m2_det``, ``fp4``
= ``fp4_e2m1``, ``fp4_e3m0``, ``delta:<inner>``, ``rans:<inner>``,
``ef:<inner>``, ``fp32``/``none``, ...). Codec schedules and the codecs'
one-launch ``fake_quant`` transit are not ported.
"""
from __future__ import annotations

import dataclasses

import torch

from . import fp8, wire
from .fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0, FP8Format
from .plane import f32
from .. import tree
from ..kernels.ref import codes_per_byte


def _fp32_nbytes(spec: wire.WireSpec) -> int:
    """Bytes of one uncompressed model copy (every element at 4 bytes)."""
    return 4 * (spec.total + spec.n_other_elems)


def _no_codes(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(0, dtype=torch.uint8, device=like.device)


class WireCodec:
    """Protocol base: one leg's wire compression (see module docstring)."""

    tag = "?"
    quantized = True
    dynamic = False

    def encode(self, params: dict, spec: wire.WireSpec,
               key2: torch.Tensor | None, ref: dict | None = None) -> dict:
        raise NotImplementedError

    def decode(self, payload: dict, spec: wire.WireSpec,
               ref: dict | None = None) -> dict:
        raise NotImplementedError

    def encode_many(self, params_list, spec: wire.WireSpec, keys: torch.Tensor,
                    ref: dict | None = None) -> list[dict]:
        """:meth:`encode` of a cohort's models, ``keys`` their ``(P, 2)``
        words: one payload a client, each its :meth:`encode`'s. Here one
        encode a client; the FP4 codecs encode the cohort in one launch."""
        return [self.encode(p, spec, k, ref=ref) for p, k in zip(params_list, keys)]

    def decode_many(self, payloads: list[dict], spec: wire.WireSpec,
                    ref: dict | None = None, codes: torch.Tensor | None = None) -> list[dict]:
        """:meth:`decode` of a cohort's payloads: one tree a client, each its
        :meth:`decode`'s. ``codes``, where the caller holds them so, is the
        payloads' codes as one ``(P, n)`` stack. Here one decode a client;
        the FP4 codecs decode a chunk of clients in one launch."""
        return [self.decode(p, spec, ref=ref) for p in payloads]

    def payload_nbytes(self, spec: wire.WireSpec) -> int:
        raise NotImplementedError

    def code_nbytes(self, spec: wire.WireSpec) -> int:
        raise NotImplementedError

    def payload_nbytes_traced(self, payload: dict, spec: wire.WireSpec):
        """Bytes of this concrete payload; the static count unless ``dynamic``."""
        return self.payload_nbytes(spec)


@dataclasses.dataclass(frozen=True)
class Fp32Codec(WireCodec):
    """FP32 passthrough — the FedAvg baseline leg (legacy ``mode='none'``)."""

    quantized = False

    @property
    def tag(self) -> str:
        return "fp32"

    def encode(self, params, spec, key2, ref=None):
        leaves = tree.leaves(params)
        return {"codes": _no_codes(leaves[0]), "other": tuple(leaves)}

    def decode(self, payload, spec, ref=None):
        return tree.unflatten(list(spec.names), list(payload["other"]))

    def payload_nbytes(self, spec):
        return _fp32_nbytes(spec)

    def code_nbytes(self, spec):
        return 0


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
                             "formats go through PackedFpCodec")

    @property
    def tag(self) -> str:
        t = f"e{self.fmt.exp}m{self.fmt.mant}"
        return t if self.rounding == "rand" else t + "_det"

    def encode(self, params, spec, key2, ref=None):
        return wire.encode(params, spec, key2, fmt=self.fmt, mode=self.rounding)

    def decode(self, payload, spec, ref=None):
        return wire.decode(payload, spec, fmt=self.fmt)

    def payload_nbytes(self, spec):
        return wire.payload_nbytes(spec, self.fmt)

    def code_nbytes(self, spec):
        return sum(wire.code_sizes(spec, self.fmt))

    def key(self, key2):
        """The leg's key words as the encode launch takes them (None: det)."""
        return key2 if self.rounding == "rand" else None

    # --- explicit-scale encode/decode (core.scaling policies) -------------
    def encode_scaled(self, params, spec, key2, alphas, *, drop_alphas: bool = False):
        """Encode at an explicit ``(n_q,)`` scale vector instead of the
        tree's trained alphas (floored at ``fp8._ALPHA_FLOOR``).

        By default ``alphas`` rides as one extra ``(n_q,)`` FP32 rider
        (delayed scaling); ``drop_alphas=True`` removes the alpha riders
        from ``other`` (frozen scaling, -4 B per quantized leaf). The same
        encode with the per-leaf raw amax is :meth:`encode_scaled_many`.
        """
        leaves = tree.leaves(params)
        other = tuple(leaves[i] for i in spec.other_slots)
        if drop_alphas:
            hidden = set(spec.alpha_pos)
            other = tuple(o for oi, o in enumerate(other) if oi not in hidden)
        else:
            other = other + (f32(alphas).reshape(-1),)
        codes = wire.pack(wire.weight_tiles(leaves, spec), wire.alpha_column(alphas, spec),
                          self.key(key2), spec, self.fmt)
        return {"codes": codes, "other": other}

    def encode_scaled_many(self, params_list, spec, keys, alphas):
        """:meth:`encode_scaled` of a chunk of clients' models (the uplink's,
        or the one broadcast) at one ``(n_q,)`` scale vector, ``keys`` their
        ``(P, 2)`` words, with each model's per-leaf raw amax for delayed
        scaling: ``(payloads, amax (P, n_q))`` from one amax encode launch
        (``quant_pack_amax_many``; the clip column expanded over the chunk,
        not copied), each payload bitwise :meth:`encode_scaled`'s."""
        leaves = [tree.leaves(p) for p in params_list]
        x3 = torch.stack([wire.weight_tiles(lv, spec) for lv in leaves])
        a_col = wire.alpha_column(alphas, spec)
        codes, amax = wire.encode_amax_many(x3, a_col.expand(len(leaves), *a_col.shape),
                                            self.key(keys), spec, self.fmt)
        rider = f32(alphas).reshape(-1)
        return [{"codes": c, "other": tuple(lv[i] for i in spec.other_slots) + (rider,)}
                for c, lv in zip(codes, leaves)], amax

    def decode_scaled_many(self, payloads, spec):
        """:meth:`decode_scaled` of a cohort's payloads that ship their scale
        vector (delayed scaling). Here one decode a client; the FP4 codec
        decodes a chunk of clients in one launch."""
        return [self.decode_scaled(p, spec) for p in payloads]

    def decode_scaled(self, payload, spec, *, alphas=None, dropped: bool = False):
        """Decode an :meth:`encode_scaled` payload: the scale vector is the
        last rider, or (``dropped=True``, frozen) the receiver's own
        ``alphas``, spliced back into the tree at the alpha leaves' places
        and shapes — bitwise what shipping them would give."""
        other_all = tuple(payload["other"])
        if dropped:
            if alphas is None:
                raise ValueError("decode_scaled(dropped=True) needs the receiver-side "
                                 "alphas= vector (core.scaling.leaf_alphas)")
            a_vec = f32(alphas).reshape(-1)
            inv = {oi: qi for qi, oi in enumerate(spec.alpha_pos)}
            it = iter(other_all)
            other = tuple(a_vec[inv[oi]].reshape(spec.alpha_shapes[inv[oi]])
                          if oi in inv else next(it)
                          for oi in range(len(spec.other_slots)))
        else:
            a_vec, other = f32(other_all[-1]).reshape(-1), other_all[:-1]
        return wire.assemble(payload["codes"], other, wire.alpha_column(a_vec, spec),
                             spec, self.fmt)


@dataclasses.dataclass(frozen=True)
class PackedFpCodec(Fp8Codec):
    """Sub-byte ExMy wire: ``8 // fmt.bits`` codes per payload byte (FP4:
    2), through ``quant_pack_sub_tiles`` / ``unpack_sub_tiles`` on the same
    parametric grid and per-element counter RNG as the FP8 wire. An odd
    tail element shares its byte with a zero-code pad nibble. ``core.wire``
    picks the kernels from the format, so only the name and the check
    differ from :class:`Fp8Codec`."""

    fmt: FP8Format = FP4_E2M1
    rounding: str = "rand"

    def __post_init__(self):
        if self.rounding not in ("rand", "det"):
            raise ValueError(f"rounding {self.rounding!r}: 'rand' or 'det'")
        codes_per_byte(self.fmt)  # validates bits | 8
        if self.fmt.bits >= 8:
            raise ValueError("PackedFpCodec is for sub-byte formats; "
                             "8-bit formats are Fp8Codec")

    @property
    def tag(self) -> str:
        t = f"fp{self.fmt.bits}_e{self.fmt.exp}m{self.fmt.mant}"
        return t if self.rounding == "rand" else t + "_det"

    def decode_many(self, payloads, spec, ref=None, codes=None):
        """The cohort's decodes in one ``unpack_sub_many`` launch a chunk of
        clients (``wire.assemble_many``), each client's clip tiles its own
        alpha riders'; bitwise :meth:`decode` of each."""
        if not spec.q_slots:
            return super().decode_many(payloads, spec, ref=ref)

        def clips(chunk):
            others = [tuple(pl["other"]) for pl in chunk]
            return others, wire.alpha_tiles_many(others, spec)

        return wire.assemble_many(payloads, clips, spec, self.fmt, codes=codes)

    def decode_scaled_many(self, payloads, spec):
        """A cohort's delayed-scaling payloads in one ``unpack_sub_many``
        launch a chunk of clients, each at its own shipped scale vector;
        bitwise :meth:`decode_scaled` of each."""
        if not spec.q_slots:
            return super().decode_scaled_many(payloads, spec)
        return wire.assemble_many(payloads, _last_rider_clips(spec), spec, self.fmt)

    def encode_many(self, params_list, spec, keys, ref=None):
        """The cohort's encodes in one ``quant_pack_sub_many`` launch (a
        chunk of clients a launch, ``wire.encode_many``), bitwise
        :meth:`encode` of each."""
        if not spec.q_slots:
            return super().encode_many(params_list, spec, keys, ref=ref)
        leaves = [tree.leaves(p) for p in params_list]
        others = [tuple(lv[i] for i in spec.other_slots) for lv in leaves]
        codes = wire.encode_many(
            ((wire.weight_tiles(lv, spec), wire.alpha_tiles(o, spec))
             for lv, o in zip(leaves, others)), spec, self.key(keys), self.fmt)
        return [{"codes": c, "other": o} for c, o in zip(codes, others)]


@dataclasses.dataclass(frozen=True)
class DeltaCodec(WireCodec):
    """The inner grid codec over the residual ``params - ref``.

    ``ref`` is held by both ends of the leg (on the uplink: the broadcast the
    cohort trained from), so only the update crosses the wire. Each
    quantized leaf is clipped at its fresh ``max|params - ref|``, one extra
    FP32 scalar per leaf, so with stochastic inner rounding the leg stays
    unbiased and the grid shrinks to the residual's scale. The model's own
    clip values ride FP32 untouched.
    """

    inner: WireCodec = Fp8Codec(E4M3, "rand")

    def __post_init__(self):
        if not isinstance(self.inner, Fp8Codec):  # includes PackedFpCodec
            raise ValueError("DeltaCodec composes over a grid codec (Fp8Codec / "
                             f"PackedFpCodec); got {type(self.inner).__name__}")

    @property
    def tag(self) -> str:
        return f"delta:{self.inner.tag}"

    def encode(self, params, spec, key2, ref=None):
        leaves = tree.leaves(params)
        other = tuple(leaves[i] for i in spec.other_slots)
        if not spec.q_slots:
            return {"codes": _no_codes(leaves[0]),
                    "other": other + (torch.zeros(0, dtype=torch.float32,
                                                  device=leaves[0].device),)}
        if ref is None:
            raise ValueError("DeltaCodec needs the leg's reference model (ref=), which "
                             "the receiver must already hold: use it on the uplink")
        x2, d_alpha = self._residual(leaves, wire.weight_tiles(tree.leaves(ref), spec), spec)
        codes = wire.pack(x2, wire.alpha_column(d_alpha, spec), self.inner.key(key2),
                          spec, self.inner.fmt)
        # the residual clip values ride as ONE extra (n_q,) FP32 rider
        return {"codes": codes, "other": other + (d_alpha,)}

    @staticmethod
    def _residual(leaves, ref2, spec):
        """The residual tiles against the reference's tiles ``ref2``, and
        each leaf's clip: its max|residual|, floored."""
        x2 = wire.weight_tiles(leaves, spec) - ref2
        # per-row max in plain torch (the reference's plain jnp), then per leaf
        d_alpha = torch.clamp(wire.segment_amax(torch.amax(torch.abs(x2), dim=1), spec),
                              min=fp8._ALPHA_FLOOR)
        return x2, d_alpha

    def encode_many(self, params_list, spec, keys, ref=None):
        """Over an FP4 inner, the cohort's residuals in one
        ``quant_pack_sub_many`` launch (a chunk of clients a launch), each
        client's clips stacked into the launch's alphas; bitwise
        :meth:`encode` of each. Over an FP8 inner, one encode a client."""
        if not (spec.q_slots and isinstance(self.inner, PackedFpCodec)):
            return super().encode_many(params_list, spec, keys, ref=ref)
        if ref is None:
            raise ValueError("DeltaCodec needs the leg's reference model (ref=), which "
                             "the receiver must already hold: use it on the uplink")
        ref2 = wire.weight_tiles(tree.leaves(ref), spec)
        riders = []

        def tiles():
            for p in params_list:
                leaves = tree.leaves(p)
                x2, d_alpha = self._residual(leaves, ref2, spec)
                riders.append(tuple(leaves[i] for i in spec.other_slots) + (d_alpha,))
                yield x2, wire.alpha_column(d_alpha, spec)

        codes = wire.encode_many(tiles(), spec, self.inner.key(keys), self.inner.fmt)
        return [{"codes": c, "other": o} for c, o in zip(codes, riders)]

    def decode(self, payload, spec, ref=None):
        if ref is None:
            raise ValueError("DeltaCodec.decode needs ref= (see encode)")
        other_all = tuple(payload["other"])
        d_alpha, other = other_all[-1], other_all[:-1]
        return wire.assemble(payload["codes"], other, wire.alpha_column(d_alpha, spec),
                             spec, self.inner.fmt, ref=ref)

    def decode_many(self, payloads, spec, ref=None, codes=None):
        """Over an FP4 inner, the cohort's residuals in one ``unpack_sub_many``
        launch a chunk of clients, each at its own clips (its last rider);
        bitwise :meth:`decode` of each. Over an FP8 inner, one decode a
        client."""
        if not (spec.q_slots and isinstance(self.inner, PackedFpCodec)):
            return super().decode_many(payloads, spec, ref=ref)
        if ref is None:
            raise ValueError("DeltaCodec.decode needs ref= (see encode)")
        return wire.assemble_many(payloads, _last_rider_clips(spec), spec, self.inner.fmt,
                                  ref=ref, codes=codes)

    def payload_nbytes(self, spec):
        # inner codes + model riders + one fresh f32 clip scalar per leaf
        return self.inner.payload_nbytes(spec) + 4 * len(spec.q_slots)

    def code_nbytes(self, spec):
        return self.inner.code_nbytes(spec)


def _last_rider_clips(spec: wire.WireSpec):
    """``wire.assemble_many``'s ``clips`` for payloads whose last FP32 rider
    is their ``(n_q,)`` clip vector (a delta residual's clips, or delayed
    scaling's shipped scales): the other riders, and the clip columns."""
    def clips(chunk):
        riders = [tuple(pl["other"]) for pl in chunk]
        a = torch.stack([f32(r[-1]).reshape(-1) for r in riders])
        return [r[:-1] for r in riders], wire.alpha_columns(a, spec)

    return clips


# ---------------------------------------------------------------------------
# Registry + legacy-knob shim
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, WireCodec] = {}


def register_codec(name: str, codec: WireCodec) -> None:
    _REGISTRY[name.lower()] = codec


for _fmt, _base in ((E4M3, "e4m3"), (E5M2, "e5m2")):
    register_codec(_base, Fp8Codec(_fmt, "rand"))
    register_codec(_base + "_det", Fp8Codec(_fmt, "det"))
for _fmt, _base in ((FP4_E2M1, "fp4_e2m1"), (FP4_E3M0, "fp4_e3m0")):
    register_codec(_base, PackedFpCodec(_fmt, "rand"))
    register_codec(_base + "_det", PackedFpCodec(_fmt, "det"))
register_codec("fp4", _REGISTRY["fp4_e2m1"])
register_codec("fp4_det", _REGISTRY["fp4_e2m1_det"])
register_codec("fp32", Fp32Codec())
register_codec("none", Fp32Codec())
register_codec("delta", DeltaCodec(Fp8Codec(E4M3, "rand")))


def get_codec(c) -> WireCodec:
    """Resolve a codec spec: a :class:`WireCodec` passes through; a string
    looks up the registry. Prefixes compose recursively: ``delta:<inner>``,
    ``rans:<inner>`` (``core.entropy``) and ``ef:<inner>`` (``core.ef``);
    bare ``rans``/``ef`` take the ``e4m3`` inner, as bare ``delta`` does."""
    if isinstance(c, WireCodec):
        return c
    if not isinstance(c, str):
        raise TypeError(f"cannot resolve a codec from {type(c).__name__}")
    name = c.lower()
    if name.startswith("delta:"):
        return DeltaCodec(get_codec(name[len("delta:"):]))
    if name == "rans" or name.startswith("rans:"):
        from .entropy import RansCodec  # imported here: entropy builds on this module

        return RansCodec(get_codec(name[len("rans:"):] or "e4m3"))
    if name == "ef" or name.startswith("ef:"):
        from .ef import ErrorFeedbackCodec

        return ErrorFeedbackCodec(get_codec(name[len("ef:"):] or "e4m3"))
    if name in _REGISTRY:
        return _REGISTRY[name]
    raise KeyError(f"unknown codec {c!r}; registered: {sorted(_REGISTRY)} "
                   "(or composed 'delta:<name>' / 'rans:<name>' / 'ef:<name>')")


def registry_tags() -> list[str]:
    """Distinct registered codecs (one tag per object, aliases folded)."""
    seen, out = set(), []
    for codec in _REGISTRY.values():
        if codec.tag not in seen:
            seen.add(codec.tag)
            out.append(codec.tag)
    return out


def codec_for(fmt: FP8Format, mode: str) -> WireCodec:
    """The legacy ``(fmt, mode)`` pair -> codec (``mode='none'`` is FP32;
    sub-byte formats go to :class:`PackedFpCodec`)."""
    if mode == "none":
        return Fp32Codec()
    if fmt.bits == 8:
        return Fp8Codec(fmt, mode)
    return PackedFpCodec(fmt, mode)


def leg_nbytes(codec: WireCodec, spec: wire.WireSpec, policy=None) -> int:
    """Exact static bytes of one model copy on a leg using ``codec``; a tree
    with no quantized leaves rides FP32 whatever the codec says. ``policy``
    (a ``core.scaling.ScalingPolicy``) adds its payload delta: +4 B per
    quantized leaf for delayed, -4 B for frozen, 0 for current."""
    if codec.quantized and spec.q_slots:
        n = codec.payload_nbytes(spec)
        if policy is not None:
            n += policy.payload_delta(spec)
        return n
    return _fp32_nbytes(spec)
