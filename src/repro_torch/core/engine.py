"""Federated round engine, the synchronous slice of ``repro.core.engine``.

Algorithm 1 as four stage objects:

* **ClientSampler** — ``UniformSampler`` (uniform without replacement, the
  paper's P_t).
* **Link** — ``WireLink``: one ``core.codec`` codec and one
  ``core.scaling`` policy per direction. The downlink broadcast is one
  encode + one decode; the uplink encodes and decodes each client's model
  with its own key, against the decoded broadcast as the reference model
  of a delta leg. A delayed-scaling leg encodes at the scales of its amax
  history (``ServerState.scales``) and appends the amax its encode emits.
  An error-feedback uplink (``core.ef``) compensates each client's model
  with its residual row of ``ServerState.clients`` and writes the new row
  back. Each leg reports its payloads' sizes: ``wire_bytes`` is P downlink
  copies plus the sum of the uplink payloads, the static ``round_bytes``
  on a static link and a device scalar when a leg is dynamic
  (entropy-coded), whose ``round_bytes`` is then the bound.
* **ClientExecutor** — ``VmapExecutor``: every cohort client runs
  ``LocalUpdate`` (a Python loop over the cohort stands in for ``vmap``).
* **Aggregator** — ``MeanAggregator``: the n_k-weighted mean (UQ), or
  ``ServerOptAggregator``: the UQ+ server optimizer (``core.server_opt``),
  selected by ``FedConfig.server_opt``.

Randomness is injected. The reference draws with ``jax.random`` threefry
(``engine.py:1487`` splits the round key into ``k_sel, k_down, k_up, k_loc,
k_srv``), which torch cannot reproduce, so a round here takes its realized
draws as a :class:`RoundDraws`: the cohort indices, the per-client per-step
batch indices, the ``(2,)`` u32 wire key words of the downlink and of each
client's uplink, the UQ+ server's GD and grid key words, and, for
stochastic QAT, a source of each weight site's random bits.
``RoundEngine.draw`` makes them from a ``torch.Generator``; parity tests
hand in the reference's draws instead.

Not ported yet: the weighted/fixed samplers, the chunked and sharded
executors, the stateful aggregators, faults and codec schedules.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Protocol

import torch

from . import codec as codec_lib
from . import ef as ef_lib
from . import metrics, plane, wire
from . import scaling as scaling_lib
from .codec import DeltaCodec, Fp8Codec, WireCodec
from .entropy import RansCodec
from .fp8 import E4M3, FP8Format
from .qat import BitsFn, QATConfig
from .server_opt import ServerOptConfig, server_optimize, weighted_mean
from .. import tree
from ..device import resolve_device
from ..kernels import ref
from ..optim.base import Optimizer, apply_updates

LossFn = Callable[..., torch.Tensor]  # (params, x, y, qat_cfg[, bits=]) -> scalar


class ServerState(NamedTuple):
    """What the server carries between rounds: the model, the aggregator
    state, the scaling state (a ``(down, up)`` pair of amax histories,
    ``()`` unless a leg scales away from ``current``) and the per-client
    state (an ``ef.ClientState``, ``()`` unless the uplink is EF)."""

    params: dict
    opt: Any = ()
    scales: Any = ()
    clients: Any = ()


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """One federated experiment: the fields of the reference's ``FedConfig``
    that the port reads, with the same defaults. The reference's other
    fields (samplers, chunking, meshes, codec schedules, the per-leg legacy
    ``fmt``/``mode`` knobs, faults) are not accepted yet."""

    n_clients: int = 100          # K
    participation: float = 0.1    # C
    local_steps: int = 50         # U (local gradient updates per round)
    batch_size: int = 50          # B
    comm_mode: str = "rand"       # 'rand' (UQ) | 'det' (biased ablation) | 'none' (FP32)
    qat: QATConfig = QATConfig()
    fmt: FP8Format = E4M3
    # UQ+ (Eqs. 4-5). Two switches, as in the reference (this field and
    # ``ServerOptConfig.enabled``), so that parity tests build both configs
    # field for field; ``server_opt=None`` would say the same with one fewer
    server_opt: ServerOptConfig = ServerOptConfig(enabled=False)
    # wire codecs per leg (a WireCodec or a registry name: 'e4m3', 'fp4',
    # 'delta:fp4_e2m1', ...); None resolves (fmt, comm_mode) as before
    down_codec: Any = None
    up_codec: Any = None
    # scaling policies per leg ('current' | 'delayed[:H[:M]]' | 'frozen' or a
    # ScalingPolicy); None is 'current', the trained-alpha wire
    down_scaling: Any = None
    up_scaling: Any = None

    def __post_init__(self):
        if self.n_clients <= 0:
            raise ValueError(f"FedConfig.n_clients must be positive, got {self.n_clients}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("FedConfig.participation must be in (0, 1], got "
                             f"{self.participation}")
        if self.local_steps <= 0 or self.batch_size <= 0:
            raise ValueError("FedConfig.local_steps/batch_size must be positive, "
                             f"got {self.local_steps}/{self.batch_size}")
        if self.comm_mode not in ("rand", "det", "none"):
            raise ValueError(f"comm_mode {self.comm_mode!r}: 'rand', 'det' or 'none'")
        if not isinstance(self.server_opt, ServerOptConfig):
            raise TypeError("FedConfig.server_opt must be a ServerOptConfig, got "
                            f"{type(self.server_opt).__name__}")
        # eager resolution: a typo'd or unported codec or policy fails here
        for c in (self.down_codec, self.up_codec):
            if c is not None:
                codec_lib.get_codec(c)
        scaling_lib.get_policy(self.down_scaling)
        scaling_lib.get_policy(self.up_scaling)

    @property
    def clients_per_round(self) -> int:
        return max(1, int(round(self.n_clients * self.participation)))

    def _resolved_codec(self, explicit) -> WireCodec:
        if explicit is not None:
            return codec_lib.get_codec(explicit)
        return codec_lib.codec_for(self.fmt, self.comm_mode)

    @property
    def resolved_down_codec(self) -> WireCodec:
        return self._resolved_codec(self.down_codec)

    @property
    def resolved_up_codec(self) -> WireCodec:
        return self._resolved_codec(self.up_codec)

    @property
    def resolved_down_scaling(self) -> scaling_lib.ScalingPolicy:
        return scaling_lib.get_policy(self.down_scaling)

    @property
    def resolved_up_scaling(self) -> scaling_lib.ScalingPolicy:
        return scaling_lib.get_policy(self.up_scaling)

    @property
    def uses_server_opt(self) -> bool:
        """The UQ+ tail runs when enabled on a quantized link (the
        reference's ``resolved_aggregator == 'server_opt'``: ``comm_mode``
        gates it, or the downlink codec when one is named)."""
        if not self.server_opt.enabled:
            return False
        if self.down_codec is None:
            return self.comm_mode != "none"
        return self.resolved_down_codec.quantized


class QatBitsSource(Protocol):
    """Where stochastic QAT's weight-site bits come from in one round:
    ``provider(client, step)`` is the :data:`core.qat.BitsFn` handed to the
    model at that client's local step (``client`` indexes the cohort)."""

    def provider(self, client: int, step: int) -> BitsFn: ...

    def to(self, device) -> "QatBitsSource": ...


@dataclasses.dataclass(frozen=True)
class CounterQatBits:
    """The port's own site bits: the counter RNG (``kernels.ref``) over the
    element index of the weight, keyed by one ``(2,)`` u32 word pair per
    client and local step, with the site number mixed into the first word.
    A site gets its key (``ref.CounterKey``), not its bits: the B6 kernels
    draw them on the card, the twins make them on the CPU. No generator
    state."""

    keys: torch.Tensor   # (P, U, 2) uint32

    def provider(self, client: int, step: int) -> BitsFn:
        key2 = self.keys[client, step]
        return lambda site, shape: ref.CounterKey(key2, site)

    def to(self, device) -> "CounterQatBits":
        return CounterQatBits(self.keys.to(device))


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    """The realized randomness of one round (see module docstring)."""

    cohort: torch.Tensor     # (P,) int64 client indices
    batches: torch.Tensor    # (P, U, B) int64 example indices per client step
    down_key: torch.Tensor   # (2,) uint32 downlink stochastic-rounding key
    up_keys: torch.Tensor    # (P, 2) uint32 per-client uplink keys
    gd_keys: torch.Tensor | None = None     # (gd_steps, 2) uint32, UQ+ Eq. 4
    grid_keys: torch.Tensor | None = None   # (n_grid, 2) uint32, UQ+ Eq. 5
    qat_bits: QatBitsSource | None = None   # stochastic QAT's site bits

    def to(self, device) -> "RoundDraws":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            moved[f.name] = None if v is None else v.to(device)
        return RoundDraws(**moved)


def _key_words(g: torch.Generator, *shape: int) -> torch.Tensor:
    return torch.randint(0, 2 ** 32, (*shape, 2), generator=g,
                         dtype=torch.int64).to(torch.uint32)


# ---------------------------------------------------------------------------
# Local update (Algorithm 1's LocalUpdate)
# ---------------------------------------------------------------------------


def make_local_update(loss_fn: LossFn, optimizer: Optimizer, cfg: FedConfig):
    """Build ``LocalUpdate(w_t, Q_det; alpha_t, beta_t, D_k)``.

    Returned fn: ``(params0, data, labels, batches, step_bits=None) ->
    (params_U, mean_loss)`` where ``batches`` is the ``(U, B)`` example
    indices of each step, ``params0`` the dequantized downlink model and,
    for stochastic QAT, ``step_bits(i)`` the :data:`core.qat.BitsFn` of step
    ``i`` (handed to ``loss_fn`` as ``bits=``). Optimizer state is
    re-initialized every round, as is standard for FedAvg local solvers.
    """
    stochastic = cfg.qat.stochastic_weights

    def local_update(params0: dict, data, labels, batches, step_bits=None):
        if stochastic and step_bits is None:
            raise ValueError("stochastic QAT (mode='rand') needs RoundDraws.qat_bits")
        names = [n for n, _ in tree.flatten(params0)]
        params, opt_state = params0, optimizer.init(params0)
        losses = []
        for i in range(batches.shape[0]):
            idx = batches[i]
            leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
            kw = {"bits": step_bits(i)} if stochastic else {}
            loss = loss_fn(tree.unflatten(names, leaves), data[idx], labels[idx],
                           cfg.qat, **kw)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [torch.zeros_like(p) if gr is None else gr
                     for p, gr in zip(leaves, grads)]
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    tree.unflatten(names, grads), opt_state, params, i)
                params = apply_updates(params, updates)
            losses.append(loss.detach())
        return params, torch.stack(losses).mean()

    return local_update


# ---------------------------------------------------------------------------
# Stages
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UniformSampler:
    """Uniform without replacement (the paper's P_t)."""

    n_clients: int
    cohort: int

    def __call__(self, nk: torch.Tensor, g: torch.Generator) -> torch.Tensor:
        return torch.randperm(self.n_clients, generator=g)[: self.cohort]


def _codec_transit(codec: WireCodec, params: dict, spec: wire.WireSpec,
                   key2: torch.Tensor, ref: dict | None = None):
    """One leg through ``codec``: ``(received_tree, nbytes)``, what a receiver
    of the payload observes and the payload's size (a device scalar when the
    codec is ``dynamic``, else the static Python int)."""
    if not (codec.quantized and spec.q_slots):
        return params, codec_lib.leg_nbytes(codec, spec)
    payload = codec.encode(params, spec, key2, ref=ref)
    return (codec.decode(payload, spec, ref=ref),
            codec.payload_nbytes_traced(payload, spec))


def _drain(client_params: list[dict], step: int | None = None):
    """Hand out the cohort's trained models front to back, ``step`` at a time
    as lists (one at a time, unlisted, when None), removing them from the
    list. Every uplink of :class:`WireLink` consumes its ``client_params``
    this way: the list is empty when it returns, and on the uplinks that
    carry a chunk of clients at a time each chunk's models are freed once
    their payloads are decoded, so at most a chunk of model copies more than
    the messages is alive (4.4 GB a copy at TinyLlama's full width, where a
    chunk is one client: ``plane.stack_chunk``)."""
    while client_params:
        if step is None:
            yield client_params.pop(0)
        else:
            chunk = client_params[:step]
            del client_params[:step]
            yield chunk


@dataclasses.dataclass(frozen=True)
class WireLink:
    """Both legs of the model exchange, each a ``WireCodec`` (an instance or a
    registry name) with a ``ScalingPolicy`` (an instance or a spec string;
    None is ``'current'``).

    A non-current policy needs a grid codec (``Fp8Codec``/``PackedFpCodec``)
    on its leg; ``'frozen'`` is downlink-only. Neither ``DeltaCodec`` nor
    ``ErrorFeedbackCodec`` runs on the downlink: a client joining the round
    holds no reference model and no memory of earlier broadcasts.
    """

    down_codec: Any = codec_lib.Fp8Codec()
    up_codec: Any = codec_lib.Fp8Codec()
    down_scaling: Any = None
    up_scaling: Any = None

    def __post_init__(self):
        down, up = codec_lib.get_codec(self.down_codec), codec_lib.get_codec(self.up_codec)
        if isinstance(down, DeltaCodec):
            raise ValueError("DeltaCodec cannot run on the downlink: the receiver (a "
                             "client joining the round) holds no reference model. Use "
                             "it on the uplink, where the reference is the broadcast.")
        if isinstance(down, ef_lib.ErrorFeedbackCodec):
            raise ValueError("ErrorFeedbackCodec cannot run on the downlink: the receivers "
                             "are freshly sampled clients holding no memory of earlier "
                             "broadcasts, so there is no residual to feed back. Use it on "
                             "the uplink, where the engine threads per-client residual "
                             "state (ServerState.clients).")
        down_p = scaling_lib.get_policy(self.down_scaling)
        up_p = scaling_lib.get_policy(self.up_scaling)
        for leg, pol, c in (("down", down_p, down), ("up", up_p, up)):
            if not pol.is_current and not isinstance(c, Fp8Codec):
                raise ValueError(
                    f"{leg}_scaling={pol.name!r} needs a plain FP8-family {leg}link "
                    f"codec (Fp8Codec/PackedFpCodec), got {type(c).__name__}")
        if isinstance(up_p, scaling_lib.PerRoundFrozenScaling):
            raise ValueError("up_scaling='frozen' is unsupported: the server holds no "
                             "earlier copy of a client's model whose scales it could "
                             "reuse; use 'delayed' on the uplink")
        object.__setattr__(self, "down_c", down)
        object.__setattr__(self, "up_c", up)
        object.__setattr__(self, "down_p", down_p)
        object.__setattr__(self, "up_p", up_p)

    @property
    def scaled(self) -> bool:
        """True when any leg scales away from ``current``."""
        return not (self.down_p.is_current and self.up_p.is_current)

    @property
    def up_is_ef(self) -> bool:
        """The uplink is error feedback: the round threads per-client state."""
        return isinstance(self.up_c, ef_lib.ErrorFeedbackCodec)

    @property
    def dynamic(self) -> bool:
        """A leg's coded size depends on the data (a ``RansCodec``, maybe under
        EF): ``wire_bytes`` is then the payloads' true coded size."""
        return self.down_c.dynamic or self.up_c.dynamic

    def scales_init(self, params: dict, spec: wire.WireSpec | None = None):
        """Initial ``ServerState.scales``: a ``(down, up)`` state pair seeded
        from the model's trained clip alphas (``()`` per stateless leg)."""
        if not self.scaled:
            return ()
        spec = spec or wire.make_wire_spec(params)
        a0 = scaling_lib.leaf_alphas(params, spec)
        return self.down_p.init_state(a0), self.up_p.init_state(a0)

    def down(self, params: dict, spec: wire.WireSpec, key2: torch.Tensor):
        """Server -> cohort broadcast, one encode and one decode:
        ``(received_tree, nbytes)`` of the one copy."""
        return _codec_transit(self.down_c, params, spec, key2)

    def up(self, client_params: list[dict], spec: wire.WireSpec,
           keys: torch.Tensor, ref: dict | None = None):
        """Cohort -> server, one independent payload per client: ``(msgs,
        per_client_nbytes)``; ``ref`` is the round's reference model (the
        decoded broadcast). Consumes ``client_params`` (see :func:`_drain`).
        The cohort is encoded and decoded a chunk of clients at a time
        (``plane.stack_chunk``: the whole cohort of a small model, one
        client of an LM), an FP4 codec's chunk in one launch each way
        (:meth:`~repro_torch.core.codec.WireCodec.encode_many`,
        :meth:`~repro_torch.core.codec.WireCodec.decode_many`). An
        entropy-coded uplink inner-encodes the cohort so, then range-codes
        its code streams in one launch each way and inner-decodes them
        (:meth:`~repro_torch.core.entropy.RansCodec.cohort_transit`)."""
        c = self.up_c
        if not (c.quantized and spec.q_slots):
            msgs = list(_drain(client_params))
            return msgs, [codec_lib.leg_nbytes(c, spec)] * len(msgs)
        if isinstance(c, RansCodec):
            inner = c.inner.encode_many(list(_drain(client_params)), spec, keys, ref=ref)
            msgs, payloads = c.cohort_transit(inner, spec, ref=ref)
            return msgs, [c.payload_nbytes_traced(pl, spec) for pl in payloads]
        msgs, nbytes = [], []
        for chunk in _drain(client_params, plane.stack_chunk(spec.n_rows)):
            ks = keys[len(msgs):len(msgs) + len(chunk)]
            payloads = c.encode_many(chunk, spec, ks, ref=ref)
            msgs += c.decode_many(payloads, spec, ref=ref)
            nbytes += [c.payload_nbytes_traced(pl, spec) for pl in payloads]
        return msgs, nbytes

    def up_ef(self, client_params: list[dict], spec: wire.WireSpec,
              keys: torch.Tensor, e_sel: torch.Tensor):
        """Error-feedback uplink: ``(msgs, new_e, per_client_nbytes)``;
        ``e_sel`` is the cohort's gathered ``(P, spec.total)`` residual rows
        and ``new_e`` the rows to scatter back. Consumes ``client_params``
        (see :func:`_drain`)."""
        c = self.up_c
        P = len(client_params)
        if not (c.quantized and spec.q_slots):
            return list(_drain(client_params)), e_sel, [codec_lib.leg_nbytes(c, spec)] * P
        msgs, new_e, payloads = c.up_transit(list(_drain(client_params)), spec, keys, e_sel)
        return msgs, new_e, [c.payload_nbytes_traced(pl, spec) for pl in payloads]

    def leg_bytes(self, spec: wire.WireSpec) -> tuple[int, int]:
        """Static bytes of one model copy on each leg, ``(down, up)``."""
        return (codec_lib.leg_nbytes(self.down_c, spec, policy=self.down_p),
                codec_lib.leg_nbytes(self.up_c, spec, policy=self.up_p))

    def down_scaled(self, params: dict, spec: wire.WireSpec, key2: torch.Tensor, st):
        """Scaled broadcast: ``(received_tree, new_state)``. A delayed leg
        encodes at its history's effective scales and appends the per-leaf
        amax its encode launch emitted; a frozen leg encodes at the trained
        alphas, ships no alpha riders, and the receiver splices its own back."""
        c, pol = self.down_c, self.down_p
        if not spec.q_slots:
            return params, st
        if isinstance(pol, scaling_lib.PerRoundFrozenScaling):
            scaling_lib.require_column_alphas(spec, pol)
            alphas = scaling_lib.leaf_alphas(params, spec)
            payload = c.encode_scaled(params, spec, key2, alphas, drop_alphas=True)
            return c.decode_scaled(payload, spec, alphas=alphas, dropped=True), st
        payloads, amax = c.encode_scaled_many([params], spec,
                                              None if key2 is None else key2[None],
                                              pol.effective(st))
        return c.decode_scaled(payloads[0], spec), pol.update(st, amax[0])

    def up_scaled(self, client_params: list[dict], spec: wire.WireSpec,
                  keys: torch.Tensor, st):
        """Scaled uplink: ``(msgs, up_amax)``. Every client encodes at the
        same effective scales (the server's history); ``up_amax`` is the
        ``(cohort, n_q)`` per-client amax for the caller's history update.
        A chunk of clients (``plane.stack_chunk``) is one amax encode launch
        (:meth:`~repro_torch.core.codec.Fp8Codec.encode_scaled_many`), and on
        an FP4 leg one decode launch. Consumes ``client_params`` (see
        :func:`_drain`)."""
        c, pol = self.up_c, self.up_p
        if not spec.q_slots:
            P = len(client_params)
            return list(_drain(client_params)), st.new_zeros((P, 0))
        a_eff = pol.effective(st)
        msgs, amax = [], []
        for chunk in _drain(client_params, plane.stack_chunk(spec.n_rows)):
            ks = keys[len(msgs):len(msgs) + len(chunk)]
            payloads, am = c.encode_scaled_many(chunk, spec, ks, a_eff)
            msgs += c.decode_scaled_many(payloads, spec)
            amax.append(am)
        return msgs, torch.cat(amax)


class VmapExecutor:
    """Full-cohort LocalUpdate: each client trains from the broadcast."""

    def __call__(self, local_update, down: dict, data, labels, batches,
                 qat_bits: QatBitsSource | None = None):
        outs = [local_update(down, d, lab, b,
                             None if qat_bits is None
                             else functools.partial(qat_bits.provider, c))
                for c, (d, lab, b) in enumerate(zip(data, labels, batches))]
        return [p for p, _ in outs], torch.stack([l for _, l in outs])


@dataclasses.dataclass(frozen=True)
class MeanAggregator:
    """Plain federated average with weights n_k / m_t (Algorithm 1's tail)."""

    def init(self, params: dict):
        return ()

    def __call__(self, server_params, msgs: list[dict], nk, draws, opt_state):
        # stacked one leaf at a time, not the whole cohort at once (the same
        # arithmetic): a full-width LM cannot hold a second cohort copy
        return tree.tree_map(lambda *xs: weighted_mean(torch.stack(xs), nk), *msgs), ()


@dataclasses.dataclass(frozen=True)
class ServerOptAggregator:
    """UQ+ ``server_optimize`` (paper Eqs. 4-5): minimize the quantized-domain
    MSE to the client models by alternating STE-SGD on w and per-segment
    grid search on alpha, with the round's ``gd_keys``/``grid_keys``.
    Stateless: the alternation restarts each round."""

    cfg: ServerOptConfig

    def init(self, params: dict):
        return ()

    def __call__(self, server_params, msgs: list[dict], nk, draws, opt_state):
        if draws.gd_keys is None or draws.grid_keys is None:
            raise ValueError("UQ+ needs RoundDraws.gd_keys and grid_keys")
        return server_optimize(_stack(msgs), nk, draws.gd_keys, draws.grid_keys,
                               self.cfg), ()


def _stack(msgs: list[dict]) -> dict:
    return tree.tree_map(lambda *xs: torch.stack(xs), *msgs)


class RoundEngine:
    """One communication round, composed from the four stages (built from
    ``cfg``; the reference's per-stage overrides come with the stages that
    would use them).

    ``round_fn(state, data, labels, nk, draws) -> (state, metrics)`` where
    ``data``/``labels`` are the ``(K, n_per, ...)`` client stacks on
    ``device`` and ``draws`` a :class:`RoundDraws`.
    """

    def __init__(self, loss_fn: LossFn, optimizer: Optimizer, cfg: FedConfig, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cohort = cfg.clients_per_round
        self.sampler = UniformSampler(cfg.n_clients, self.cohort)
        self.link = WireLink(cfg.resolved_down_codec, cfg.resolved_up_codec,
                             cfg.resolved_down_scaling, cfg.resolved_up_scaling)
        self.executor = VmapExecutor()
        self.aggregator = (ServerOptAggregator(cfg.server_opt) if cfg.uses_server_opt
                           else MeanAggregator())
        self._local_update = make_local_update(loss_fn, optimizer, cfg)

    @property
    def dynamic(self) -> bool:
        """True when a leg's coded size depends on the data: each round's
        ``wire_bytes`` is then measured, and ``round_bytes`` is its bound."""
        return self.link.dynamic

    def init(self, params: dict) -> ServerState:
        clients = ()
        if self.link.up_is_ef:
            spec = wire.make_wire_spec(params)
            clients = ef_lib.init_client_state(self.cfg.n_clients, spec,
                                               device=tree.leaves(params)[0].device)
        return ServerState(params=params, opt=self.aggregator.init(params),
                           scales=self.link.scales_init(params), clients=clients)

    def round_bytes(self, params: dict) -> int:
        """Static per-round wire bytes: P x (down leg + up leg)."""
        return metrics.round_bytes_for(params, self.cfg)

    def draw(self, g: torch.Generator, nk: torch.Tensor, n_per: int) -> RoundDraws:
        """This round's randomness from ``g`` (on the host)."""
        cfg, P = self.cfg, self.cohort
        d = RoundDraws(
            cohort=self.sampler(nk, g).to(torch.int64),
            batches=torch.randint(0, n_per, (P, cfg.local_steps, cfg.batch_size),
                                  generator=g),
            down_key=_key_words(g),
            up_keys=_key_words(g, P),
        )
        # drawn after the uq draws, so a uq round's draws stay as they were
        if cfg.uses_server_opt:
            d = dataclasses.replace(d, gd_keys=_key_words(g, cfg.server_opt.gd_steps),
                                    grid_keys=_key_words(g, cfg.server_opt.n_grid))
        if cfg.qat.stochastic_weights:
            d = dataclasses.replace(
                d, qat_bits=CounterQatBits(_key_words(g, P, cfg.local_steps)))
        return d

    def round_fn(self, state: ServerState, data, labels, nk, draws: RoundDraws):
        d = draws.to(self.device)
        link = self.link
        server_params = state.params
        spec = wire.make_wire_spec(server_params)
        idx = d.cohort
        st_down, st_up = state.scales if link.scaled else ((), ())
        # --- stage 2a: downlink ------------------------------------------
        down_b, up_b = link.leg_bytes(spec)     # a scaled leg's sizes are static
        if link.down_p.is_current:
            down, down_b = link.down(server_params, spec, d.down_key)
        else:
            down, st_down = link.down_scaled(server_params, spec, d.down_key, st_down)
        # --- stage 3: local QAT training over the cohort -----------------
        client_params, losses = self.executor(
            self._local_update, down, data[idx], labels[idx], d.batches, d.qat_bits)
        P = len(client_params)       # the uplink empties the list (``_drain``)
        # --- stage 2b: uplink --------------------------------------------
        # the decoded broadcast is the round's reference model: every client
        # trained from it, so a delta uplink codes the residual against it
        clients = state.clients
        if link.up_is_ef:
            # gather the cohort's residual rows, compensate-encode-update,
            # scatter the new rows back (client-side memory)
            msgs, new_e, up_bs = link.up_ef(client_params, spec, d.up_keys,
                                            clients.resid[idx])
            clients = clients._replace(resid=clients.resid.index_copy(0, idx, new_e))
        elif link.up_p.is_current:
            msgs, up_bs = link.up(client_params, spec, d.up_keys, ref=down)
        else:
            msgs, up_amax = link.up_scaled(client_params, spec, d.up_keys, st_up)
            # next round's uplink scales come from what the server received
            st_up = link.up_p.update(st_up, torch.amax(up_amax, dim=0))
            up_bs = [up_b] * P
        # --- stage 4: server aggregation ---------------------------------
        new_params, new_opt = self.aggregator(server_params, msgs, nk[idx], d,
                                              state.opt)
        # P downlink copies + each uplink payload: a Python int on a static
        # link (the static round bytes), a device scalar on a dynamic one
        wire_bytes = P * down_b + sum(up_bs)
        metrics = {"local_loss": torch.mean(losses), "wire_bytes": wire_bytes}
        return ServerState(new_params, new_opt, (st_down, st_up) if link.scaled else (),
                           clients), metrics
