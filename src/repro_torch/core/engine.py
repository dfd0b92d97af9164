"""Federated round engine, the synchronous slice of ``repro.core.engine``.

Algorithm 1 as four stage objects:

* **ClientSampler** — ``UniformSampler`` (uniform without replacement, the
  paper's P_t).
* **Link** — ``WireLink``: one ``core.codec`` codec per direction. The
  downlink broadcast is one encode + one decode; the uplink encodes and
  decodes each client's model with its own key.
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
executors, the stateful aggregators, faults, codec schedules, scaling
policies and error feedback.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Protocol

import torch

from . import codec as codec_lib
from . import metrics, wire
from .codec import WireCodec
from .fp8 import E4M3, FP8Format
from .plane import nelem
from .qat import BitsFn, QATConfig
from .server_opt import ServerOptConfig, server_optimize, weighted_mean
from .. import tree
from ..device import resolve_device
from ..kernels import ref
from ..optim.base import Optimizer, apply_updates

LossFn = Callable[..., torch.Tensor]  # (params, x, y, qat_cfg[, bits=]) -> scalar


class ServerState(NamedTuple):
    """What the server carries between rounds: the model + aggregator state."""

    params: dict
    opt: Any = ()


@dataclasses.dataclass(frozen=True)
class FedConfig:
    """One federated experiment: the fields of the reference's ``FedConfig``
    that the port reads, with the same defaults. The reference's other
    fields (samplers, chunking, meshes, codecs, scaling, faults) are not
    accepted yet."""

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

    @property
    def clients_per_round(self) -> int:
        return max(1, int(round(self.n_clients * self.participation)))

    @property
    def resolved_down_codec(self) -> WireCodec:
        return codec_lib.codec_for(self.fmt, self.comm_mode)

    @property
    def resolved_up_codec(self) -> WireCodec:
        return codec_lib.codec_for(self.fmt, self.comm_mode)

    @property
    def uses_server_opt(self) -> bool:
        """The UQ+ tail runs when enabled on a quantized link (the
        reference's ``resolved_aggregator == 'server_opt'``)."""
        return self.server_opt.enabled and self.comm_mode != "none"


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
    Made on the tensor's device; no generator state."""

    keys: torch.Tensor   # (P, U, 2) uint32

    def provider(self, client: int, step: int) -> BitsFn:
        k = self.keys[client, step].to(torch.int64)

        def bits(site: int, shape: tuple) -> torch.Tensor:
            idx = torch.arange(nelem(tuple(shape)), dtype=torch.int64, device=k.device)
            k0 = k[0] ^ ((site * 0x9E3779B9) & 0xFFFFFFFF)
            return _as_u32(ref.counter_bits(idx, k0, k[1])).reshape(shape)

        return bits

    def to(self, device) -> "CounterQatBits":
        return CounterQatBits(self.keys.to(device))


def _as_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 holding values in [0, 2^32) -> the same bits as uint32 (through
    int32 and a same-width view, which every device supports)."""
    return t.to(torch.int32).view(torch.uint32)


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
                   key2: torch.Tensor) -> dict:
    """One leg through ``codec``: what a receiver of the payload observes."""
    if not (codec.quantized and spec.q_slots):
        return params
    return codec.decode(codec.encode(params, spec, key2), spec)


@dataclasses.dataclass(frozen=True)
class WireLink:
    """Both legs of the model exchange, each a ``WireCodec``."""

    down_codec: WireCodec = codec_lib.Fp8Codec()
    up_codec: WireCodec = codec_lib.Fp8Codec()

    def down(self, params: dict, spec: wire.WireSpec, key2: torch.Tensor) -> dict:
        """Server -> cohort broadcast: one encode, one decode."""
        return _codec_transit(self.down_codec, params, spec, key2)

    def up(self, client_params: list[dict], spec: wire.WireSpec,
           keys: torch.Tensor) -> list[dict]:
        """Cohort -> server: one independent payload per client."""
        return [_codec_transit(self.up_codec, p, spec, k)
                for p, k in zip(client_params, keys)]


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
        return weighted_mean(_stack(msgs), nk), ()


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
        self.link = WireLink(cfg.resolved_down_codec, cfg.resolved_up_codec)
        self.executor = VmapExecutor()
        self.aggregator = (ServerOptAggregator(cfg.server_opt) if cfg.uses_server_opt
                           else MeanAggregator())
        self._local_update = make_local_update(loss_fn, optimizer, cfg)

    def init(self, params: dict) -> ServerState:
        return ServerState(params=params, opt=self.aggregator.init(params))

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
        server_params = state.params
        spec = wire.make_wire_spec(server_params)
        idx = d.cohort
        # --- stage 2a: downlink ------------------------------------------
        down = self.link.down(server_params, spec, d.down_key)
        # --- stage 3: local QAT training over the cohort -----------------
        client_params, losses = self.executor(
            self._local_update, down, data[idx], labels[idx], d.batches, d.qat_bits)
        # --- stage 2b: uplink --------------------------------------------
        msgs = self.link.up(client_params, spec, d.up_keys)
        # --- stage 4: server aggregation ---------------------------------
        new_params, new_opt = self.aggregator(server_params, msgs, nk[idx], d,
                                              state.opt)
        metrics = {
            "local_loss": torch.mean(losses),
            "wire_bytes": self.round_bytes(server_params),
        }
        return ServerState(new_params, new_opt), metrics
