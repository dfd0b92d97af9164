"""Scaling policies: how a wire leg derives its per-leaf clip scales each
round, the port of ``repro.core.scaling``.

* :class:`CurrentScaling` (``"current"``, the default) — the trained
  per-leaf clip alphas riding in the tree; the no-policy wire, bit for bit.
* :class:`DelayedScaling` (``"delayed[:H[:M]]"``) — scales from a rolling
  ``(H, n_q)`` amax history carried in ``engine.ServerState.scales``,
  seeded from the trained alphas; the effective scale is
  ``2^M * max(history)``. Each round's history row is the per-leaf raw amax
  that the encode launch itself emits (``kernels.fp8_quant.
  quant_pack_amax_tiles`` / ``quant_pack_sub_amax_tiles``). The effective
  scales ride the payload as one FP32 scalar per quantized leaf (+4 B each).
* :class:`PerRoundFrozenScaling` (``"frozen"``, downlink only) — the
  receiver derives the scales from the broadcast model's own trained
  alphas, so the alpha riders drop off the payload (-4 B per quantized
  leaf) and the decoded tree is bitwise that of ``current``.

Policies are frozen dataclasses; :func:`get_policy` resolves spec strings.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import fp8
from .plane import f32
from .. import tree


class ScalingPolicy:
    """Base policy: how a wire leg derives its per-leaf FP8 scales."""

    name: str = "base"
    is_current: bool = False   # legs with a current policy take the plain path
    stateful: bool = False     # threads an amax history across rounds

    def payload_delta(self, spec) -> int:
        """Extra payload bytes per model copy against the ``current`` layout."""
        return 0

    def init_state(self, alphas0: torch.Tensor):
        """Initial per-leg state from the model's trained alphas."""
        return ()


@dataclasses.dataclass(frozen=True)
class CurrentScaling(ScalingPolicy):
    """Fresh trained-alpha scaling, the bit-identical default."""

    name: str = "current"
    is_current: bool = True


@dataclasses.dataclass(frozen=True)
class DelayedScaling(ScalingPolicy):
    """Delayed scaling from a rolling per-leaf amax history of ``history_len``
    rounds; the effective clip is ``2**margin * max(history)``, floored."""

    history_len: int = 16
    margin: int = 0
    name: str = "delayed"
    stateful: bool = True

    def __post_init__(self):
        if self.history_len < 1:
            raise ValueError("delayed scaling needs history_len >= 1")

    def payload_delta(self, spec) -> int:
        # the receiver holds no history: one FP32 scale per quantized leaf
        return 4 * len(spec.q_slots)

    def init_state(self, alphas0: torch.Tensor) -> torch.Tensor:
        a0 = f32(alphas0).reshape(-1)
        return a0.reshape(1, -1).repeat(self.history_len, 1)

    def effective(self, hist: torch.Tensor) -> torch.Tensor:
        """Effective per-leaf clip alphas ``(n_q,)`` from the history."""
        # 2**margin is an exact power-of-two multiply: mantissas untouched
        a = float(2.0 ** self.margin) * torch.amax(hist, dim=0)
        return torch.clamp(a, min=fp8._ALPHA_FLOOR)

    def update(self, hist: torch.Tensor, amax: torch.Tensor) -> torch.Tensor:
        """Rotate the window: drop the oldest row, append this round's."""
        return torch.cat([hist[1:], f32(amax).reshape(1, -1)], dim=0)


@dataclasses.dataclass(frozen=True)
class PerRoundFrozenScaling(ScalingPolicy):
    """Downlink reuse of the scales the receiver already holds: the
    broadcast model's own trained alphas. Stateless; downlink only."""

    name: str = "frozen"

    def payload_delta(self, spec) -> int:
        # the alpha riders drop off the payload
        return -4 * len(spec.q_slots)


CURRENT = CurrentScaling()


def leaf_alphas(params: dict, spec) -> torch.Tensor:
    """Trained per-quantized-leaf clip alphas of ``params`` as an ``(n_q,)``:
    the raw scalar of each ``_qa`` leaf (a stacked clip reduces to its max).
    Not floored: the floor is applied where the clip column is built, as on
    the no-policy wire, so the frozen splice-back stays bitwise."""
    flat = tree.leaves(params)
    vals = [torch.amax(f32(flat[spec.other_slots[ai]])) for ai in spec.alpha_pos]
    if not vals:
        return torch.zeros(0, dtype=torch.float32)
    return torch.stack(vals)


def require_column_alphas(spec, policy: ScalingPolicy) -> None:
    """Non-current policies need one scalar clip per quantized leaf."""
    if not spec.alpha_cols_ok:
        raise ValueError(
            f"scaling policy '{policy.name}' requires scalar per-leaf clip "
            "alphas (spec.alpha_cols_ok); per-channel clips are unsupported")


def get_policy(p: Any) -> ScalingPolicy:
    """Resolve a policy spec: None/'' -> current, a name ('current',
    'frozen'/'per_round_frozen', 'delayed', 'delayed:H', 'delayed:H:M') or
    a :class:`ScalingPolicy` instance."""
    if p is None or p == "":
        return CURRENT
    if isinstance(p, ScalingPolicy):
        return p
    if not isinstance(p, str):
        raise TypeError(f"scaling policy must be str or ScalingPolicy, got {type(p)}")
    s = p.strip().lower()
    if s == "current":
        return CURRENT
    if s in ("frozen", "per_round_frozen"):
        return PerRoundFrozenScaling()
    if s == "delayed":
        return DelayedScaling()
    if s.startswith("delayed:"):
        parts = s.split(":")[1:]
        if len(parts) == 1:
            return DelayedScaling(history_len=int(parts[0]))
        if len(parts) == 2:
            return DelayedScaling(history_len=int(parts[0]), margin=int(parts[1]))
        raise ValueError(f"bad delayed scaling spec: {p!r}")
    raise ValueError(f"unknown scaling policy {p!r} (want current | delayed[:H[:M]] "
                     "| frozen)")
