"""Server-side aggregation: the weighted mean and the paper's UQ+ server
optimizer (Eqs. 4-5), the port of ``repro.core.server_opt``.

Once the server model is re-quantized for the next downlink, FedAvg's
average is no longer the best server model; UQ+ instead minimizes

    sum_k (n_k / m_t) || Q_rand(w; alpha) - Q_rand(w_k; alpha_k) ||_2^2

by alternating minimization:

1. ``w``:     ``gd_steps`` SGD steps through the STE gradient of Q_rand,
              holding ``alpha`` at the federated average (Eq. 4);
2. ``alpha``: per-segment grid search over ``n_grid`` points spanning
              [min_k alpha_k, max_k alpha_k] (Eq. 5).

Inputs are *stacked* client messages: every leaf has a leading client axis
``(P, ...)``. The alternation runs on the tiled parameter plane
(``core.plane``): each GD step is one ``fake_quant_tiles`` launch through the
differentiable ``kernels.dispatch.fake_quant_plane``, the grid points one
forward launch together (``fake_quant_many``: the plane at every point's clip
column, in chunks of ``plane.stack_chunk`` points), and Eq. 5's argmin is
taken per alpha segment through a segment sum (``index_add_``) of each
point's per-row MSE.

Stochastic rounding draws from the counter RNG. Where the reference derives
the key words from a ``jax.random`` key (``_key_words``: a split into
``k_gd, k_grid``, then ``n`` pairs each), the port takes them explicitly as
``gd_keys (gd_steps, 2)`` and ``grid_keys (n_grid, 2)`` u32, as the wire does.
:func:`server_optimize_reference` is the per-segment loop over the kernels'
plain twin with the same bits, kept as the parity oracle.
"""
from __future__ import annotations

import dataclasses

import torch

from . import fp8, plane
from .fp8 import E4M3, FP8Format
from .. import tree
from ..kernels import dispatch, ref
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class ServerOptConfig:
    enabled: bool = True
    gd_steps: int = 5      # paper: 5
    lr: float = 0.1        # paper: grid-searched over {0.01, 0.1, 1}
    n_grid: int = 50       # paper: 50
    fmt: FP8Format = E4M3


def weighted_mean(stacked: dict, nk: torch.Tensor) -> dict:
    """Federated average over the leading client axis with weights n_k/m."""
    w = nk / torch.sum(nk)

    def avg(leaf):
        wshape = (leaf.shape[0],) + (1,) * (leaf.dim() - 1)
        return torch.sum(leaf * w.reshape(wshape), dim=0)

    return tree_map(avg, stacked)


def grid_points(n: int, device=None) -> torch.Tensor:
    """The ``n`` grid positions in [0, 1] of Eq. (5): ``jnp.linspace(0, 1, n)``
    as the reference evaluates it (``i * (1 / (n - 1))`` in f32, the last
    point exactly 1), so the chosen clip values match to the bit."""
    if n == 1:
        return torch.zeros(1, device=device)
    inv = torch.tensor(1.0, dtype=torch.float32) / (n - 1)
    ts = torch.arange(n, dtype=torch.float32) * inv
    ts[-1] = 1.0
    return ts.to(device)


def _lerp(lo: torch.Tensor, t: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """``lo + t * (hi - lo)`` in f32, the product and sum rounded once as the
    reference's compiled multiply-add rounds them (exact product in f64)."""
    d = (hi - lo).to(torch.float64)
    return (lo.to(torch.float64) + t.to(torch.float64) * d).to(torch.float32)


def _plane_views(stacked: dict, avg: dict, spec: plane.PlaneSpec):
    """``(w2 (R, LANE), abar (S,), t2 (P, R, LANE), ak (P, S))``; zero padding
    is self-cancelling in every MSE below (both sides quantize to 0)."""
    w2, abar = plane.pack_tiles(avg, spec)
    n_clients = tree.leaves(stacked)[0].shape[0]
    views = [plane.pack_tiles(tree_map(lambda l, k=k: l[k], stacked), spec)
             for k in range(n_clients)]
    return w2, abar, torch.stack([v[0] for v in views]), torch.stack([v[1] for v in views])


def _reassemble(avg: dict, spec: plane.PlaneSpec, w2_new: torch.Tensor,
                a_new: torch.Tensor) -> dict:
    """New plane weights + per-segment alphas -> full server tree."""
    leaves = tree.leaves(avg)
    for qi, slot in enumerate(spec.q_slots):
        leaves[slot] = plane.leaf_from_tiles(w2_new, spec, qi)
    for qi, aslot in enumerate(spec.alpha_slots):
        s0, n = spec.leaf_seg0[qi], spec.leaf_segs[qi]
        leaves[aslot] = a_new[s0:s0 + n].reshape(spec.alpha_shapes[qi])
    return tree.unflatten(list(spec.names), leaves)


def _check_keys(gd_keys: torch.Tensor, grid_keys: torch.Tensor,
                cfg: ServerOptConfig) -> None:
    if tuple(gd_keys.shape) != (cfg.gd_steps, 2) or tuple(grid_keys.shape) != (cfg.n_grid, 2):
        raise ValueError(f"key words must be ({cfg.gd_steps}, 2) and ({cfg.n_grid}, 2), "
                         f"got {tuple(gd_keys.shape)} and {tuple(grid_keys.shape)}")


def server_optimize(stacked: dict, nk: torch.Tensor, gd_keys: torch.Tensor,
                    grid_keys: torch.Tensor, cfg: ServerOptConfig) -> dict:
    """Full UQ+ aggregation; returns the new server parameter tree.

    Non-quantized leaves (biases, norms, betas) take the plain federated
    average, Algorithm 1's fallback for those parameters.
    """
    avg = weighted_mean(stacked, nk)
    if not cfg.enabled:
        return avg
    spec = plane.make_plane_spec(avg)
    if not spec.q_slots:
        return avg
    _check_keys(gd_keys, grid_keys, cfg)
    nw_b = (nk / torch.sum(nk))[:, None, None]
    w2, abar, t2, ak = _plane_views(stacked, avg, spec)
    seg_ids = spec.row_seg_ids(w2.device)
    abar_col = plane.alpha_column(abar, spec, seg_ids)

    # --- Eq. (4): gd_steps STE-SGD steps, one fused launch per step -------
    for step in range(cfg.gd_steps):
        w = w2.detach().requires_grad_()
        with torch.enable_grad():
            err = dispatch.fake_quant_plane(w, abar_col, gd_keys[step], cfg.fmt)[None] - t2
            (g,) = torch.autograd.grad(torch.sum(nw_b * err * err), w)
        w2 = w2 - cfg.lr * g

    # --- Eq. (5): per-segment grid search, one launch for the grid points -
    lo, hi = torch.min(ak, dim=0).values, torch.max(ak, dim=0).values
    ts = grid_points(cfg.n_grid, w2.device)
    a_all = torch.clamp(_lerp(lo, ts[:, None], hi), min=fp8._ALPHA_FLOOR)   # (G, S)
    losses = []
    step = plane.stack_chunk(spec.n_rows)
    for g0 in range(0, cfg.n_grid, step):
        q_all = dispatch.fake_quant_many(w2, a_all[g0:g0 + step][:, seg_ids, None],
                                         grid_keys[g0:g0 + step], cfg.fmt)
        for q2 in q_all:
            err2 = torch.sum(nw_b * (q2[None] - t2) ** 2, dim=0)      # (R, LANE)
            losses.append(torch.zeros(spec.n_seg, device=w2.device)
                          .index_add_(0, seg_ids, torch.sum(err2, dim=1)))
    t_best = ts[torch.argmin(torch.stack(losses), dim=0)]             # (S,)
    return _reassemble(avg, spec, w2, _lerp(lo, t_best, hi))


def server_optimize_reference(stacked: dict, nk: torch.Tensor, gd_keys: torch.Tensor,
                              grid_keys: torch.Tensor, cfg: ServerOptConfig) -> dict:
    """Eq. (4)-(5) as a per-segment loop over the kernels' plain twin, with
    the bits the fused launches draw for each segment (``row0`` offset of
    the counter); numerically :func:`server_optimize`'s parity oracle."""
    avg = weighted_mean(stacked, nk)
    if not cfg.enabled:
        return avg
    spec = plane.make_plane_spec(avg)
    if not spec.q_slots:
        return avg
    _check_keys(gd_keys, grid_keys, cfg)
    nw_b = (nk / torch.sum(nk))[:, None, None]
    w2, abar, t2, ak = _plane_views(stacked, avg, spec)
    ts = grid_points(cfg.n_grid, w2.device)

    w_rows, a_segs = [], []
    for si in range(spec.n_seg):
        r0, rows = spec.seg_row0[si], spec.seg_rows[si]
        w_seg, t_seg, a_seg = w2[r0:r0 + rows], t2[:, r0:r0 + rows], abar[si]

        def bits(key2):
            return ref.tile_counter_bits((rows, plane.LANE), key2, row0=r0)

        for step in range(cfg.gd_steps):
            q = ref.fake_quant_bits(w_seg, a_seg, bits(gd_keys[step]), cfg.fmt)
            dldq = 2.0 * torch.sum(nw_b * (q[None] - t_seg), dim=0)
            inside = (torch.abs(w_seg) <= a_seg).to(torch.float32)
            w_seg = w_seg - cfg.lr * dldq * inside
        lo, hi = torch.min(ak[:, si]), torch.max(ak[:, si])
        losses = []
        for gi in range(cfg.n_grid):
            a = torch.clamp(_lerp(lo, ts[gi], hi), min=fp8._ALPHA_FLOOR)
            q = ref.fake_quant_bits(w_seg, a, bits(grid_keys[gi]), cfg.fmt)
            losses.append(torch.sum(nw_b * (q[None] - t_seg) ** 2))
        t_best = ts[torch.argmin(torch.stack(losses))]
        w_rows.append(w_seg)
        a_segs.append(_lerp(lo, t_best, hi))
    return _reassemble(avg, spec, torch.cat(w_rows), torch.stack(a_segs))
