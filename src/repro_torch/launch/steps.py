"""The one-device train step, the port of ``repro.launch.steps``.

* :func:`make_optimizer` — AdamW (or momentum SGD) with the weight-decay and
  clip-value trust masks, as the reference builds it.
* :func:`quantize_params_once` — opt_level >= 1 fake-quantizes the whole
  weight tree once a step on the tiled parameter plane (``core.plane``):
  one B7 launch forward and one backward, whatever the number of tensors,
  the quantized leaves handed to the model in bf16.
  :func:`quantize_params_once_per_leaf` is its parity reference.
* :func:`make_train_step` — one optimizer step at opt_level 0, 1 or 2, with
  ``accum`` microbatches.

Not ported: the FSDP-sharded variants (``quantize_params_once_sharded``,
``grad_shardings``), the round boundary over a mesh (``make_comm_round``,
``comm_round_state``, ``aggregator_state_specs``; ROADMAP §1 item 7) and the
serving steps (item 8).
"""
from __future__ import annotations

import dataclasses

import torch

from .. import tree
from ..core import fp8, plane
from ..core.qat import (QA_SUFFIX, QATConfig, clip_value_mask, quantized_leaf_names,
                        weight_decay_mask)
from ..models.common import COMPUTE_DTYPE
from ..optim import adamw, apply_updates, sgd
from ..optim.base import Optimizer


def make_optimizer(params: dict, kind: str = "adamw", lr: float = 3e-4) -> Optimizer:
    """``params`` gives the masks' names and ranks (the reference reads them
    from the shapes)."""
    mask = weight_decay_mask(params)
    tmask = clip_value_mask(params)
    if kind == "adamw":
        return adamw(lr, weight_decay=0.01, wd_mask=mask, trust_mask=tmask)
    return sgd(lr, momentum=0.9, weight_decay=1e-4, wd_mask=mask, trust_mask=tmask)


def quantize_params_once(params: dict, qcfg: QATConfig,
                         spec: plane.PlaneSpec | None = None) -> tuple[dict, QATConfig]:
    """Hoist the deterministic weight fake-quant out of the model: Q_det is a
    pure function of (w, alpha), so one quantization a step stands for every
    use (every layer pass, every microbatch). The tree rides one
    ``(rows, 1024)`` plane with a per-row alpha column; the quantized leaves
    come back in bf16 and the returned config stops the model from
    quantizing weights again. ``spec`` is the plane layout, built once by
    the caller (``make_train_step`` builds it at its first step)."""
    if not (qcfg.enabled and qcfg.quantize_weights):
        return params, qcfg
    qparams = plane.quantize_det(params, fmt=qcfg.fmt, spec=spec, out_dtype=COMPUTE_DTYPE)
    return qparams, dataclasses.replace(qcfg, quantize_weights=False)


def quantize_params_once_per_leaf(params: dict, qcfg: QATConfig) -> tuple[dict, QATConfig]:
    """The parity reference of :func:`quantize_params_once`: one plain
    ``fp8.quantize_det`` chain per quantized leaf (a stacked leaf's
    ``(L, 1, 1)`` alpha broadcasts over its layers)."""
    if not (qcfg.enabled and qcfg.quantize_weights):
        return params, qcfg
    qnames = quantized_leaf_names(params)
    flat = tree.flatten(params)
    by_name = dict(flat)
    out = [fp8.quantize_det(leaf.to(torch.float32), by_name[name + QA_SUFFIX],
                            qcfg.fmt).to(COMPUTE_DTYPE) if name in qnames else leaf
           for name, leaf in flat]
    return (tree.unflatten([n for n, _ in flat], out),
            dataclasses.replace(qcfg, quantize_weights=False))


def make_train_step(model, opt: Optimizer, qcfg: QATConfig, accum: int = 1,
                    opt_level: int = 1):
    """One optimizer step, ``step(params, opt_state, batch, step) -> (params,
    opt_state, {"loss": 0-dim tensor})``. ``accum > 1`` splits the batch into
    microbatches and accumulates their gradients in f32.

    opt_level 0: the model fake-quantizes the weights at every use (on the
    LM every projection is the fused B10/B11 product). opt_level 1: the
    weights are quantized once a step on the plane (B7), each microbatch's
    gradients are taken with respect to the detached bf16 quantized leaves,
    summed in f32, divided by ``accum``, cast to each quantized leaf's dtype,
    and the plane's backward is replayed once: one B7 backward a step,
    whatever ``accum``. opt_level 2: as 1, and each microbatch's f32
    gradients are rounded to bf16 before they are summed (the reference's
    bf16 gradient reduction; with ``accum == 1`` nothing is summed and
    nothing is rounded, as in the reference). On one device there is no
    gradient sharding.
    """
    if opt_level not in (0, 1, 2):
        raise ValueError(f"opt_level {opt_level}: one of 0, 1, 2")
    reduce_dtype = torch.bfloat16 if opt_level >= 2 else None
    cache: dict = {}

    def accumulate(loss_grads, batch, like):
        if accum == 1:
            return loss_grads(batch)
        micro = {k: v.reshape(accum, v.shape[0] // accum, *v.shape[1:])
                 for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=like[0].device)
        g_acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in like]
        for i in range(accum):
            loss, g = loss_grads({k: v[i] for k, v in micro.items()})
            if reduce_dtype is not None:
                g = [x.to(reduce_dtype) if x.dtype == torch.float32 else x for x in g]
            for a, b in zip(g_acc, g):
                a.add_(b.to(torch.float32))
            loss_acc = loss_acc + loss
            del g
        return loss_acc / accum, [a.div_(accum) for a in g_acc]

    def grads_at(names, leaves, q):
        def loss_grads(mb):
            loss = model.train_loss(tree.unflatten(names, leaves), mb, q)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            return loss.detach(), [torch.zeros_like(t) if gi is None else gi
                                   for gi, t in zip(g, leaves)]
        return loss_grads

    def train_step(params: dict, opt_state, batch: dict, step: int):
        flat = tree.flatten(params)
        names = [n for n, _ in flat]
        leaves = [t for _, t in flat]
        quantizing = opt_level >= 1 and qcfg.enabled and qcfg.quantize_weights
        if quantizing:
            if "spec" not in cache:
                cache["spec"] = plane.make_plane_spec(params)
            spec = cache["spec"]
            slots = spec.q_slots + spec.alpha_slots
            live = list(leaves)
            ins = [leaves[i].detach().requires_grad_() for i in slots]
            for i, t in zip(slots, ins):
                live[i] = t
            params_q, q_inner = quantize_params_once(tree.unflatten(names, live), qcfg, spec)
            pq = tree.leaves(params_q)
            pq_leaves = [t.detach().requires_grad_() for t in pq]
            loss, g_q = accumulate(grads_at(names, pq_leaves, q_inner), batch, pq_leaves)
            del pq_leaves
            g_q = [g.to(t.dtype) for g, t in zip(g_q, pq)]
            # the plane's VJP, replayed once: the quantized leaves' cotangents
            # through B7's backward to the weights and (segment-summed) alphas
            n_q = len(spec.q_slots)
            via_plane = torch.autograd.grad([pq[i] for i in spec.q_slots], ins,
                                            grad_outputs=[g_q[i] for i in spec.q_slots])
            del pq, params_q
            grads = g_q
            for i, g in zip(spec.q_slots, via_plane[:n_q]):
                grads[i] = g
            for i, g in zip(spec.alpha_slots, via_plane[n_q:]):
                grads[i] = grads[i] + g
        else:
            ins = [t.detach().requires_grad_() for t in leaves]
            loss, grads = accumulate(grads_at(names, ins, qcfg), batch, ins)
            grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
        del ins
        updates, opt_state = opt.update(tree.unflatten(names, grads), opt_state, params, step)
        del grads
        return apply_updates(params, updates), opt_state, {"loss": loss}

    return train_step
