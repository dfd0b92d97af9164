"""The one-device LM trainer, the port of ``repro.launch.train``.

``python -m repro_torch.launch.train`` trains a decoder from ``--arch``
(default TinyLlama-1.1B at full width; ``--reduced`` for its CPU-sized
version) on a synthetic token stream (``data.pipeline``: ``silo_stream``
cut by ``LMBatcher``, the reference's windows) with AdamW(3e-4, weight decay
0.01, the weight-decay and clip trust masks) under deterministic E4M3 QAT,
one ``launch.steps.make_train_step`` a step, at the reference's defaults:
50 steps at batch 8, sequence 128, opt_level 1 (the weight tree quantized
once a step on the plane: one B7 launch forward, one backward). Weights are
random, drawn with torch from ``--seed``. Runs on the card unless
``--device cpu`` is given:

    python -m repro_torch.launch.train [--device cuda|cpu] [--arch A] [--reduced]
        [--steps N] [--batch B] [--seq T] [--lr LR] [--no-qat] [--seed S]

On one device the reference runs no federated round boundary (its silo axes
are empty on a host mesh), so ``--local-steps`` changes nothing here either.
Not ported: ``--mesh pod|multipod`` (ROADMAP §1 item 7), ``--server-opt
fedavgm|fedadam`` (item 4) and checkpointing (``--ckpt-dir``, ``--ckpt-every``,
``--resume``; item 6); each raises when asked for.
"""
from __future__ import annotations

import argparse
import contextlib
import time

import torch

from .. import configs
from ..core.qat import DISABLED, QATConfig
from ..data.pipeline import LMBatcher, silo_stream
from ..device import resolve_device
from ..models import registry
from ..tree import leaves
from .steps import make_optimizer, make_train_step


def build_trainer(cfg, params: dict, qat: bool, lr: float, opt_kind: str = "adamw",
                  opt_level: int = 1):
    """``(model, opt, step_fn, qcfg)`` for ``cfg``; ``params`` give the
    optimizer's masks (the reference reads them from the shapes)."""
    model = registry.get_model(cfg)
    qcfg = QATConfig() if qat else DISABLED
    opt = make_optimizer(params, kind=opt_kind, lr=lr)
    return model, opt, make_train_step(model, opt, qcfg, opt_level=opt_level), qcfg


def run(*, arch: str = "tinyllama_1_1b", reduced: bool = False, steps: int = 50,
        batch: int = 8, seq: int = 128, lr: float = 3e-4, qat: bool = True,
        seed: int = 0, device="cuda", opt_level: int = 1, wrap_step=None,
        log=print) -> dict:
    """Train and return ``{"losses", "step_s", "tokens_per_step", "n_params",
    "peak_mem_bytes" (on the card)}``; ``losses`` and ``step_s`` hold one
    entry a step (``step_s`` host seconds, synchronized on the card).
    ``wrap_step(i)`` may return a context manager around step ``i`` (a
    profiler). ``opt_level`` is ``make_train_step``'s; the CLI, as the
    reference, always trains at 1."""
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        cfg = configs.reduced(cfg)
    stream = silo_stream(cfg.vocab, batch * (seq + 1) * 64, 0, seed)
    batcher = LMBatcher(stream, batch, seq)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    params = registry.get_model(cfg).init(seed, device=dev)
    model, opt, step_fn, _ = build_trainer(cfg, params, qat, lr, opt_level=opt_level)
    opt_state = opt.init(params)
    n_params = sum(t.numel() for t in leaves(params))
    log(f"[train] {cfg.name}{' (reduced)' if reduced else ''}: {n_params} parameters, "
        f"batch {batch} x {seq} tokens, opt_level {opt_level}, "
        f"QAT {'on' if qat else 'off'}, on {dev}")
    losses, step_s = [], []
    t_start = time.perf_counter()
    for step in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in batcher(step).items()}
        ctx = wrap_step(step) if wrap_step is not None else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            params, opt_state, m = step_fn(params, opt_state, b, step)
            loss = float(m["loss"])
            step_s.append(time.perf_counter() - t0)
        losses.append(loss)
        if (step + 1) % 10 == 0 or step == 0:
            log(f"step {step + 1:5d}  loss {loss:.4f}  "
                f"{(step + 1) / (time.perf_counter() - t_start):.2f} it/s")
    out = {"losses": losses, "step_s": step_s, "tokens_per_step": batch * seq,
           "n_params": n_params}
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    log("done")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        epilog="Checkpointing (--ckpt-dir, --ckpt-every, --resume) is not ported "
               "yet (ROADMAP §1 item 6); nor are --mesh pod|multipod (item 7) and "
               "--server-opt fedavgm|fedadam (item 4): each raises.")
    ap.add_argument("--arch", default="tinyllama_1_1b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--local-steps", type=int, default=10,
                    help="U: steps between federated round boundaries (one device: "
                         "no boundary, as in the reference on a host mesh)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-qat", action="store_true")
    ap.add_argument("--server-opt", default="mean", choices=["mean", "fedavgm", "fedadam"])
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--ckpt-dir", default=None, help="not ported (ROADMAP §1 item 6)")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="not ported (ROADMAP §1 item 6)")
    ap.add_argument("--resume", action="store_true", help="not ported (ROADMAP §1 item 6)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh}: multi-device meshes are not ported "
                                  "yet (ROADMAP §1 item 7)")
    if args.server_opt != "mean":
        raise NotImplementedError(f"--server-opt {args.server_opt}: FedAvgM / FedAdam are "
                                  "not ported yet (ROADMAP §1 item 4)")
    if args.resume or args.ckpt_dir is not None or args.ckpt_every is not None:
        raise NotImplementedError("checkpointing is not ported yet (ROADMAP §1 item 6)")
    run(arch=args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, qat=not args.no_qat, seed=args.seed,
        device=args.device)


if __name__ == "__main__":
    main()
