"""Paper Table 1 on the port: final accuracy + communication gain vs FP32
FedAvg, the port of ``benchmarks/table1_comm_gain.py``.

Grid: tasks x {iid, Dir(0.3)} x {fp32, uq, uq+}. The default tasks are
the reference driver's three (cifar10-lenet, cifar100-mlp, speech-kwt);
``--tasks`` takes any of ``bench.common.TASKS``, the paper's ResNet and
MatchboxNet cells (cifar10-resnet, speech-matchbox) too. The default scale
is the reference driver's CPU budget (K=10, C=0.3, U=10, B=32, 20 rounds,
3000 train / 800 test examples); ``--full`` the paper scale. Runs on the
card unless ``--device cpu`` is given:

    python -m repro_torch.bench.table1 [--device cuda|cpu] [--tasks ...]
        [--rounds R] [--eval-every E] [--full]
"""
from __future__ import annotations

import argparse
import time

from .common import TASKS, comm_gain, run_method

TABLE1_TASKS = ("cifar10-lenet", "cifar100-mlp", "speech-kwt")   # the reference's default
TABLE1_METHODS = ("fp32", "uq", "uq+")
CPU_BUDGET = dict(rounds=20, k=10, c=0.3, local_steps=10, batch=32,
                  n_train=3000, n_test=800)
FULL = dict(rounds=300, k=100, c=0.1, local_steps=50, batch=50,
            n_train=20000, n_test=4000)


def run(full: bool = False, tasks=None, out_rows=None, *, device="cuda",
        scale: dict | None = None, eval_every: int = 5) -> list[dict]:
    """Rows of the grid; ``scale`` overrides fields of the chosen scale."""
    sc = {**(FULL if full else CPU_BUDGET), **(scale or {})}
    rows = out_rows if out_rows is not None else []
    for tname in tasks or TABLE1_TASKS:
        task = TASKS[tname]
        for noniid in (False, True):
            results = {}
            for m in TABLE1_METHODS:
                t0 = time.perf_counter()
                h, b = run_method(task, m, noniid=noniid, eval_every=eval_every,
                                  device=device, **sc)
                results[m] = (h, b, time.perf_counter() - t0)
            h32, b32, _ = results["fp32"]
            for m, (h, b, wall) in results.items():
                gain = 1.0 if m == "fp32" else comm_gain(h32, b32, h, b)
                rows.append({
                    "bench": "table1", "task": tname,
                    "setting": "dir0.3" if noniid else "iid", "method": m,
                    "final_acc": round(h.best_accuracy(), 4),
                    "bytes_per_round": b,
                    "comm_gain": round(gain, 2) if gain == gain else "nan",
                    "wall_s": round(wall, 2),
                })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--tasks", nargs="*", choices=sorted(TASKS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int)
    ap.add_argument("--eval-every", type=int, default=5)
    args = ap.parse_args(argv)
    scale = {"rounds": args.rounds} if args.rounds else None
    rows = run(args.full, args.tasks, device=args.device, scale=scale,
               eval_every=args.eval_every)
    print("bench,task,setting,method,final_acc,comm_gain,bytes_per_round")
    for r in rows:
        print(f"{r['bench']},{r['task']},{r['setting']},{r['method']},"
              f"{r['final_acc']},{r['comm_gain']},{r['bytes_per_round']}")


if __name__ == "__main__":
    main()
