"""Paper Figure 2 on the port: server test accuracy against cumulative
communicated bytes, the port of ``benchmarks/fig2_curves.py``.

Methods: FP32 FedAvg (``fp32``), FP8 QAT with biased communication (``bq``,
the grid's ``det-cq``), FP8FedAvg-UQ (``uq``) and FP8FedAvg-UQ+ (``uq+``,
the server optimizer), iid, on cifar100-mlp unless ``--task`` names another
of ``bench.common.TASKS``. The default is the reference driver's CPU-budget
scale (K=10, C=0.3, U=10, B=32, 24 rounds, eval every 4, 3000 train / 800
test examples); ``--full`` its paper scale. One CSV row per method and
evaluated round, the reference's columns. Runs on the card unless
``--device cpu`` is given:

    python -m repro_torch.bench.fig2 [--device cuda|cpu] [--task T] [--full]
"""
from __future__ import annotations

import argparse
import time

from .common import TASKS, run_method

METHODS = (("fp32", "fp32"), ("bq", "det-cq"), ("uq", "uq"), ("uq+", "uq+"))
CPU_BUDGET = dict(rounds=24, k=10, c=0.3, local_steps=10, batch=32, n_train=3000,
                  n_test=800, eval_every=4)
FULL = dict(rounds=200, k=100, c=0.1, local_steps=50, batch=50, n_train=20000,
            n_test=4000, eval_every=5)


def run(full: bool = False, task_name: str = "cifar100-mlp", out_rows=None, *,
        device="cuda", scale: dict | None = None) -> list[dict]:
    """The curves' rows; ``scale`` overrides fields of the chosen scale.
    Besides the reference's columns each row carries the method's exact
    ``bytes_per_round`` and ``cumulative_bytes`` and its run's ``wall_s``."""
    sc = {**(FULL if full else CPU_BUDGET), **(scale or {})}
    task = TASKS[task_name]
    rows = out_rows if out_rows is not None else []
    for label, method in METHODS:
        t0 = time.perf_counter()
        h, b = run_method(task, method, noniid=False, device=device, **sc)
        wall = time.perf_counter() - t0
        for r, acc, byt in zip(h.rounds, h.accuracy, h.cumulative_bytes):
            rows.append({
                "bench": "fig2", "task": task_name, "method": label, "round": r,
                "acc": round(acc, 4), "mbytes": round(byt / 1e6, 3),
                "bytes_per_round": b, "cumulative_bytes": byt, "wall_s": round(wall, 2),
            })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--task", default="cifar100-mlp", choices=sorted(TASKS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(args.full, args.task, device=args.device)
    print("bench,task,method,round,acc,mbytes")
    for r in rows:
        print(f"{r['bench']},{r['task']},{r['method']},{r['round']},{r['acc']},{r['mbytes']}")


if __name__ == "__main__":
    main()
