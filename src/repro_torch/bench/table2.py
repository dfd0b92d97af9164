"""Paper Table 2 on the port: deterministic vs stochastic quantization, for
QAT and for communication, the port of ``benchmarks/table2_ablation.py``.

Four cells (paper): {det, rand} QAT without communication quantization;
det QAT with {det, rand} communication. Expected orderings (paper, Remarks
3-4): det QAT >= rand QAT; rand CQ >> det CQ. Runs on the card unless
``--device cpu`` is given:

    python -m repro_torch.bench.table2 [--device cuda|cpu] [--task T]
        [--rounds R] [--full]
"""
from __future__ import annotations

import argparse
import time

from .common import TASKS, run_method

CELLS = (
    ("det-qat/no-cq", "qat-only"),
    ("rand-qat/no-cq", "rand-qat-only"),
    ("det-qat/det-cq", "det-cq"),
    ("det-qat/rand-cq", "uq"),
)
CPU_BUDGET = dict(rounds=30, k=12, c=0.3, local_steps=12, batch=32,
                  n_train=3000, n_test=800)
FULL = dict(rounds=300, k=100, c=0.1, local_steps=50, batch=50,
            n_train=20000, n_test=4000)


def run(full: bool = False, task_name: str = "cifar100-mlp", out_rows=None, *,
        device="cuda", scale: dict | None = None, cells=CELLS) -> list[dict]:
    """Rows of the ablation; ``scale`` overrides fields of the chosen scale."""
    sc = {**(FULL if full else CPU_BUDGET), **(scale or {})}
    task = TASKS[task_name]
    rows = out_rows if out_rows is not None else []
    for label, method in cells:
        t0 = time.perf_counter()
        h, b = run_method(task, method, noniid=False, device=device, **sc)
        rows.append({
            "bench": "table2", "task": task_name, "cell": label, "method": method,
            "final_acc": round(h.best_accuracy(), 4), "bytes_per_round": b,
            "wall_s": round(time.perf_counter() - t0, 2),
        })
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--task", default="cifar100-mlp")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int)
    args = ap.parse_args(argv)
    scale = {"rounds": args.rounds} if args.rounds else None
    rows = run(args.full, args.task, device=args.device, scale=scale)
    print("bench,task,cell,final_acc")
    for r in rows:
        print(f"{r['bench']},{r['task']},{r['cell']},{r['final_acc']}")


if __name__ == "__main__":
    main()
