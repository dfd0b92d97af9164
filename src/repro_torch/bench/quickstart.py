"""Quickstart on the port: FP8FedAvg-UQ against FP32 FedAvg on a synthetic
task, the port of ``examples/quickstart.py``.

The reference's setting: the MLP (d_in 32, 10 classes) on 7000 synthetic
examples at noise 1.8 (6000 to train, 1000 to test), Dirichlet(0.3) over
K = 20 clients, C = 0.25 (5 a round), U = 20 local steps at batch 32, 40
rounds, ``sgd(0.1, weight_decay=1e-3)`` with the weight-decay and
clip-value masks. Prints each method's best accuracy and bytes a round.
Runs on the card unless ``--device cpu`` is given:

    python -m repro_torch.bench.quickstart [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time

from .. import optim
from ..core.engine import FedConfig
from ..core.fedsim import FedSim
from ..core.qat import DISABLED, QATConfig, clip_value_mask, weight_decay_mask
from ..data import partition_dirichlet, synthetic_classification
from ..models import small

ROUNDS, EVAL_EVERY, RUN_SEED = 40, 10, 42
CLIENTS = dict(n_clients=20, participation=0.25, local_steps=20, batch_size=32)
METHODS = (("FP32 FedAvg", dict(comm_mode="none", qat=DISABLED)),
           ("FP8FedAvg-UQ", dict(comm_mode="rand", qat=QATConfig())))


def run(device="cuda", rounds: int = ROUNDS) -> list[dict]:
    """One row a method: best accuracy, exact bytes a round and cumulative
    bytes at each evaluation, the run's wall time."""
    xall, yall = synthetic_classification(0, 7000, d=32, n_classes=10, noise=1.8)
    x, y, xt, yt = xall[:6000], yall[:6000], xall[6000:], yall[6000:]
    cx, cy, nk = partition_dirichlet(x, y, k=20, concentration=0.3, seed=0)
    init, apply = small.REGISTRY["mlp"]
    rows = []
    for name, method in METHODS:
        params = init(0, device=device)
        opt = optim.sgd(0.1, weight_decay=1e-3, wd_mask=weight_decay_mask(params),
                        trust_mask=clip_value_mask(params))
        sim = FedSim(params, small.make_loss(apply), apply, opt,
                     FedConfig(**CLIENTS, **method), cx, cy, nk, device=device)
        t0 = time.perf_counter()
        hist = sim.run(rounds, seed=RUN_SEED, eval_data=(xt, yt), eval_every=EVAL_EVERY)
        rows.append({"method": name, "best_accuracy": hist.best_accuracy(),
                     "bytes_per_round": sim.bytes_per_round, "rounds": hist.rounds,
                     "cumulative_bytes": hist.cumulative_bytes,
                     "wall_s": time.perf_counter() - t0})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for r in run(args.device):
        print(f"{r['method']:14s} acc={r['best_accuracy']:.3f} "
              f"bytes/round={r['bytes_per_round'] / 1e3:.0f}KB")
    print("\n=> same accuracy, ~3.8x fewer bytes on the wire.")


if __name__ == "__main__":
    main()
