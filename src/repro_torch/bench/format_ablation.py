"""Beyond-paper ablation on the port: the wire-codec registry, the scaling
policies and the compression stack on the federated pipeline, the port of
``benchmarks/format_ablation.py`` (its ``format``, ``scaling`` and ``pareto``
sections).

``format``: FP32, then E4M3, E5M2, FP4 E2M1, FP4 E3M0, delta:E4M3 and
delta:FP4-E2M1 (delta on the uplink, its inner grid on the downlink), each
with stochastic (``rand``) and deterministic (``det``) rounding: 13 cells.
``scaling``: the E4M3 rand wire under current, delayed:4, delayed:16:1,
frozen downlink, and frozen downlink with a delayed:4 uplink: 5 cells.
``pareto``: on E4M3 and on FP4 E2M1, the plain wire, a delta uplink, an
error-feedback uplink over the det grid (``ef:``), rANS on both legs with a
delta uplink (``rans:``), and rANS with an error-feedback uplink
(``ef:rans:``): 10 cells. An entropy-coded leg is dynamic, so a pareto row
reports the bound (``round_bytes``) beside the bytes the run measured
(``measured_round_bytes``, the simulator's cumulative bytes over the
rounds), the bits per parameter and the gains against FP32 from the
measured bytes; the measured bytes must not exceed the bound, and must equal
it on a cell with no rANS leg.
Every cell runs the same ``FedSim`` at the reference's configuration (an
MLP with d_in 64 and 10 classes on ``synthetic_classification(0, 4000,
d=64, n_classes=10, noise=1.6)``, 3200 train / 800 test, K=10, C=0.3,
U=10, B=32, SGD 0.1 with weight decay 1e-3 and the QAT masks, 25 rounds,
or 120 with ``--full``, eval every 5) and asserts that the codec's static
bytes per round equal the simulator's. Rows go to stdout. Runs on the
card unless ``--device cpu`` is given:

    python -m repro_torch.bench.format_ablation [--device cuda|cpu]
        [--sections format scaling pareto] [--rounds R] [--full]
"""
from __future__ import annotations

import argparse
import time

from .. import optim
from ..core import metrics
from ..core.engine import FedConfig
from ..core.fedsim import FedSim
from ..core.qat import QATConfig, clip_value_mask, weight_decay_mask
from ..data import partition_iid, synthetic_classification
from ..models import small

CODECS = ("e4m3", "e5m2", "fp4_e2m1", "fp4_e3m0", "delta:e4m3", "delta:fp4_e2m1")
ROUNDINGS = ("rand", "det")
SCALINGS = (
    ("current", {}),
    ("delayed:4", dict(down_scaling="delayed:4", up_scaling="delayed:4")),
    ("delayed:16:1", dict(down_scaling="delayed:16:1", up_scaling="delayed:16:1")),
    ("frozen_down", dict(down_scaling="frozen")),
    ("frozen_down+delayed_up", dict(down_scaling="frozen", up_scaling="delayed:4")),
)
PARETO = (   # (cell, down codec, up codec)
    ("e4m3|plain", "e4m3", "e4m3"),
    ("e4m3|delta", "e4m3", "delta:e4m3"),
    ("e4m3|ef", "e4m3", "ef:e4m3_det"),
    ("e4m3|rans", "rans:e4m3", "rans:delta:e4m3"),
    ("e4m3|ef+rans", "rans:e4m3", "ef:rans:e4m3_det"),
    ("fp4|plain", "fp4_e2m1", "fp4_e2m1"),
    ("fp4|delta", "fp4_e2m1", "delta:fp4_e2m1"),
    ("fp4|ef", "fp4_e2m1", "ef:fp4_e2m1_det"),
    ("fp4|rans", "rans:fp4_e2m1", "rans:delta:fp4_e2m1"),
    ("fp4|ef+rans", "rans:fp4_e2m1", "ef:rans:fp4_e2m1_det"),
)
SECTIONS = ("format", "scaling", "pareto")
ACC_THRESHOLD = 0.95    # the pareto rows' bytes-to-accuracy comparison point
DEFAULT = dict(rounds=25, n=4000, n_train=3200, k=10, c=0.3, local_steps=10, batch=32,
               eval_every=5)
FULL = {**DEFAULT, "rounds": 120}
SEED = 3  # the reference driver's FedSim.run seed


def _det(codec: str) -> str:
    if codec.startswith("delta:"):
        return "delta:" + _det(codec[len("delta:"):])
    return codec + "_det"


def _legs(codec: str, rounding: str) -> dict:
    name = codec if rounding == "rand" else _det(codec)
    if codec.startswith("delta:"):
        return {"down_codec": name[len("delta:"):], "up_codec": name}
    return {"down_codec": name, "up_codec": name}


def cells(sections=SECTIONS) -> list[tuple[str, str, dict]]:
    """``(section, cell, FedConfig overrides)`` of every cell, in run order."""
    out = []
    if "format" in sections:
        out.append(("format", "fp32", dict(comm_mode="none")))
        out += [("format", f"{c}|{r}", _legs(c, r)) for c in CODECS for r in ROUNDINGS]
    if "scaling" in sections:
        out += [("scaling", cell, dict(comm_mode="rand", **kw)) for cell, kw in SCALINGS]
    if "pareto" in sections:
        out += [("pareto", cell, dict(down_codec=down, up_codec=up))
                for cell, down, up in PARETO]
    return out


def iter_rows(full: bool = False, sections=SECTIONS, *, device="cuda",
              scale: dict | None = None):
    """One row per cell, each cell run when its row is asked for (so a
    caller can read the kernels' launch counts of each cell on its own);
    ``scale`` overrides fields of the chosen scale. The pareto rows compare
    with the fp32 cell's run, which runs first (not as a row) when the
    ``format`` section is not asked for."""
    bad = set(sections) - set(SECTIONS)
    if bad:
        raise ValueError(f"sections {sorted(bad)}: choose from {SECTIONS}")
    sc = {**(FULL if full else DEFAULT), **(scale or {})}
    x_all, y_all = synthetic_classification(0, sc["n"], d=64, n_classes=10, noise=1.6)
    n_train = sc["n_train"]
    cx, cy, nk = partition_iid(x_all[:n_train], y_all[:n_train], k=sc["k"], seed=0)
    test = (x_all[n_train:], y_all[n_train:])
    init, apply = small.REGISTRY["mlp"]
    params = init(0, d_in=64, n_classes=10, device=device)
    loss = small.make_loss(apply)
    wdm, tm = weight_decay_mask(params), clip_value_mask(params)
    base = dict(n_clients=sc["k"], participation=sc["c"], local_steps=sc["local_steps"],
                batch_size=sc["batch"], qat=QATConfig())
    n_params = metrics.param_count(params)
    fp32_bytes = metrics.round_bytes_for(params, FedConfig(**base, comm_mode="none"))

    def run_cell(kw):
        cfg = FedConfig(**base, **kw)
        opt = optim.sgd(0.1, weight_decay=1e-3, wd_mask=wdm, trust_mask=tm)
        t0 = time.perf_counter()
        sim = FedSim(params, loss, apply, opt, cfg, cx, cy, nk, device=device)
        hist = sim.run(sc["rounds"], seed=SEED, eval_data=test, eval_every=sc["eval_every"])
        return cfg, sim, hist, time.perf_counter() - t0

    fp32_hist = None
    if "pareto" in sections and "format" not in sections:
        fp32_hist = run_cell(dict(comm_mode="none"))[2]
    cur_acc = None
    for section, cell, kw in cells(sections):
        cfg, sim, hist, wall = run_cell(kw)
        round_bytes = metrics.round_bytes_for(params, cfg)
        assert round_bytes == sim.bytes_per_round  # the codecs' static accounting
        acc = round(hist.best_accuracy(), 4)
        if cell == "fp32":
            fp32_hist = hist
        if section == "pareto":
            yield _pareto_row(cell, cfg, sim, hist, sc["rounds"], n_params, fp32_bytes,
                              fp32_hist, wall)
            continue
        assert hist.cumulative_bytes[-1] == sc["rounds"] * round_bytes
        row = {
            "bench": section, "qat_fmt": "e4m3",
            "comm_fmt": cell if section == "format" else f"e4m3|rand|{cell}",
            "down_codec": cfg.resolved_down_codec.tag,
            "up_codec": cfg.resolved_up_codec.tag,
            "round_bytes": round_bytes,
            "comm_gain_vs_fp32": round(fp32_bytes / round_bytes, 3),
            "final_acc": acc, "wall_s": round(wall, 2),
        }
        if section == "scaling":
            cur_acc = acc if cell == "current" else cur_acc
            row["scaling"] = cell
            row["acc_delta_vs_current"] = (None if cur_acc is None
                                           else round(acc - cur_acc, 4))
        yield row


def _pareto_row(cell, cfg, sim, hist, rounds, n_params, fp32_bytes, fp32_hist, wall):
    """A pareto row, with the two-lane contract asserted: the measured bytes
    of a dynamic (rANS) cell at most its bound, of any other cell equal."""
    bound = sim.bytes_per_round
    measured = hist.cumulative_bytes[-1] / rounds
    if sim.engine.dynamic:
        assert measured <= bound, (cell, measured, bound)
    else:
        assert measured == bound, (cell, measured, bound)
    acc = round(hist.best_accuracy(), 4)
    fp32_acc = round(fp32_hist.best_accuracy(), 4)
    b32 = fp32_hist.bytes_to_accuracy(ACC_THRESHOLD)
    bc = hist.bytes_to_accuracy(ACC_THRESHOLD)
    return {
        "bench": "pareto", "qat_fmt": "e4m3", "comm_fmt": cell,
        "down_codec": cfg.resolved_down_codec.tag,
        "up_codec": cfg.resolved_up_codec.tag,
        "round_bytes": bound,
        "measured_round_bytes": round(measured, 1),
        "bits_per_param": round(measured * 8 / (2 * cfg.clients_per_round * n_params), 3),
        "comm_gain_vs_fp32": round(fp32_bytes / measured, 3),
        "gain_to_acc_0p95": round(b32 / bc, 2) if (b32 and bc) else None,
        "final_acc": acc, "acc_delta_vs_fp32": round(acc - fp32_acc, 4),
        "wall_s": round(wall, 2),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    ap.add_argument("--rounds", type=int)
    args = ap.parse_args(argv)
    scale = {"rounds": args.rounds} if args.rounds else None
    print("bench,comm_fmt,down_codec,up_codec,round_bytes,measured_round_bytes,"
          "comm_gain_vs_fp32,final_acc,wall_s")
    for r in iter_rows(args.full, args.sections, device=args.device, scale=scale):
        print(f"{r['bench']},{r['comm_fmt']},{r['down_codec']},{r['up_codec']},"
              f"{r['round_bytes']},{r.get('measured_round_bytes', r['round_bytes'])},"
              f"{r['comm_gain_vs_fp32']},{r['final_acc']},{r['wall_s']}", flush=True)


if __name__ == "__main__":
    main()
