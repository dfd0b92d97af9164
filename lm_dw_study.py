#!/usr/bin/env python3
"""How B11 ``qat_matmul_dw``'s errors show in the federated LM cell, on the card.

Run from the repository root:  python3 lm_dw_study.py [--spread [--dw NAME]]

The tensor-core dw is held to a bar against the f64 product (``ref.within_bar``),
not to its twin's bits, so the cell trains to other losses than with the twin.
This script measures what that difference is made of, on full-width
TinyLlama-1.1B (``repro_torch.bench.fed_lm``'s cell):

1. Every dw call of one local step (client 0's first batch, 4 x 64 tokens),
   captured and run again through the kernel, its twin and the f64 product
   (``ref.qat_matmul_dw_f64``): the bar; elements nonzero where the masked f64
   product is zero (``ref.stray_nonzeros``; there must be none); zeros that
   differ from the twin's; the signed error ``sign(ref64) (gw - ref64) / mag``
   averaged over the elements (negative: toward zero) and the share of
   elements the kernel shrinks less the share it grows; the RMS of ``(gw -
   ref64) / mag``; and g_alpha against its f64 sum, relative to the sum of the
   magnitudes of its terms, beside how far those terms cancel (their magnitude
   sum over ``|g_alpha|``) and the kernel's distance from the twin's g_alpha
   relative to the twin's.
2. The cell's two rounds (the mean local loss of each) with dw as shipped
   (twice: the cell is deterministic), with the exact product (f64, rounded
   once to f32; g_alpha in f64), with 1e-7 relative noise on the exact and on
   the kernel's gw, with additive noise of the kernel's own RMS error times
   the magnitude product on the exact one, with the exact one moved toward
   zero by the kernel's mean signed error, and with the twin (slow: an
   ascending loop over M a call). The spread of the runs other than the
   kernel's is printed beside the kernel's distance from them.

Both parts run at each seed of ``RUN_SEEDS``, passed to ``fed_lm.run(seed=)``
(the init weights and the round draws; the token streams are seedless) and
to the step's ``model.init``. Each seed ends with its span, the kernel's
distance beyond it a round, and its lean; the last lines count the seeds at
which the kernel lies beyond the span in either round.

``--spread`` runs only a pre-registered spread test of the cell's round-2
loss (``spread_study``): at each seed of ``RUN_SEEDS``, dw as shipped once,
the exact product once, and the exact product x (1 + 1e-7 N) at the eight
noise seeds ``SPREAD_NOISE_SEEDS``, which no earlier run used. With d = |loss
- the exact run's loss| after round 2, a seed counts against the kernel when
its d exceeds all eight noise runs' d (``spread_verdict``); the fault stands
when two or more of the three seeds do (``spread_rule``), which chance alone
gives with probability 25/729, about 3.4%. Otherwise the tensor-core dw is
indistinguishable, on the cell's final loss, from a 1e-7 relative
perturbation of the exact product. About 20 minutes on an H100 (30 runs).

``--spread --dw NAME`` runs the same test with a candidate dw from
``DW_CANDIDATES`` in the kernel's place, unchanged in every other respect
(the same seeds, noise seeds, statistic and rule), and runs the kernel, the
exact product and the noise runs again in the same process: it prints the
candidate's and the kernel's d, rank and verdict at each seed, |kernel -
candidate| after round 2, and the outcome of ``candidate_outcome``. With
``--dw twin`` (the twin's ascending f32 loop, the JAX package's own
arithmetic) it tells whether the rule flags any inexact f32 dw or the
tensor-core dw in particular; each twin run takes about 2-3 minutes more.

Exits non-zero without a card, if a dw call of the step misses the bar or
puts a nonzero where the masked f64 product is zero. About 9 minutes a seed
on an H100 (the twin's run a quarter of it) and 60 GB of device memory.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ARCH = "tinyllama_1_1b"
ROUNDS = 2
RUN_SEEDS = (0, 1, 2)  # fed_lm.run(seed=): init weights and round draws
NOISE = 1e-7          # relative size of the multiplicative noise
SEEDS = 3             # seeds of the noise on the exact product
KERNEL_SEEDS = 2      # seeds of the noise on the kernel's product
SPREAD_NOISE_SEEDS = tuple(range(3, 11))  # the spread test's noise seeds, unused before
SPREAD_ROUND = 2      # the spread test reads this round's loss only
SPREAD_FAULT_AT = 2   # seeds of three at which the kernel must exceed all noise runs


def spread_verdict(kernel_d: float, noise_d) -> bool:
    """One seed of the spread test: True when the kernel's distance from the
    exact run exceeds every noise run's distance (strictly)."""
    return all(kernel_d > d for d in noise_d)


def spread_rank(kernel_d: float, noise_d) -> int:
    """The kernel's rank among the kernel and noise distances, 1 the largest
    (ties with a noise run count against the kernel's rank)."""
    return 1 + sum(1 for d in noise_d if d >= kernel_d)


def spread_rule(verdicts) -> bool:
    """The pre-registered rule over the seeds: the fault stands when the
    kernel exceeds all noise runs at SPREAD_FAULT_AT or more seeds."""
    return sum(bool(v) for v in verdicts) >= SPREAD_FAULT_AT


def candidate_outcome(candidate_verdicts) -> str:
    """What the spread test says of a candidate dw run in the kernel's place:
    ``"a"`` when the rule flags it as it flagged the kernel (it exceeds every
    noise run at SPREAD_FAULT_AT or more seeds), so that the rule separates
    any such dw from the exact product and cannot tell the kernel's dw from
    the candidate's; ``"b"`` when it does not, so that the candidate passes
    where the kernel fails and the gap is the kernel's own."""
    return "a" if spread_rule(candidate_verdicts) else "b"


def spread_chance(n_noise: int = len(SPREAD_NOISE_SEEDS), n_seeds: int = 3,
                  at: int = SPREAD_FAULT_AT) -> float:
    """Probability that ``spread_rule`` holds by chance alone, when the
    kernel's distance is exchangeable with the noise runs' at each seed."""
    from math import comb
    p = 1.0 / (n_noise + 1)
    return sum(comb(n_seeds, k) * p ** k * (1 - p) ** (n_seeds - k)
               for k in range(at, n_seeds + 1))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("lm_dw_study: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    args = sys.argv[1:]
    if "--spread" in args:
        name = args[args.index("--dw") + 1] if "--dw" in args else None
        if name is not None and name not in DW_CANDIDATES:
            print(f"lm_dw_study: --dw {name}: one of {sorted(DW_CANDIDATES)}", file=sys.stderr)
            return 2
        return spread_study(dev, name)
    verdicts = {}
    ok = True
    for seed in RUN_SEEDS:
        seed_ok, beyond = study(seed, dev)
        ok = ok and seed_ok
        verdicts[seed] = beyond
        torch.cuda.empty_cache()
    gap = [s for s, b in verdicts.items() if max(b) > 0]
    print(f"[seeds] the kernel lies beyond the span of the runs without its product at "
          f"{len(gap)} of {len(verdicts)} seeds {gap} (rounds 1, 2: "
          + "; ".join(f"seed {s} {b[0]:.3g}, {b[1]:.3g}" for s, b in verdicts.items()) + ")")
    print(f"lm_dw_study: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


def study(seed: int, dev):
    """Parts 1 and 2 at one seed: ``(ok, beyond)``, ``beyond`` the kernel's
    distance outside the span a round, relative to the exact run's loss."""
    import torch
    from repro_torch import configs, tree
    from repro_torch.bench import fed_lm
    from repro_torch.core.fp8 import E4M3
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import fp8_matmul as FM
    from repro_torch.kernels import ref as R
    from repro_torch.models import registry

    print(f"[seed] {seed}")
    terms, exact = _terms, _exact
    kernel = FM.qat_matmul_dw
    twin = R.qat_matmul_dw

    # 1. every dw call of one full-width local step
    cfg = configs.get(ARCH)
    model = registry.get_model(cfg)
    params = model.init(seed, device=dev)
    xs, ys = fed_lm.client_data(1, 1, 64, cfg.vocab)
    names = [n for n, _ in tree.flatten(params)]
    leaves = [t.detach().requires_grad_() for t in tree.leaves(params)]
    calls = []

    def capture(g, x, w, beta, alpha, fmt=E4M3):
        calls.append((g.clone(), x.clone(), w, beta.clone(), alpha.clone(), fmt))
        return kernel(g, x, w, beta, alpha, fmt)
    FM.qat_matmul_dw = capture
    try:
        loss = model.train_loss(tree.unflatten(names, leaves),
                                {"tokens": xs[0, :4].to(dev), "labels": ys[0, :4].to(dev)},
                                QATConfig())
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        FM.qat_matmul_dw = kernel
    del loss, leaves, params
    rows = {}
    for g, x, w, beta, alpha, fmt in calls:
        r64, mag = R.qat_matmul_dw_f64(g, x, w, beta, alpha, fmt)
        v64, route = terms(g, x, w, beta, alpha, fmt)
        ga64 = float((v64 * route).sum())
        gmag = float((v64 * route).abs().sum())
        outs = {"kernel": kernel(g, x, w, beta, alpha, fmt), "twin": twin(g, x, w, beta, alpha, fmt)}
        e_t = R.product_error(outs["twin"][0], r64, mag)
        on = (mag > 0) & (r64 != 0)
        for name, (gw, ga) in outs.items():
            d = (gw.double() - r64)[on] / mag[on]
            e = R.product_error(gw, r64, mag)
            ref_abs, out_abs = r64.abs()[on], gw.double().abs()[on]
            row = rows.setdefault((name, tuple(x.shape) + (w.shape[1],)), {
                "calls": 0, "off_bar": 0, "ratio": 0.0, "stray": 0, "zeros": 0, "signed": 0.0,
                "n": 0, "shrink": 0, "sq": 0.0, "ga_mag": 0.0, "cancel": 0.0, "ga_twin": 0.0})
            row["calls"] += 1
            row["off_bar"] += 0 if R.within_bar(e, e_t) else 1
            row["ratio"] = max(row["ratio"], e / max(e_t, R.BAR_FLOOR))
            row["stray"] += R.stray_nonzeros(gw, r64)
            row["zeros"] += int(((gw == 0) != (outs["twin"][0] == 0)).sum())
            row["signed"] += float((torch.sign(r64[on]) * (gw.double()[on] - r64[on])
                                    / mag[on]).sum())
            row["n"] += int(on.sum())
            row["shrink"] += int((out_abs < ref_abs).sum()) - int((out_abs > ref_abs).sum())
            row["sq"] += float(d.pow(2).sum())
            row["ga_mag"] = max(row["ga_mag"], abs(float(ga) - ga64) / max(gmag, 1e-300))
            row["cancel"] = max(row["cancel"], gmag / max(abs(ga64), 1e-300))
            row["ga_twin"] = max(row["ga_twin"], abs(float(ga) - float(outs["twin"][1]))
                                 / max(abs(float(outs["twin"][1])), 1e-30))
        del r64, mag, v64, route, outs
    del calls
    total = {}
    for (name, shape), row in sorted(rows.items()):
        t = total.setdefault(name, dict.fromkeys(row, 0.0))
        for key, val in row.items():
            t[key] = max(t[key], val) if key in ("ratio", "ga_mag", "cancel", "ga_twin") \
                else t[key] + val
        print(f"[step] {name} {shape}: " + _summary(row))
    for name, t in total.items():
        print(f"[step] {name}, all calls: " + _summary(t))
    k = total["kernel"]
    ok = k["off_bar"] == 0 and k["stray"] == 0
    sigma = (k["sq"] / max(k["n"], 1)) ** 0.5
    bias = k["signed"] / max(k["n"], 1)

    # 2. the cell's losses under each dw
    def with_noise(dw, noise_seed, additive):
        return _with_noise(dw, noise_seed, dev, sigma if additive else None)

    def shifted(g, x, w, beta, alpha, fmt=E4M3):
        gw, ga = exact(g, x, w, beta, alpha, fmt)
        mag = R.qat_matmul_dw_f64(g, x, w, beta, alpha, fmt)[1]
        return (gw.double() + bias * mag * torch.sign(gw.double())).float(), ga

    runs = [("kernel", kernel), ("kernel again", kernel), ("exact", exact)]
    runs += [(f"exact x (1 + {NOISE:g} N), seed {s}", with_noise(exact, s, False))
             for s in range(SEEDS)]
    runs += [(f"kernel x (1 + {NOISE:g} N), seed {s}", with_noise(kernel, s, False))
             for s in range(KERNEL_SEEDS)]
    runs += [(f"exact + {sigma:.3g} mag N (the kernel's RMS error), seed {s}",
              with_noise(exact, s, True)) for s in range(KERNEL_SEEDS)]
    runs += [(f"exact + {bias:.3g} mag sign (the kernel's mean signed error)", shifted),
             ("twin", twin)]
    losses = {}
    for label, dw in runs:
        t0 = time.perf_counter()
        losses[label] = _cell_losses(dw, seed, dev)
        print(f"[loss] dw {label}: " + " -> ".join(f"{v:.6f}" for v in losses[label])
              + f" ({time.perf_counter() - t0:.1f} s)")
    ok = ok and losses["kernel"] == losses["kernel again"]
    beyond = []
    for r in range(ROUNDS):
        others = [v[r] for lab, v in losses.items() if not lab.startswith("kernel")]
        lo, hi, ex, kv = min(others), max(others), losses["exact"][r], losses["kernel"][r]
        print(f"[loss] round {r + 1}: runs without the kernel's product span {lo:.6f}-{hi:.6f} "
              f"({(hi - lo) / ex:.3g} of the exact run's {ex:.6f}); the kernel's {kv:.6f} is "
              f"{(kv - ex) / ex:+.3g} from it and {max(kv - hi, lo - kv, 0.0) / ex:.3g} outside "
              "that span")
        beyond.append(max(kv - hi, lo - kv, 0.0) / ex)
    print(f"[seed] {seed}: kernel beyond the span by {beyond[0]:.3g} / {beyond[1]:.3g} "
          f"(rounds 1, 2); mean signed error {bias:.3g} of mag, net shrink share "
          f"{k['shrink'] / max(k['n'], 1):.3g}; {'ok' if ok else 'FAILED'}")
    return ok, beyond


def _terms(g, x, w, beta, alpha, fmt):
    """``(v64, route)``: dw's unmasked f64 product and g_alpha's route."""
    import torch
    from repro_torch.kernels import ref as R
    v64 = R.quant_det(x, beta, fmt).double().t() @ g.double()
    a = torch.clamp(alpha.reshape(()).float(), min=1e-12)
    return v64, R._ste(w, a, torch.ones_like(w), fmt)[1].double()


def _exact(g, x, w, beta, alpha, fmt=None):
    """dw's exact product: the masked f64 product rounded once to f32, and
    g_alpha in f64."""
    import torch
    from repro_torch.core.fp8 import E4M3
    fmt = fmt or E4M3
    v64, route = _terms(g, x, w, beta, alpha, fmt)
    a = torch.clamp(alpha.reshape(()).float(), min=1e-12)
    return (v64 * (w.abs() <= a)).float(), (v64 * route).sum().float()


def _with_noise(dw, noise_seed: int, dev, sigma=None):
    """``dw`` with noise drawn from ``noise_seed`` on the card: gw x (1 +
    NOISE N), or, with ``sigma``, gw + sigma * mag * N (mag the magnitude
    product)."""
    import torch
    from repro_torch.core.fp8 import E4M3
    from repro_torch.kernels import ref as R
    gen = torch.Generator(device=dev).manual_seed(noise_seed)

    def noisy(g, x, w, beta, alpha, fmt=E4M3):
        gw, ga = dw(g, x, w, beta, alpha, fmt)
        z = torch.randn(gw.shape, generator=gen, device=dev)
        if sigma is None:
            return gw * (1.0 + NOISE * z), ga
        mag = R.qat_matmul_dw_f64(g, x, w, beta, alpha, fmt)[1]
        return (gw.double() + sigma * mag * z).float(), ga
    return noisy


def _cell_losses(dw, seed: int, dev) -> list:
    """The LM cell's mean local loss a round with ``dw`` in B11's place."""
    import torch
    from repro_torch.bench import fed_lm
    from repro_torch.kernels import fp8_matmul as FM
    kernel = FM.qat_matmul_dw
    FM.qat_matmul_dw = dw
    try:
        out = fed_lm.run(arch=ARCH, rounds=ROUNDS, seed=seed, device=dev, log=lambda s: None)
    finally:
        FM.qat_matmul_dw = kernel
    torch.cuda.empty_cache()
    return [r["local_loss"] for r in out]


def _twin_dw(*args, **kw):
    from repro_torch.kernels import ref as R
    return R.qat_matmul_dw(*args, **kw)


# the dw functions ``--spread --dw NAME`` can run in the kernel's place
DW_CANDIDATES = {"twin": _twin_dw}


def spread_study(dev, candidate: str | None = None) -> int:
    """The pre-registered spread test (module docstring): prints each seed's
    kernel and noise distances, the kernel's rank and verdict, then the
    rule's verdict; with ``candidate`` (a key of DW_CANDIDATES) the same for
    that dw, |kernel - candidate| and ``candidate_outcome``. Exits 0
    whatever the verdict; non-zero only if a run fails or a cell is not
    finite."""
    import math
    from repro_torch.kernels import fp8_matmul as FM
    kernel = FM.qat_matmul_dw
    r = SPREAD_ROUND - 1
    names = ["kernel"] + ([candidate] if candidate else [])
    verdicts = {name: [] for name in names}
    ok = True
    print(f"[spread] rule: at each seed d = |round-{SPREAD_ROUND} loss - the exact run's|; "
          f"a seed counts when a dw's d exceeds all {len(SPREAD_NOISE_SEEDS)} noise "
          f"runs' (exact x (1 + {NOISE:g} N), noise seeds {list(SPREAD_NOISE_SEEDS)}); the "
          f"fault stands at {SPREAD_FAULT_AT} or more of {len(RUN_SEEDS)} seeds (chance "
          f"{spread_chance():.4f})" + (f"; candidate: {candidate}" if candidate else ""))
    for seed in RUN_SEEDS:
        losses = {}
        runs = [("kernel", kernel)]
        runs += [(candidate, DW_CANDIDATES[candidate])] if candidate else []
        runs += [("exact", _exact)]
        runs += [(f"noise {s}", _with_noise(_exact, s, dev)) for s in SPREAD_NOISE_SEEDS]
        for label, dw in runs:
            t0 = time.perf_counter()
            losses[label] = _cell_losses(dw, seed, dev)
            ok = ok and all(math.isfinite(v) for v in losses[label])
            print(f"[spread] seed {seed} dw {label}: "
                  + " -> ".join(f"{v:.6f}" for v in losses[label])
                  + f" ({time.perf_counter() - t0:.1f} s)")
        ex = losses["exact"][r]
        noise_d = [abs(losses[f"noise {s}"][r] - ex) for s in SPREAD_NOISE_SEEDS]
        print(f"[spread] seed {seed}: exact {ex:.6f}; noise d "
              + ", ".join(f"{d:.6g}" for d in noise_d))
        for name in names:
            d = abs(losses[name][r] - ex)
            verdicts[name].append(spread_verdict(d, noise_d))
            print(f"[spread] seed {seed}: {name} d {d:.6g}; rank {spread_rank(d, noise_d)} "
                  f"of {len(noise_d) + 1}; "
                  f"{'exceeds all' if verdicts[name][-1] else 'within the noise runs'}")
        if candidate:
            print(f"[spread] seed {seed}: |kernel - {candidate}| after round {SPREAD_ROUND} "
                  f"{abs(losses['kernel'][r] - losses[candidate][r]):.6g}")
    for name in names:
        stands = spread_rule(verdicts[name])
        print(f"[spread] {name} exceeds all noise runs at {sum(verdicts[name])} of "
              f"{len(verdicts[name])} seeds: the rule "
              f"{'flags it' if stands else 'does not flag it'}"
              + ("" if name != "kernel" else
                 f" (the fault {'stands' if stands else 'is closed'})"))
    if candidate:
        print(f"[spread] outcome ({candidate} in the kernel's place): "
              f"{candidate_outcome(verdicts[candidate])}")
    print(f"lm_dw_study --spread: {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


def _summary(row) -> str:
    n = max(row["n"], 1)
    return (f"{row['calls']:.0f} calls, {row['off_bar']:.0f} off the bar (worst "
            f"{row['ratio']:.3g}x the twin's error or 2^-20), {row['stray']:.0f} stray nonzeros, "
            f"{row['zeros']:.0f} zeros unlike the twin's; mean signed error "
            f"{row['signed'] / n:.3g} of mag, net shrink share {row['shrink'] / n:.3g} (elements "
            f"it shrinks less those it grows), RMS error {(row['sq'] / n) ** 0.5:.3g} of mag; g_alpha "
            f"within {row['ga_mag']:.3g} of the f64 sum's term magnitudes (terms cancel up to "
            f"{row['cancel']:.3g}x), {row['ga_twin']:.3g} from the twin's relative to it")


if __name__ == "__main__":
    sys.exit(main())
