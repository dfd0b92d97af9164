#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero):

1. set-up: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``); turns TF32 off for matmuls and cuDNN
   convolutions; builds the four CUDA kernels from ``src/repro_torch/
   kernels/csrc`` (``nvcc``, at first use) and prints the build time.
2. each kernel against its plain PyTorch twin on the card, at LeNet's wire
   shape (135, 1024), a multi-block ragged (8191, 1024), every QAT site
   shape of LeNet at batch 32 (random inputs), and LeNet's init weights and
   a batch of images at their own clip values; bitwise, with at most 1e-5
   of elements allowed to differ (adjacent-grid ties) and the scalar clip
   cotangent at relative 1e-5. Prints each kernel's median time (CUDA
   events) beside its plain twin's and its bound (bytes over 3.35 TB/s, or
   operations over the card's f32 rate, whichever is larger).
3. the card against the CPU twins: one small federated round with the same
   draws (``round_phase``; MLP, LeNet with weight QAT, LeNet with full
   QAT): exact bytes, params and loss within the tolerances stated there.
4. the main path: ``FedSim`` on cifar10-lenet (full-width LeNet), method uq,
   K=10, C=0.3 (P=3), 10 local steps at batch 32, 3000 train / 800 test
   examples, 3 rounds with eval at the end. Every kernel's launch counter
   is zeroed just before and read just after; each must be > 0.
   ``bytes_per_round`` must be 826860 and the loss finite.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3
F32_OPS_PER_S = 67e12           # H100 SXM f32 outside the tensor cores
TIE_FRAC = 1e-5
SLICE_ROUND_BYTES = 826860      # 3 clients x 2 legs x 137810-byte payloads


def synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 7, iters: int = 50) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(stop) / iters)
    return statistics.median(samples)


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mismatches(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
    diff = a.to(torch.float64) - b.to(torch.float64)
    return int((diff != 0).sum()), float(diff.abs().max()) if diff.numel() else 0.0


# ---------------------------------------------------------------------------
# phase 2: kernels against their twins
# ---------------------------------------------------------------------------


def kernel_phase(dev) -> dict:
    from repro_torch.data import synthetic_images
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R
    from repro_torch.models import small

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    # every QAT site shape of LeNet at batch 32 (activations, then weights),
    # the wire tiles, and a multi-block ragged shape
    site_shapes = [(32, 32, 32, 3), (32, 16, 16, 6), (32, 1024), (32, 120), (32, 84),
                   (5, 5, 3, 6), (5, 5, 6, 16), (1024, 120), (120, 84), (84, 10)]
    tile_shapes = [(135, 1024), (8191, 1024)]
    cases = [("random", randn(s, 0.3), None) for s in site_shapes + tile_shapes]
    # real site inputs: LeNet's init weights at alpha = max|w| (one element
    # on the clip boundary) and a batch of images at the init beta
    params = small.init_lenet(0, device=dev)
    for layer in ("conv1", "conv2", "fc1", "fc2", "head"):
        p = params[layer]
        cases.append((f"lenet {layer}.w", p["w"], p["w_qa"]))
    images = torch.from_numpy(synthetic_images(1, 32, n_classes=10, noise=0.45)[0]).to(dev)
    cases.append(("images", images, params["conv1"]["x_qb"]))
    worst = {k: 0.0 for k in K.KERNELS}

    for label, x, a in cases:
        # cotangent with the sign of x: the clipped terms of g_alpha then add
        # up instead of cancelling, so relative error measures the kernel
        shape = tuple(x.shape)
        gr = randn(shape, 1.0).abs() * torch.sign(x)
        a = x.abs().max() * 0.8 if a is None else a
        n = x.numel()
        bad, err = mismatches(K.quant_det(x, a), R.quant_det(x, a))
        worst["quant_det"] = max(worst["quant_det"], err)
        check(bad <= TIE_FRAC * n, f"quant_det {label}: {bad} of {n} differ")
        gx, ga = K.quant_det_bwd(x, a, gr)
        rgx, rga = R.quant_det_bwd(x, a, gr)
        bad, err = mismatches(gx, rgx)
        rel = abs(float(ga) - float(rga)) / max(abs(float(rga)), 1e-30)
        worst["quant_det_bwd"] = max(worst["quant_det_bwd"], err,
                                     abs(float(ga) - float(rga)))
        check(bad == 0, f"quant_det_bwd gx {label}: {bad} of {n} differ")
        check(rel <= 1e-5, f"quant_det_bwd g_alpha {label}: rel err {rel:.3g}")
        print(f"[kernels] quant_det/bwd {label} {shape}: g_alpha kernel {float(ga):.9g} "
              f"twin {float(rga):.9g} rel {rel:.3g}")

    for shape in tile_shapes:
        x = randn(shape, 0.2)
        col = x.abs().amax(dim=1, keepdim=True) * 0.9
        for a2 in (col, col.expand(shape).contiguous()):
            for k2 in (None, key):
                c = K.quant_pack_tiles(x, a2, k2)
                rc = R.quant_pack_tiles(x, a2, k2)
                bad, err = mismatches(c, rc)
                worst["quant_pack_tiles"] = max(worst["quant_pack_tiles"], err)
                check(bad <= TIE_FRAC * c.numel(),
                      f"quant_pack_tiles {shape} a{tuple(a2.shape)} "
                      f"{'rand' if k2 is not None else 'det'}: {bad} codes differ")
                bad, err = mismatches(K.unpack_tiles(c, a2), R.unpack_tiles(c, a2))
                worst["unpack_tiles"] = max(worst["unpack_tiles"], err)
                check(bad <= TIE_FRAC * c.numel(),
                      f"unpack_tiles {shape}: {bad} values differ")
    print(f"[kernels] all kernels within bound; max abs err {worst}")
    synchronize()

    # --- times at the main path's shapes, and at a large ragged shape ----
    timings = {}
    for label, shape in (("main", None), ("large", (8191, 1024))):
        act = shape or (32, 32, 32, 3)       # largest QAT site (conv1 input)
        tile = shape or (135, 1024)          # LeNet's wire tiles
        x, gr = randn(act, 0.3), randn(act, 1.0)
        a = x.abs().max() * 0.8
        xt = randn(tile, 0.2)
        col = xt.abs().amax(dim=1, keepdim=True) * 0.9
        codes = K.quant_pack_tiles(xt, col, key)
        n, nt, rows = x.numel(), xt.numel(), tile[0]
        cases = {
            "quant_det": (lambda: K.quant_det(x, a), lambda: R.quant_det(x, a),
                          8 * n + 4, 12 * n, act),
            "quant_det_bwd": (lambda: K.quant_det_bwd(x, a, gr),
                              lambda: R.quant_det_bwd(x, a, gr),
                              12 * n + 8, 20 * n, act),
            "quant_pack_tiles": (lambda: K.quant_pack_tiles(xt, col, key),
                                 lambda: R.quant_pack_tiles(xt, col, key),
                                 5 * nt + 4 * rows + 8, 40 * nt, tile),
            "unpack_tiles": (lambda: K.unpack_tiles(codes, col),
                             lambda: R.unpack_tiles(codes, col),
                             5 * nt + 4 * rows, 12 * nt, tile),
        }
        for name, (kern, twin, n_bytes, n_ops, shp) in cases.items():
            ms, plain_ms = time_ms(kern), time_ms(twin, reps=5, iters=10)
            b_ms, b_by = bound(n_bytes, n_ops)
            timings.setdefault(name, {})[label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=list(shp))
            print(f"[time] {name:17s} {label:5s} {str(shp):18s} kernel {ms:.5f} ms  "
                  f"twin {plain_ms:.5f} ms  bound {b_ms:.6f} ms ({b_by})")
    return {"worst": worst, "timings": timings}


# ---------------------------------------------------------------------------
# phase 3: small rounds, card against CPU twins
# ---------------------------------------------------------------------------


def _small_round(model: str, device: str, draws, qcfg):
    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import clip_value_mask, weight_decay_mask
    from repro_torch.data import partition_iid, synthetic_classification, synthetic_images
    from repro_torch.models import small

    init, apply = small.REGISTRY[model]
    if model == "mlp":
        x, y = synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    else:
        x, y = synthetic_images(0, 160, n_classes=10, noise=0.45)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    p = init(0, device=device)
    opt = optim.sgd(0.05, weight_decay=1e-3, wd_mask=weight_decay_mask(p),
                    trust_mask=clip_value_mask(p))
    cfg = FedConfig(n_clients=4, participation=0.5, local_steps=3, batch_size=8,
                    qat=qcfg)
    sim = FedSim(p, small.make_loss(apply), apply, opt, cfg, cx, cy, nk, device=device)
    if draws is None:
        draws = [sim.engine.draw(torch.Generator().manual_seed(11), sim.nk.cpu(),
                                 cx.shape[1])]
    hist = sim.run(1, draws=draws, eval_data=(x[:64], y[:64]), eval_every=1)
    return sim, hist, draws


def round_phase(dev) -> None:
    """One small uq round on the card against the same round on the CPU
    twins, with the same draws; bytes must be equal. Held to the CPU parity
    tests' tolerance (loss rtol 1e-5, all but 1e-3 of the params within
    1e-5 + 1e-4|ref|): the MLP, and LeNet with weight QAT and the wire but
    no activation quantizers, so that the full conv + weight-QAT + wire
    round is checked tightly. LeNet with activation quantizers is held
    loosely: cuDNN's f32 convolutions differ from the CPU's in the last
    bits, an activation quantizer turns that into another grid point, and
    that moves every later site's input, the step's loss by ~1% and every
    later gradient. There the loss is held to rtol 2e-2 and each quantized
    weight to one top-bin grid step (alpha / 15), the size of a wrong
    code; the count beyond the strict tolerance is printed."""
    from repro_torch import tree
    from repro_torch.core.qat import QATConfig

    for model, qcfg, strict in (("mlp", QATConfig(), True),
                                ("lenet", QATConfig(quantize_acts=False), True),
                                ("lenet", QATConfig(), False)):
        label = f"{model} {'weight QAT' if not qcfg.quantize_acts else 'full QAT'}"
        cpu_sim, cpu_hist, draws = _small_round(model, "cpu", None, qcfg)
        gpu_sim, gpu_hist, _ = _small_round(model, dev, draws, qcfg)
        ref = dict(tree.flatten(cpu_sim.params))
        n_bad = n_all = 0
        step_ok = True
        for name, v in tree.flatten(gpu_sim.params):
            r, v = ref[name].double(), v.cpu().double()
            d = (v - r).abs()
            n_bad += int((d > 1e-5 + 1e-4 * r.abs()).sum())
            n_all += r.numel()
            qa = name.rsplit(".", 1)[0] + ".w_qa"
            if name.endswith(".w") and qa in ref:
                step_ok &= float(d.max()) <= float(ref[qa]) / 15 + 1e-5
        print(f"[round] {label}: card vs CPU twins: bytes {gpu_hist.cumulative_bytes[0]} "
              f"vs {cpu_hist.cumulative_bytes[0]}, loss {gpu_hist.loss[0]:.7f} vs "
              f"{cpu_hist.loss[0]:.7f}, {n_bad} of {n_all} params beyond 1e-5 + 1e-4|ref|")
        check(gpu_hist.cumulative_bytes == cpu_hist.cumulative_bytes, f"{label}: bytes")
        check(step_ok, f"{label}: a weight is off by more than a grid step")
        if strict:
            check(n_bad <= max(1, 1e-3 * n_all), f"{label}: {n_bad} of {n_all} differ")
        check(math.isclose(gpu_hist.loss[0], cpu_hist.loss[0],
                           rel_tol=1e-5 if strict else 2e-2),
              f"{label}: loss {gpu_hist.loss[0]} vs cpu {cpu_hist.loss[0]}")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def main_path_phase(dev) -> dict:
    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import QATConfig, clip_value_mask, weight_decay_mask
    from repro_torch.data import partition_iid, synthetic_images
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.models import small

    n_train, n_test, rounds = 3000, 800, 3
    x, y = synthetic_images(0, n_train + n_test, n_classes=10, noise=0.45)
    cx, cy, nk = partition_iid(x[:n_train], y[:n_train], k=10, seed=0)
    xt, yt = x[n_train:], y[n_train:]
    params = small.init_lenet(0, device=dev)
    opt = optim.sgd(0.05, weight_decay=1e-3, wd_mask=weight_decay_mask(params),
                    trust_mask=clip_value_mask(params))
    cfg = FedConfig(n_clients=10, participation=0.3, local_steps=10, batch_size=32,
                    comm_mode="rand", qat=QATConfig())
    sim = FedSim(params, small.make_loss(small.apply_lenet), small.apply_lenet, opt,
                 cfg, cx, cy, nk, device=dev)
    check(sim.bytes_per_round == SLICE_ROUND_BYTES,
          f"bytes_per_round {sim.bytes_per_round} != {SLICE_ROUND_BYTES}")

    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    hist = sim.run(rounds, seed=0, eval_data=(xt, yt), eval_every=rounds)
    synchronize()
    t_run = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)

    t0 = time.perf_counter()
    sim.evaluate(xt, yt)
    synchronize()
    t_eval = time.perf_counter() - t0
    acc = hist.accuracy[-1]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    check(hist.cumulative_bytes == [rounds * SLICE_ROUND_BYTES],
          f"cumulative bytes {hist.cumulative_bytes}")
    check(all(math.isfinite(v) for v in hist.loss), f"loss {hist.loss}")
    for leaf in sim.params.values():
        for v in leaf.values():
            check(bool(torch.isfinite(v).all()), "non-finite parameter")
    s_round = (t_run - t_eval) / rounds
    print(f"[main] cifar10-lenet uq K=10 P=3 U=10 B=32: {rounds} rounds, "
          f"{s_round:.3f} s/round (eval {t_eval:.3f} s), accuracy {acc:.4f}, "
          f"local_loss {hist.loss[-1]:.4f}, bytes/round {sim.bytes_per_round}, "
          f"launches {launches}")
    profile_round(sim, s_round)
    return {"launches": launches, "s_per_round": s_round, "accuracy": acc}


def profile_round(sim, s_round: float) -> None:
    """One more round of the same simulation under ``torch.profiler``: the
    device's busy time and the kernels that take it, by self device time.
    The profiler slows the host many times over, so the busy share is given
    against the unprofiled round time ``s_round`` as well as against the
    profiled wall. Informational; nothing here is checked."""
    from torch.profiler import ProfilerActivity, profile

    synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sim.run(1, seed=1)
        synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy = sum(dev_time(e) for e in rows)
    print(f"[profile] one round: device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (s_round * 1e6):.1f}% of the unprofiled {s_round * 1e3:.1f} ms "
          f"round ({100 * busy / wall_us:.1f}% of the profiled wall "
          f"{wall_us / 1e3:.1f} ms), {len(rows)} kernel names")
    for e in sorted(rows, key=dev_time, reverse=True)[:12]:
        print(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    ours = ("quant_det_kernel", "quant_det_bwd_kernel", "sum_partials_kernel",
            "quant_pack_kernel", "unpack_kernel")
    for e in rows:
        if e.key.startswith(ours):
            print(f"[profile] ours: {e.key.split('(')[0]:22s} x{e.count:<5d} "
                  f"{dev_time(e) / max(e.count, 1):.2f} us of device time per launch")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import fp8_quant as K

    smi = smi_name_and_power()
    print(f"[setup] {smi}")
    print(f"[setup] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh = not K.library_path().exists()
    t0 = time.perf_counter()
    K.build(verbose=True)
    K.load()
    print(f"[setup] kernels {'built' if fresh else 'found already built'} and "
          f"loaded in {time.perf_counter() - t0:.2f} s")

    dev = torch.device("cuda")
    kern = kernel_phase(dev)
    round_phase(dev)
    main = main_path_phase(dev)

    sources = {"quant_det": "quant_det.cu", "quant_det_bwd": "quant_det_bwd.cu",
               "quant_pack_tiles": "quant_pack.cu", "unpack_tiles": "unpack.cu"}
    replaces = {"quant_det": 92, "quant_det_bwd": 198, "quant_pack_tiles": 614,
                "unpack_tiles": 1036}
    rows = []
    for name in K.KERNELS:
        t = kern["timings"][name]["main"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{sources[name]}",
            "replaces": f"src/repro/kernels/fp8_quant.py:{replaces[name]}",
            "launches": main["launches"][name],
            "max_abs_err": kern["worst"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
            "large": kern["timings"][name]["large"],
        })
    print(f"[setup] {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
