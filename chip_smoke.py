#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

Run from the repository root:  python3 chip_smoke.py

Phases, each fatal on failure (the script then exits non-zero):

1. set-up: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit (``nvidia-smi``); turns TF32 off for matmuls and cuDNN
   convolutions; builds the nineteen CUDA kernels from ``src/repro_torch/
   kernels/csrc`` (``nvcc``, one process per source, at first use) and
   prints the build time.
2. the premise of B1/B2's scale table, log2f non-decreasing over all 2^31
   f32 patterns from +0 to FLT_MAX (``log2f_phase``, one launch); then
   each kernel against its plain PyTorch twin on the card, at the shapes
   of every path driven below (the Table 1 models: cifar10-lenet,
   cifar100-mlp, speech-kwt, and phase 9's cifar10-resnet and
   speech-matchbox, whose 175- and 62-row planes the wire kernels and B5
   take): the QAT pair at every QAT site shape of each
   model at batch 32 (random inputs; ``ACT_SHAPES`` and the weights), on
   each model's init weights and a batch of its data at their own clip
   values, at a multi-block ragged (8191, 1024), at odd lengths (1, 7, 8,
   9, 4097, 2^21 + 3) and on views 1-7 elements into their storage, x and g
   misaligned differently (``qat_pair_edge_cases``; E5M2 and both FP4
   formats at 2^21 + 3), a second B2 call bitwise equal to the first; the wire pair and
   ``fake_quant_tiles`` (det and counter-RNG, alpha as a column and per
   element) on random tiles at each model's plane/wire shape and at
   (8191, 1024), and on each model's real plane (its init weights with
   their own alpha column), ``fake_quant_tiles`` also against the wire's
   encode -> decode (1 f32 ULP); the ``quant_rand`` pair at every model's
   weights, every MLP weight shape and (8191, 1024), with u32 bits read
   from memory and with a counter key (bits drawn in the kernel), and two
   backward calls bitwise equal; the FP4 pair
   (``quant_pack_sub_tiles``, ``unpack_sub_tiles``) and the amax encodes
   (``quant_pack_amax_tiles``, ``quant_pack_sub_amax_tiles``) at both FP4
   formats (and E4M3/E5M2 for the FP8 amax encode), det and counter-RNG,
   alpha as a column and per element, on random tiles and on the real
   planes of the format ablation's MLP (9, 1024) and of LeNet (135, 1024)
   and at (8191, 1024): codes bitwise, the amax encodes' codes equal to the
   plain encodes' and their row max equal to ``torch.amax(|x|)``, the FP4
   transit within 1 f32 ULP of ``fake_quant_tiles`` at the FP4 format; the
   batched entries as the paths launch them (``cohort_launch_cases``): B8's
   cohort encode ``quant_pack_sub_many`` and cohort decode
   ``unpack_sub_many`` (P = 3) on the format MLP's and LeNet's real planes,
   both FP4 formats, det and rand, alpha as a column and per element; B9's
   cohort amax encode ``quant_pack_amax_many`` (P = 3, E4M3 and E2M1, one
   slice of clips expanded over the cohort, as the scaled uplink launches
   it) on the same planes; and B5's clip search ``fake_quant_many`` (G =
   20) on each Table 1 model's real plane at its grid's clip columns, det
   and rand; each bitwise its twin and the P (G) single launches, one
   launch a call, a second call bitwise the first.
   Bitwise (B1 in f32 with at most 1e-5 of elements allowed to differ,
   adjacent-grid ties; the wire pair exactly), and each scalar
   clip cotangent at relative 1e-5 with a cotangent signed like x. Then the rANS pair (B12
   ``rans_decode`` and the encode, ``rans_kernel_phase``) on the real code
   streams of the format MLP and of LeNet (E4M3 and FP4, plain and delta,
   each against its table), on cohorts of three real uplink streams in one
   launch each way and on corrupted streams whose lanes read clipped
   positions: buffers, states, lengths and symbols bitwise against the
   twins; at 8191 x 1024 symbols decode(encode(s)) == s. Prints each
   kernel's median time (CUDA events) beside its plain twin's and its bound
   (bytes over 3.35 TB/s, or operations over the card's f32 rate, the
   larger; for the rANS pair also the chain bound, rows times one row's
   dependent chain timed alone).
3. the card against the CPU twins: one small federated round with the same
   draws (``round_phase``; MLP uq, LeNet with weight QAT, LeNet with full
   QAT, MLP uq+, MLP rand-qat): exact bytes, params and loss within the
   tolerances stated there; also an MLP round with FP4 and delayed scaling
   on both legs, and one with an FP4 downlink and a delta:FP4 uplink.
4. the main paths, each driven with every launch counter zeroed just
   before and read just after: ``FedSim`` on cifar10-lenet (full-width
   LeNet) at the Table 1 driver's CPU-budget scale (K=10, C=0.3 (P=3), 10
   local steps at batch 32, 3000 train / 800 test examples), 3 rounds with
   eval at the end, for method uq (the four PR 11 kernels must launch) and
   method uq+ (five kernels; ``fake_quant_tiles`` exactly 6 times a round:
   5 GD steps + one launch for the 20 grid points, ``fake_quant_many``).
   ``bytes_per_round`` must be 826860 and the loss finite. The uq+ server step alone is timed, and one more round of
   each path is profiled; in every profiled round (here, in phases 5 and 6)
   each B2 call and each B6 call either way must be one CUDA kernel, and no
   ``sum_partials_kernel`` may run (a trace that lost records, fewer B1
   records than B1 calls, is taken again, at most three times).
5. the method grid: ``repro_torch.bench.table1`` on cifar10-lenet,
   cifar100-mlp and speech-kwt, iid and Dir(0.3), fp32/uq/uq+, at the
   reference driver's CPU-budget scale cut to 10 of its 20 rounds (eval
   every 5), which keeps the whole run well inside its limit; every
   ``bytes_per_round`` must be the reference's integer.
   Then the rand-qat / rand-qat-only cells of ``repro_torch.bench.table2``
   on cifar100-mlp at its default scale: the stochastic-QAT path, driven
   with the counters zeroed, where both ``quant_rand`` kernels must launch
   (each weight site's bits drawn inside them from its counter key).
6. the format ablation (run before phase 5): the ``format``, ``scaling``
   and ``pareto`` sections of ``repro_torch.bench.format_ablation`` at the
   reference's own scale (28 cells, 25 rounds, eval every 5), then four
   full-width cifar10-lenet cells at the Table 1 budget, 3 rounds each (FP4
   on both legs; FP4 down with a delta:FP4 uplink; E4M3 with delayed:4 on
   both legs; FP4 with delayed:4 on both legs), and the cifar10-lenet
   ``fp4|ef+rans`` cell (rANS FP4 down, ``ef:rans:fp4_e2m1_det`` up), 3
   rounds. Each cell is driven with the counters zeroed just before and read
   just after: its bytes per round must be the reference's integer (a
   pareto cell's bound; its measured bytes at most the bound with a rANS
   leg, equal without), the kernels of its codecs must launch (each rANS
   kernel exactly once an entropy-coded leg a round: the downlink's payload,
   then the cohort's uplink payloads in one launch; ``quant_pack_sub_tiles``
   exactly once an FP4 leg at current scaling a round and ``unpack_sub_tiles``
   once an FP4 leg a round: the downlink's plane, then the cohort's uplink
   planes in one launch; each amax encode once a delayed leg of its format a
   round, the cohort's uplink planes in one launch), the amax encodes must
   not launch where no leg is delayed, nor the rANS pair where no leg is
   entropy-coded. One round
   each of the FP4, the E4M3 delayed, the FP4 delayed and the ``fp4|ef+rans``
   LeNet cell is profiled, for the kernels' device time per launch.

7. federated LM fine-tuning on full-width TinyLlama-1.1B (run after phase
   4, before 6): B10 ``qat_matmul`` and both B11 kernels (``qat_matmul_dx``,
   ``qat_matmul_dw``) against their twins at every distinct projection
   shape of a local step and of the trainer at opt_level 0 (the port's init
   weights, activations of a real forward) and at a ragged (77, 130, 200):
   B10 and both B11 kernels (bf16 tensor cores) within the bar against the
   f64 product of the twin's quantized operands (their worst error at most
   4x the twin's own, or 2^-20), gx and gw nonzero only where that masked
   product is (every masked element zero), clip cotangents within GA_RTOL,
   each call bitwise equal to a second one; each timed beside its twin,
   ``torch.matmul`` on the pre-quantized operands and its bound; then every
   dx and dw call of one real full-width local step, its clip cotangent
   within max(4x the twin's, 2^-20) of its terms' magnitude sum from the f64
   one (``ref.clip_within_bar``) (``lm_kernel_phase``, right after phase
   2); the FP8 wire pair at the LM cell's own wire plane (1074176 x 1024:
   full-width TinyLlama-1.1B's init weights with the per-element clips its
   encode hands the kernels, and their column), det and counter-RNG, codes
   and values bitwise against the twins in row chunks, two calls equal,
   one launch a call, each timed beside its bytes bound
   (``lm_wire_phase``); one reduced-TinyLlama local
   step on the card against the CPU
   twins (``lm_card_vs_cpu_phase``, after phase 3); then
   ``repro_torch.bench.fed_lm`` at the example's defaults for 2 rounds, the
   counters zeroed just before and read just after: 8802606752 wire bytes a
   round, 5184 launches of each B10/B11 kernel a round, 5 of each wire
   kernel, a finite loss; prints s/round, the peak device memory and the
   profiled second round's device busy, with the device us a launch of
   B10/B11 and of the wire pair (``lm_main_path_phase``).
8. the one-device LM trainer (``repro_torch.launch.train``): B7
   ``quant_det_tiles`` / ``quant_det_tiles_bwd`` against their twins at the
   full-width TinyLlama-1.1B plane (1,074,176 x 1024), the reduced model's
   plane and a ragged plane of stacked segments (out and gx bitwise, each
   row's clip cotangent within GA_RTOL of its terms' magnitude sum), B9
   ``fake_quant_amax_tiles`` (det and counter-RNG, alpha column and per
   element, at (135, 1024) and (8191, 1024): values bitwise against its
   twin and B5, row max equal to the twin's and ``torch.amax``) and the
   bf16 B1/B2 instances at the
   trainer's activation shapes, odd lengths and misaligned views, each
   timed beside its twin and bound, with ``qat_probe.py``'s copy and
   arithmetic probes and SASS counts (what bounds them)
   (``trainer_kernel_phase``, after phase 7's kernels); a reduced-TinyLlama
   train step on the card against the CPU twins at opt_level 1, 0 and 2
   (``trainer_card_vs_cpu_phase``, after phase 3) and B9's only caller,
   ``dispatch.fake_quant_amax_plane``, once on LeNet's plane and once more
   profiled (``b9_path_phase``); then, last before phase 6, ``launch.train`` at the
   reference's defaults (full-width TinyLlama-1.1B, batch 8 x 128, AdamW
   3e-4, opt_level 1) for 20 steps with the counters zeroed just before and
   read just after: one B7 forward and one backward a step, B1/B2 at every
   activation site (162 a step), no B10/B11, finite losses; s/step,
   tokens/s, peak memory, one profiled step (B1/B2 device us a launch, one
   kernel a B2 call); then 2 steps at opt_level 0:
   B10/B11 at every projection, no B7 (``trainer_main_path_phase``).

9. the paths of the paper's other two models and the two small drivers
   (``paper_phase``, after phase 5), each driven with the counters zeroed
   just before and read just after: ``repro_torch.bench.table1`` on
   cifar10-resnet and speech-matchbox (iid and Dir(0.3) x fp32/uq/uq+, at
   5 of the driver's 20 rounds, ``PAPER_GRID_ROUNDS``, eval every 5), every
   row's bytes the reference's integer
   (``GRID_BYTES``); one more cifar10-resnet uq+ round timed and profiled
   (s/round, device busy, device us a launch of B1-B5 at ResNet's shapes,
   the B3/B4 route its 175-row wire plane takes); one round of each new
   model on the card against the same round on the CPU twins at the FP8-tie
   bars (ROADMAP section 3, mechanism 7), the clip values and the other
   leaves that are not quantized weights each held to ``PAPER_LEAF_BARS``;
   ``repro_torch.bench.quickstart``
   at its 40 rounds and ``repro_torch.bench.fig2`` at the reference driver's
   CPU-budget scale, their bytes the reference's integers
   (``QUICKSTART_BYTES``, ``FIG2_BYTES``), accuracy and wall printed.

Before the JSON lines, two ``[launches]`` lines: each wire kernel's launches
(the FP8 and FP4 pairs, B5 and the three amax encodes) summed over every
path of phases 4-8, and by path, each total ``WIRE_LAUNCH_TOTALS``'; then
the same over phase 9's paths (not asserted). The second-to-last line is a JSON object
with one entry per kernel (its launches counted on the path that runs it;
B1/B2 and the wire kernels also over every path of phases 4-8); the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
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
GA_RTOL = 1e-5                  # scalar clip cotangent, kernel vs twin
SLICE_ROUND_BYTES = 826860      # 3 clients x 2 legs x 137810-byte payloads
UQP_LAUNCHES_PER_ROUND = 6      # fake_quant_tiles: 5 GD steps + 1 for the 20 grid points
# the reference's bytes per round (benchmarks/common.py at K=10, C=0.3 for
# Table 1 and K=12, C=0.3 for Table 2)
GRID_BYTES = {
    ("cifar10-lenet", "fp32"): 3286560, ("cifar10-lenet", "uq"): 826860,
    ("cifar10-lenet", "uq+"): 826860, ("cifar100-mlp", "fp32"): 355824,
    ("cifar100-mlp", "uq"): 93168, ("cifar100-mlp", "uq+"): 93168,
    ("speech-kwt", "fp32"): 2606376, ("speech-kwt", "uq"): 722856,
    ("speech-kwt", "uq+"): 722856,
    # the paper's ResNet (175658 params) and MatchboxNet (63091), phase 9
    ("cifar10-resnet", "fp32"): 4215792, ("cifar10-resnet", "uq"): 1081488,
    ("cifar10-resnet", "uq+"): 1081488, ("speech-matchbox", "fp32"): 1514184,
    ("speech-matchbox", "uq"): 396744, ("speech-matchbox", "uq+"): 396744,
}
PAPER_TASKS = ("cifar10-resnet", "speech-matchbox")   # phase 9's Table 1 cells
PAPER_GRID_ROUNDS = 5   # of bench.table1's 20 rounds (at 10, phase 9 took 275 s on an H100)
PAPER_PLANE_ROWS = {"cifar10-resnet": 175, "speech-matchbox": 62}
# phase 9's card-vs-CPU uq round of each new model: the worst absolute
# difference allowed on a clip value and on any other leaf that is not a
# quantized weight (biases, GroupNorm), about twice the worst seen on an
# H100 (1.24e-5 and 5.03e-3 for ResNet, whose GroupNorms carry the f32
# noise of the cuDNN convolutions; 4.77e-7, one ULP, and 2.17e-4 for
# MatchboxNet)
PAPER_LEAF_BARS = {"resnet": (2.5e-5, 1e-2), "matchbox": (1e-6, 5e-4)}
# the reference's bytes per round of examples/quickstart.py (MLP d_in 32, K=20,
# C=0.25) and of benchmarks/fig2_curves.py's methods (cifar100-mlp, K=10, C=0.3)
QUICKSTART_BYTES = {"FP32 FedAvg": 277120, "FP8FedAvg-UQ": 73600}
FIG2_BYTES = {"fp32": 355824, "bq": 93168, "uq": 93168, "uq+": 93168}
TABLE2_BYTES = {"rand-qat": 124224, "rand-qat-only": 474432}
GRID_ROUNDS, GRID_EVAL_EVERY = 10, 5    # 10 of the reference driver's 20 CPU-budget rounds
# the reference's bytes per round of the format ablation's cells (MLP d_in 64,
# 10 classes, K=10, C=0.3), and of the cifar10-lenet format cells (K=10, C=0.3)
FORMAT_BYTES = {
    "fp32": 215424,
    **{f"{c}|{r}": 56448 for c in ("e4m3", "e5m2") for r in ("rand", "det")},
    **{f"{c}|{r}": 29952 for c in ("fp4_e2m1", "fp4_e3m0") for r in ("rand", "det")},
    "delta:e4m3|rand": 56484, "delta:e4m3|det": 56484,
    "delta:fp4_e2m1|rand": 29988, "delta:fp4_e2m1|det": 29988,
    "e4m3|rand|current": 56448, "e4m3|rand|delayed:4": 56520,
    "e4m3|rand|delayed:16:1": 56520, "e4m3|rand|frozen_down": 56412,
    "e4m3|rand|frozen_down+delayed_up": 56448,
}
LENET_FORMAT_CELLS = (   # (label, FedConfig overrides, bytes per round)
    ("fp4_e2m1", dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1"), 416910),
    ("fp4_e2m1 + delta:fp4_e2m1 up", dict(down_codec="fp4_e2m1", up_codec="delta:fp4_e2m1"),
     416970),
    ("e4m3 delayed:4", dict(down_scaling="delayed:4", up_scaling="delayed:4"), 826980),
    ("fp4_e2m1 delayed:4", dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1",
                                down_scaling="delayed:4", up_scaling="delayed:4"), 417030),
)
FORMAT_ROUNDS = 3       # of each cifar10-lenet format cell
PROFILED_IN = {   # kernel: (the profiled LeNet cell that runs it, its CUDA name)
    "quant_pack_sub_tiles": ("fp4_e2m1", "quant_pack_sub_kernel<2, true, true>"),
    "unpack_sub_tiles": ("fp4_e2m1", "unpack_sub_kernel<2, true>"),
    "quant_pack_amax_tiles": ("e4m3 delayed:4", "quant_pack_amax_kernel<1, true, true>"),
    "quant_pack_sub_amax_tiles": ("fp4_e2m1 delayed:4", "quant_pack_amax_kernel<2, true, true>"),
}
FORMAT_KERNELS = ("quant_pack_sub_tiles", "unpack_sub_tiles", "quant_pack_amax_tiles",
                  "quant_pack_sub_amax_tiles")
KERNEL_INFO = {   # name: (source under csrc/, file:line of the TPU kernel in src/repro/kernels)
    "quant_det": ("quant_det.cu", "fp8_quant.py:92"),
    "quant_det_bwd": ("quant_det_bwd.cu", "fp8_quant.py:198"),
    "quant_pack_tiles": ("quant_pack.cu", "fp8_quant.py:614"),
    "unpack_tiles": ("unpack.cu", "fp8_quant.py:1036"),
    "fake_quant_tiles": ("fake_quant.cu", "fp8_quant.py:455"),
    "quant_rand": ("quant_rand.cu", "fp8_quant.py:115"),
    "quant_rand_bwd": ("quant_rand.cu", "fp8_quant.py:231"),
    "quant_pack_sub_tiles": ("quant_pack_sub.cu", "fp8_quant.py:736"),
    "unpack_sub_tiles": ("unpack.cu", "fp8_quant.py:777"),
    "quant_pack_amax_tiles": ("quant_pack_amax.cu", "fp8_quant.py:900"),
    "quant_pack_sub_amax_tiles": ("quant_pack_amax.cu", "fp8_quant.py:944"),
    "rans_decode": ("rans.cu", "rans.py:187"),
    # no TPU kernel, so it replaces none; it mirrors the reference's lax.scan encode
    "rans_encode": ("rans.cu", None),
    "qat_matmul": ("qat_matmul.cu", "fp8_matmul.py:54"),
    "qat_matmul_dx": ("qat_matmul.cu", "fp8_matmul.py:172"),
    "qat_matmul_dw": ("qat_matmul.cu", "fp8_matmul.py:222"),
    "quant_det_tiles": ("quant_det_tiles.cu", "fp8_quant.py:529"),
    "quant_det_tiles_bwd": ("quant_det_tiles.cu", "fp8_quant.py:553"),
    "fake_quant_amax_tiles": ("fake_quant.cu", "fp8_quant.py:987"),
}
MIRRORS = {"rans_encode": "src/repro/kernels/rans.py:81"}
RANS_KERNELS = ("rans_encode", "rans_decode")
# the reference's static bounds per round of the ablation's pareto cells (MLP
# d_in 64, 10 classes, K=10, C=0.3), and of the cifar10-lenet fp4|ef+rans cell
PARETO_BYTES = {
    "e4m3|plain": 56448, "e4m3|delta": 56484, "e4m3|ef": 56448, "e4m3|rans": 110244,
    "e4m3|ef+rans": 110208, "fp4|plain": 29952, "fp4|delta": 29988, "fp4|ef": 29952,
    "fp4|rans": 57252, "fp4|ef+rans": 57216,
}
LENET_PARETO_CELL = ("fp4|ef+rans", dict(down_codec="rans:fp4_e2m1",
                                         up_codec="ef:rans:fp4_e2m1_det"), 827760)


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


def time_ms(fn, reps: int = 7, iters: int = 50, warmup: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
    for _ in range(warmup):
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


# QAT site input shapes at batch 32 of each Table 1 task's model, in call
# order (the weight sites are read from the params): LeNet's conv/dense
# inputs; cifar100-mlp's (d_in 64, hidden 64, so every site takes (32, 64));
# KWT's embed input (B, T, F), its per-layer qkv / proj / fc1 inputs over the
# T+1 tokens, its fc2 input (4 d_model wide) and the head's class token
ACT_SHAPES = {
    "cifar10-lenet": [(32, 32, 32, 3), (32, 16, 16, 6), (32, 1024), (32, 120), (32, 84)],
    "cifar100-mlp": [(32, 64)],
    "speech-kwt": [(32, 32, 64), (32, 33, 64), (32, 33, 256), (32, 64)],
}
# the same for phase 9's models (``paper_kernel_cases``, its own generator):
# ResNet's stem input, each stage's block inputs (a stride-2 conv and its
# projection read the previous stage's), the head's pooled input;
# MatchboxNet's every conv's (B, T, C) input, the head's pooled input
PAPER_ACT_SHAPES = {
    "cifar10-resnet": [(32, 32, 32, 3), (32, 32, 32, 16), (32, 16, 16, 32), (32, 8, 8, 64),
                       (32, 64)],
    "speech-matchbox": [(32, 32, 64), (32, 64)],
}
LARGE = (8191, 1024)    # a multi-block ragged shape


QAT_EDGE_N = (1, 7, 8, 9, 4097, 2 ** 21 + 3)
QAT_MISALIGN = ((1, 3), (5, 0), (0, 7), (6, 2))   # storage offsets of x and g, elements


def qat_pair_edge_cases(dev, dtype, worst) -> int:
    """B1/B2 against their twins where the vector path does not reach: odd
    n (a lone element, the ragged head and tail) and views whose storage
    offsets are 1-7 elements, x and g misaligned differently (the
    one-element path throughout), in ``dtype``; at 2^21 + 3 elements (the
    scale table's route) also E5M2 and both FP4 formats. out and gx bitwise
    (f32 B1 within TIE_FRAC), g_alpha within GA_RTOL with a cotangent signed
    like x, and a second call bitwise equal to the first. Returns the
    number of cases."""
    from repro_torch.core.fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R

    gen = torch.Generator().manual_seed(31)
    cases = [(n, 0, 0, E4M3) for n in QAT_EDGE_N]
    cases += [(n, ox, og, E4M3) for ox, og in QAT_MISALIGN for n in (4097, 2 ** 21 + 3)]
    cases += [(2 ** 21 + 3, 0, 0, fmt) for fmt in (E5M2, FP4_E2M1, FP4_E3M0)]
    for n, ox, og, fmt in cases:
        bx = (torch.randn(n + 8, generator=gen) * 1.5).to(dev).to(dtype)
        bg = torch.randn(n + 8, generator=gen).abs().to(dev).to(dtype)
        x = bx[ox:ox + n]
        gr = bg[og:og + n]
        gr.mul_(torch.sign(x))
        a = x.float().abs().max() * 0.8
        label = f"{dtype} n={n} offsets {ox}/{og} {fmt}"
        out = K.quant_det(x, a, fmt)
        bad, err = mismatches(out, R.quant_det(x, a, fmt))
        worst["quant_det"] = max(worst["quant_det"], err)
        tie = TIE_FRAC * n if dtype == torch.float32 else 0
        check(bad <= tie and out.dtype == dtype, f"quant_det {label}: {bad} differ")
        gx, ga = K.quant_det_bwd(x, a, gr, fmt)
        rgx, rga = R.quant_det_bwd(x, a, gr, fmt)
        bad, err = mismatches(gx, rgx)
        worst["quant_det_bwd"] = max(worst["quant_det_bwd"], err, abs(float(ga) - float(rga)))
        rel = abs(float(ga) - float(rga)) / max(abs(float(rga)), 1e-30)
        check(bad == 0 and gx.dtype == dtype, f"quant_det_bwd gx {label}: {bad} differ")
        check(rel <= GA_RTOL, f"quant_det_bwd g_alpha {label}: rel err {rel:.3g}")
        gx2, ga2 = K.quant_det_bwd(x, a, gr, fmt)
        check(torch.equal(gx2, gx) and torch.equal(ga2, ga),
              f"quant_det_bwd {label}: two calls differ")
    print(f"[kernels] quant_det/bwd {dtype}: {len(cases)} edge cases (n {QAT_EDGE_N}, "
          f"offsets {QAT_MISALIGN}, E5M2/E2M1/E3M0 at 2^21 + 3) bitwise, g_alpha within "
          "GA_RTOL and equal between two calls")
    return len(cases)


def log2f_phase(dev) -> dict:
    """The premise of B1/B2's scale table: log2f non-decreasing over all
    2^31 f32 patterns from +0 to FLT_MAX on this card (qat_probe.py)."""
    import qat_probe
    from repro_torch.kernels import fp8_quant as K

    r = qat_probe.log2f_monotone(dev, K)
    check(r["decreases"] == 0, f"log2f decreases {r['decreases']} times, first at "
          f"pattern {r['first'] or 0:#010x}: the scale table's thresholds do not hold")
    print(f"[kernels] log2f non-decreasing over all {r['patterns']} patterns from +0 to "
          f"FLT_MAX ({r['ms']:.2f} ms, one launch)")
    return r


def kernel_phase(dev) -> dict:
    from repro_torch import tree
    from repro_torch.bench import common
    from repro_torch.core import plane, wire
    from repro_torch.core.fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R
    from repro_torch.models import small

    g = torch.Generator(device="cpu").manual_seed(0)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    def rbits(shape):
        return torch.randint(0, 2 ** 32, shape, generator=g, dtype=torch.int64).to(
            torch.int32).view(torch.uint32).to(dev)

    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    worst = {k: 0.0 for k in K.KERNELS}
    # per task: the QAT pair's cases (random inputs at every site shape, the
    # init weights at their own alpha = max|w|, one element on the clip
    # boundary, and a batch of the task's data at the first site's init
    # beta), the quant_rand pair's weight cases, and the real tiled plane
    # (the UQ+ plane, which is also the wire's tiles) with its alpha column
    qat_cases, rand_cases, planes = [], [], []
    for task_name, acts in ACT_SHAPES.items():
        task = common.TASKS[task_name]
        params, _ = common.make_model(task, 0, dev)
        flat = dict(tree.flatten(params))
        weights = [(name, w, flat[name + "_qa"]) for name, w in flat.items()
                   if name.endswith(".w") and name + "_qa" in flat]
        for s in acts + [tuple(w.shape) for _, w, _ in weights]:
            qat_cases.append((f"{task_name} random", randn(s, 0.3), None))
        for name, w, a in weights:
            qat_cases.append((f"{task_name} {name}", w, a))
            rand_cases.append((f"{task_name} {name}", w, a))
        data = torch.from_numpy(common.make_data(task, 32, 1)[0][0]).to(dev)
        first = next(v for v in params.values() if isinstance(v, dict) and "x_qb" in v)
        qat_cases.append((f"{task_name} data", data, first["x_qb"]))
        spec, wspec = plane.make_plane_spec(params), wire.make_wire_spec(params)
        # scalar alphas: the wire's tiles and (R, 1) column are the plane's
        check(wspec.alpha_cols_ok and wspec.n_rows == spec.n_rows
              and wspec.q_names == spec.q_names, f"{task_name}: wire tiles != plane")
        w2, alphas = plane.pack_tiles(params, spec)
        planes.append((f"{task_name} plane", w2, plane.alpha_column(alphas, spec)))
        print(f"[kernels] {task_name}: {len(weights)} weight sites, activation shapes "
              f"{acts}, plane/wire tiles {tuple(w2.shape)} in {spec.n_seg} segments")
    qat_cases.append(("random", randn(LARGE, 0.3), None))

    for label, x, a in qat_cases:
        # cotangent with the sign of x: the clipped terms of g_alpha then add
        # up instead of cancelling, so relative error measures the kernel
        qat_pair_case(K, R, label, x, a, randn(tuple(x.shape), 1.0).abs() * torch.sign(x),
                      worst)

    qat_pair_edge_cases(dev, torch.float32, worst)

    # the tile kernels: random tiles at every task's plane/wire shape and at
    # the large shape (alpha a row-max column), then each task's real plane
    # with its own alpha column; alpha also per element, det and counter-RNG.
    # The wire pair and fake_quant_tiles (B5) bitwise against their twins,
    # B5 within 1 f32 ULP of encode -> decode.
    tile_cases = []
    for shape in [tuple(w2.shape) for _, w2, _ in planes] + [LARGE]:
        x = randn(shape, 0.2)
        tile_cases.append(("random", x, x.abs().amax(dim=1, keepdim=True) * 0.9))
    tile_cases += planes
    for label, x, col in tile_cases:
        tile_case(K, R, label, x, col, key, worst)

    # the quant_rand pair (B6): every task's init weights at their own alpha,
    # random inputs at every MLP weight shape (cifar100-mlp, and the d_in 32
    # MLP of the card-vs-CPU rounds) and at the large shape; each with u32
    # bits read from memory and with a counter key (its words and site drawn
    # from the seed), whose bits the kernels draw themselves
    rand_cases += [("random", randn(s, 0.3), None)
                   for s in ((32, 64), (64, 64), (64, 10), (64, 100), LARGE)]
    for label, x, a in rand_cases:
        shape = tuple(x.shape)
        gr = randn(shape, 1.0).abs() * torch.sign(x)
        a = x.abs().max() * 0.8 if a is None else a
        site = int(torch.randint(1, 1 << 20, (), generator=g))
        for route, bits in (("bits", rbits(shape)), ("counter", R.CounterKey(rbits((2,)), site))):
            bad, err = mismatches(K.quant_rand(x, a, bits), R.quant_rand(x, a, bits))
            worst["quant_rand"] = max(worst["quant_rand"], err)
            check(bad == 0, f"quant_rand {route} {label} {shape}: {bad} differ")
            gx, ga = K.quant_rand_bwd(x, a, bits, gr)
            rgx, rga = R.quant_rand_bwd(x, a, bits, gr)
            bad, err = mismatches(gx, rgx)
            rel = abs(float(ga) - float(rga)) / max(abs(float(rga)), 1e-30)
            worst["quant_rand_bwd"] = max(worst["quant_rand_bwd"], err,
                                          abs(float(ga) - float(rga)))
            check(bad == 0, f"quant_rand_bwd {route} gx {label} {shape}: {bad} differ")
            check(rel <= GA_RTOL,
                  f"quant_rand_bwd {route} g_alpha {label} {shape}: rel err {rel:.3g}")
            gx2, ga2 = K.quant_rand_bwd(x, a, bits, gr)
            check(torch.equal(gx2, gx) and torch.equal(ga2, ga),
                  f"quant_rand_bwd {route} {label} {shape}: two calls differ")
            print(f"[kernels] quant_rand/bwd {route} {label} {shape}: g_alpha kernel "
                  f"{float(ga):.9g} twin {float(rga):.9g} rel {rel:.3g}")

    # the FP4 pair and the amax encodes (B8, B9): random tiles at the format
    # ablation MLP's plane (9, 1024), LeNet's (135, 1024) and the large shape,
    # each with an odd-length tail, and the two real planes with their own
    # alpha columns; both FP4 formats (and E4M3/E5M2 for the FP8 amax encode),
    # det and counter-RNG, alpha as a column and per element
    mlp = small.init_mlp(0, d_in=64, n_classes=10, device=dev)
    spec = plane.make_plane_spec(mlp)
    w2, alphas = plane.pack_tiles(mlp, spec)
    format_planes = [("format-mlp plane", w2, plane.alpha_column(alphas, spec)),
                     next(pl for pl in planes if pl[0].startswith("cifar10-lenet"))]
    check(tuple(w2.shape) == (9, 1024), f"format MLP plane {tuple(w2.shape)}")
    fp4_cases = []
    for shape in ((9, 1024), (135, 1024), LARGE):
        x = randn(shape, 0.2)
        x[-1, 517:] = 0.0
        fp4_cases.append(("random", x, x.abs().amax(dim=1, keepdim=True) * 0.9))
    fp4_cases += format_planes
    n_cases = 0
    for label, x, col in fp4_cases:
        rowmax = torch.amax(x.abs(), 1, keepdim=True)
        for a2 in (col, col.expand(x.shape).contiguous()):
            for k2 in (None, key):
                for fmt in (E4M3, E5M2):
                    lab = f"{label} {tuple(x.shape)} a{tuple(a2.shape)} {fmt} {k2 is not None}"
                    c, m = K.quant_pack_amax_tiles(x, a2, k2, fmt)
                    bad, err = mismatches(c, R.quant_pack_tiles(x, a2, k2, fmt))
                    worst["quant_pack_amax_tiles"] = max(worst["quant_pack_amax_tiles"], err)
                    check(bad == 0, f"quant_pack_amax_tiles {lab}: {bad} codes differ")
                    check(torch.equal(c, K.quant_pack_tiles(x, a2, k2, fmt)),
                          f"quant_pack_amax_tiles {lab}: codes != quant_pack_tiles")
                    check(torch.equal(m, rowmax), f"quant_pack_amax_tiles {lab}: rowmax")
                for fmt in (FP4_E2M1, FP4_E3M0):
                    lab = f"{label} {tuple(x.shape)} a{tuple(a2.shape)} {fmt} {k2 is not None}"
                    c = K.quant_pack_sub_tiles(x, a2, k2, fmt)
                    bad, err = mismatches(c, R.quant_pack_sub_tiles(x, a2, k2, fmt))
                    worst["quant_pack_sub_tiles"] = max(worst["quant_pack_sub_tiles"], err)
                    check(bad == 0, f"quant_pack_sub_tiles {lab}: {bad} codes differ")
                    vals = K.unpack_sub_tiles(c, a2, fmt)
                    bad, err = mismatches(vals, R.unpack_sub_tiles(c, a2, fmt))
                    worst["unpack_sub_tiles"] = max(worst["unpack_sub_tiles"], err)
                    check(bad == 0, f"unpack_sub_tiles {lab}: {bad} values differ")
                    ca, m = K.quant_pack_sub_amax_tiles(x, a2, k2, fmt)
                    bad, err = mismatches(ca, R.quant_pack_sub_amax_tiles(x, a2, k2, fmt)[0])
                    worst["quant_pack_sub_amax_tiles"] = max(worst["quant_pack_sub_amax_tiles"],
                                                             err)
                    check(bad == 0 and torch.equal(ca, c),
                          f"quant_pack_sub_amax_tiles {lab}: codes differ")
                    check(torch.equal(m, rowmax), f"quant_pack_sub_amax_tiles {lab}: rowmax")
                    q = K.fake_quant_tiles(x, a2, k2, fmt)
                    aw = vals.abs()
                    ulp = torch.nextafter(aw, torch.full_like(aw, math.inf)) - aw
                    check(bool(((q - vals).abs() <= ulp).all()),
                          f"unpack_sub_tiles {lab}: not within 1 ULP of fake_quant_tiles")
                    n_cases += 1
        print(f"[kernels] FP4 pair and amax encodes {label} {tuple(x.shape)}: both FP4 "
              f"formats, E4M3/E5M2 amax, det and rand, alpha column and per element: ok")
    n_cases += cohort_launch_cases(dev, K, R, format_planes, planes, key, worst)
    n_cases += paper_kernel_cases(dev, K, R, key, worst)
    print(f"[kernels] all kernels within bound ({n_cases} FP4 cases); max abs err {worst}")
    synchronize()

    # --- times at the main paths' shapes, and at a large ragged shape ----
    timings = {}
    for label, shape in (("main", None), ("large", (8191, 1024))):
        act = shape or (32, 32, 32, 3)       # largest QAT site (conv1 input)
        tile = shape or (135, 1024)          # LeNet's wire tiles / UQ+ plane
        wshape = shape or (64, 100)          # largest rand-qat weight (cifar100-mlp)
        x, gr = randn(act, 0.3), randn(act, 1.0)
        a = x.abs().max() * 0.8
        xt = randn(tile, 0.2)
        col = xt.abs().amax(dim=1, keepdim=True) * 0.9
        codes = K.quant_pack_tiles(xt, col, key)
        xw, gw, bw = randn(wshape, 0.3), randn(wshape, 1.0), rbits(wshape)
        kw = R.CounterKey(rbits((2,)), 3)      # the main path's route: counter bits
        aw = xw.abs().max() * 0.8
        n, nt, rows, nw = x.numel(), xt.numel(), tile[0], xw.numel()
        codes4 = K.quant_pack_sub_tiles(xt, col, key)
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
            "fake_quant_tiles": (lambda: K.fake_quant_tiles(xt, col, key),
                                 lambda: R.fake_quant_tiles(xt, col, key),
                                 8 * nt + 4 * rows + 8, 40 * nt, tile),
            "quant_rand": (lambda: K.quant_rand(xw, aw, kw),
                           lambda: R.quant_rand(xw, aw, kw),
                           8 * nw + 12, 34 * nw, wshape),
            "quant_rand_bwd": (lambda: K.quant_rand_bwd(xw, aw, kw, gw),
                               lambda: R.quant_rand_bwd(xw, aw, kw, gw),
                               12 * nw + 16, 42 * nw, wshape),
            "quant_rand bits": (lambda: K.quant_rand(xw, aw, bw),
                                lambda: R.quant_rand(xw, aw, bw),
                                12 * nw + 4, 14 * nw, wshape),
            "quant_rand_bwd bits": (lambda: K.quant_rand_bwd(xw, aw, bw, gw),
                                    lambda: R.quant_rand_bwd(xw, aw, bw, gw),
                                    16 * nw + 8, 22 * nw, wshape),
            **format_timing_cases(K, R, xt, col, key, codes4),
        }
        for name, (kern, twin, n_bytes, n_ops, shp) in cases.items():
            ms, plain_ms = time_ms(kern), time_ms(twin, reps=5, iters=10)
            b_ms, b_by = bound(n_bytes, n_ops)
            timings.setdefault(name, {})[label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=list(shp))
            print(f"[time] {name:17s} {label:5s} {str(shp):18s} kernel {ms:.5f} ms  "
                  f"twin {plain_ms:.5f} ms  bound {b_ms:.6f} ms ({b_by})")
    # the batched launches at LeNet's plane, as the main paths launch them
    lenet = next(pl for pl in planes if pl[0].startswith("cifar10-lenet"))
    for name, (kern, twin, n_bytes, n_ops, shp) in cohort_timing_cases(
            K, R, lenet[1], lenet[2]).items():
        ms, plain_ms = time_ms(kern), time_ms(twin, reps=5, iters=10)
        b_ms, b_by = bound(n_bytes, n_ops)
        timings[name]["batched"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                        shape=list(shp))
        print(f"[time] {name:17s} batch {str(shp):18s} kernel {ms:.5f} ms  "
              f"twin {plain_ms:.5f} ms  bound {b_ms:.6f} ms ({b_by})")
    # the format path's kernels also at the format ablation MLP's plane
    xt = randn((9, 1024), 0.2)
    col = xt.abs().amax(dim=1, keepdim=True) * 0.9
    cases = format_timing_cases(K, R, xt, col, key, K.quant_pack_sub_tiles(xt, col, key))
    for name, (kern, twin, n_bytes, n_ops, shp) in cases.items():
        ms, plain_ms = time_ms(kern), time_ms(twin, reps=5, iters=10)
        b_ms, b_by = bound(n_bytes, n_ops)
        timings[name]["mlp"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                    shape=list(shp))
        print(f"[time] {name:17s} mlp   {str(shp):18s} kernel {ms:.5f} ms  "
              f"twin {plain_ms:.5f} ms  bound {b_ms:.6f} ms ({b_by})")
    return {"worst": worst, "timings": timings}


COHORT = 3       # clients of a cohort on the paths that run B8 (K = 10, C = 0.3)
UQP_GRID = 20    # grid points of the UQ+ clip search (bench/common.py's method grid)


def qat_pair_case(K, R, label, x, a, gr, worst) -> None:
    """B1 and B2 on ``x`` at clip ``a`` (None: 0.8 max|x|) under cotangent
    ``gr``, against their twins: B1 with at most TIE_FRAC of its elements
    apart (adjacent-grid ties), B2's gx bitwise, its clip cotangent within
    GA_RTOL."""
    shape = tuple(x.shape)
    a = x.abs().max() * 0.8 if a is None else a
    n = x.numel()
    bad, err = mismatches(K.quant_det(x, a), R.quant_det(x, a))
    worst["quant_det"] = max(worst["quant_det"], err)
    check(bad <= TIE_FRAC * n, f"quant_det {label} {shape}: {bad} of {n} differ")
    gx, ga = K.quant_det_bwd(x, a, gr)
    rgx, rga = R.quant_det_bwd(x, a, gr)
    bad, err = mismatches(gx, rgx)
    rel = abs(float(ga) - float(rga)) / max(abs(float(rga)), 1e-30)
    worst["quant_det_bwd"] = max(worst["quant_det_bwd"], err, abs(float(ga) - float(rga)))
    check(bad == 0, f"quant_det_bwd gx {label} {shape}: {bad} of {n} differ")
    check(rel <= GA_RTOL, f"quant_det_bwd g_alpha {label} {shape}: rel err {rel:.3g}")
    print(f"[kernels] quant_det/bwd {label} {shape}: g_alpha kernel {float(ga):.9g} "
          f"twin {float(rga):.9g} rel {rel:.3g}")


def tile_case(K, R, label, x, col, key, worst) -> None:
    """The wire pair and B5 on the tiles ``x`` at the alpha column ``col``
    and per element, det and rand (``key``): bitwise their twins, B5 within
    1 f32 ULP of the wire's encode -> decode."""
    for a2 in (col, col.expand(x.shape).contiguous()):
        for k2 in (None, key):
            lab = f"{label} a{tuple(a2.shape)} {'rand' if k2 is not None else 'det'}"
            c = K.quant_pack_tiles(x, a2, k2)
            bad, err = mismatches(c, R.quant_pack_tiles(x, a2, k2))
            worst["quant_pack_tiles"] = max(worst["quant_pack_tiles"], err)
            check(bad == 0, f"quant_pack_tiles {lab}: {bad} codes differ")
            wire_vals = K.unpack_tiles(c, a2)
            bad, err = mismatches(wire_vals, R.unpack_tiles(c, a2))
            worst["unpack_tiles"] = max(worst["unpack_tiles"], err)
            check(bad == 0, f"unpack_tiles {lab}: {bad} values differ")
            q = K.fake_quant_tiles(x, a2, k2)
            bad, err = mismatches(q, R.fake_quant_tiles(x, a2, k2))
            worst["fake_quant_tiles"] = max(worst["fake_quant_tiles"], err)
            check(bad == 0, f"fake_quant_tiles {lab}: {bad} values differ")
            aw = wire_vals.abs()
            ulp = torch.nextafter(aw, torch.full_like(aw, math.inf)) - aw
            check(bool(((q - wire_vals).abs() <= ulp).all()),
                  f"fake_quant_tiles {lab}: not within 1 ULP of the wire transit")
    print(f"[kernels] tile kernels {label} {tuple(x.shape)}: det and rand, "
          f"alpha column and per element: ok")


def paper_kernel_cases(dev, K, R, key, worst) -> int:
    """Phase 2's checks at phase 9's shapes, from a generator of their own
    (the earlier cases' draws stay as they were): for cifar10-resnet and
    speech-matchbox, B1/B2 at every QAT site shape (``PAPER_ACT_SHAPES``
    and the weights, random inputs), on the init weights at their own
    alpha and on a batch of the task's data at the first site's beta; the
    wire pair and B5 on random tiles at the model's plane shape and on its
    real plane (175 and 62 rows) with its own alpha column; B5's clip search
    (G = 20) on the real plane (``cohort_launch_cases``)."""
    from repro_torch import tree
    from repro_torch.bench import common
    from repro_torch.core import plane, wire

    g = torch.Generator().manual_seed(27)

    def randn(shape, scale):
        return (torch.randn(shape, generator=g) * scale).to(dev)

    planes = []
    for task_name, acts in PAPER_ACT_SHAPES.items():
        task = common.TASKS[task_name]
        params, _ = common.make_model(task, 0, dev)
        flat = dict(tree.flatten(params))
        weights = [(name, w, flat[name + "_qa"]) for name, w in flat.items()
                   if name.endswith(".w") and name + "_qa" in flat]
        cases = [(f"{task_name} random", randn(s, 0.3), None)
                 for s in acts + sorted({tuple(w.shape) for _, w, _ in weights})]
        cases += [(f"{task_name} {name}", w, a) for name, w, a in weights]
        data = torch.from_numpy(common.make_data(task, 32, 1)[0][0]).to(dev)
        cases.append((f"{task_name} data", data, params["stem"]["x_qb"]))
        for label, x, a in cases:
            qat_pair_case(K, R, label, x, a, randn(tuple(x.shape), 1.0).abs() * torch.sign(x),
                          worst)
        spec, wspec = plane.make_plane_spec(params), wire.make_wire_spec(params)
        check(wspec.alpha_cols_ok and wspec.n_rows == spec.n_rows == PAPER_PLANE_ROWS[task_name]
              and wspec.q_names == spec.q_names, f"{task_name}: wire tiles != plane")
        w2, alphas = plane.pack_tiles(params, spec)
        col = plane.alpha_column(alphas, spec)
        x = randn(tuple(w2.shape), 0.2)
        tile_case(K, R, f"{task_name} random", x, x.abs().amax(dim=1, keepdim=True) * 0.9, key,
                  worst)
        tile_case(K, R, f"{task_name} plane", w2, col, key, worst)
        planes.append((f"{task_name} plane", w2, col))
        print(f"[kernels] {task_name}: {len(weights)} weight sites, activation shapes {acts}, "
              f"plane/wire tiles {tuple(w2.shape)} in {spec.n_seg} segments")
    return cohort_launch_cases(dev, K, R, [], planes, key, worst)


def _perturbed_stack(x2, n):
    """``n`` copies of a plane, copy i scaled by 1 + 0.01 i (a cohort's
    uplink planes near one broadcast)."""
    return torch.stack([x2 * (1.0 + 0.01 * i) for i in range(n)])


def _grid_alphas(col, n):
    """``n`` clip columns from 0.5x to 1x ``col``, as Eq. 5's grid spans its
    interval: ``(n, R, 1)``."""
    return col[None] * torch.linspace(0.5, 1.0, n, device=col.device)[:, None, None]


def _one_launch(K, name: str, fn, lab: str):
    """``fn()``, checked to launch ``name`` exactly once."""
    before = K.LAUNCHES[name]
    out = fn()
    check(K.LAUNCHES[name] == before + 1, f"{lab}: not one launch")
    return out


def cohort_launch_cases(dev, K, R, format_planes, planes, key, worst) -> int:
    """The batched entries at every path's shapes: B8's cohort encode and
    decode (``quant_pack_sub_many``, ``unpack_sub_many``, P = 3) on the
    format MLP's and LeNet's real planes, both FP4 formats, det and rand,
    alpha as a column and per element; B9's cohort amax encode
    (``quant_pack_amax_many``, P = 3) on the same planes at E4M3 and E2M1,
    det and rand, one slice of clips (a column or per element) expanded
    over the cohort as the scaled uplink launches it; B5's clip search
    (``fake_quant_many``, G = 20) on each Table 1 model's real plane at its
    grid's clip columns, det and rand. Each bitwise its twin and the P (G)
    single launches, one launch a call; the decode and the amax encode also
    a second call bitwise the first."""
    import qat_probe
    from repro_torch.core.fp8 import E4M3, FP4_E2M1, FP4_E3M0

    n = 0
    for label, x2, col in format_planes:
        x3, c3 = _perturbed_stack(x2, COHORT), _perturbed_stack(col, COHORT)
        for a3 in (c3, c3.expand(x3.shape).contiguous()):
            for keys in (None, qat_probe.key_rows(COHORT, dev, 60)):
                ks = [None if keys is None else keys[i] for i in range(COHORT)]
                for fmt in (FP4_E2M1, FP4_E3M0):
                    lab = f"{label} cohort a{tuple(a3.shape)} {fmt} {keys is not None}"
                    c = _one_launch(K, "quant_pack_sub_tiles",
                                    lambda: K.quant_pack_sub_many(x3, a3, keys, fmt),
                                    f"quant_pack_sub_many {lab}")
                    bad, err = mismatches(c, R.quant_pack_sub_tiles_many(x3, a3, keys, fmt))
                    worst["quant_pack_sub_tiles"] = max(worst["quant_pack_sub_tiles"], err)
                    check(bad == 0, f"quant_pack_sub_many {lab}: {bad} codes differ")
                    check(all(torch.equal(c[i], K.quant_pack_sub_tiles(x3[i], a3[i], ks[i], fmt))
                              for i in range(COHORT)),
                          f"quant_pack_sub_many {lab}: != single launches")
                    v = _one_launch(K, "unpack_sub_tiles", lambda: K.unpack_sub_many(c, a3, fmt),
                                    f"unpack_sub_many {lab}")
                    bad, err = mismatches(v, R.unpack_sub_tiles_many(c, a3, fmt))
                    worst["unpack_sub_tiles"] = max(worst["unpack_sub_tiles"], err)
                    check(bad == 0, f"unpack_sub_many {lab}: {bad} values differ")
                    check(torch.equal(K.unpack_sub_many(c, a3, fmt), v)
                          and all(torch.equal(v[i], K.unpack_sub_tiles(c[i], a3[i], fmt))
                                  for i in range(COHORT)),
                          f"unpack_sub_many {lab}: != a second call or single launches")
                    n += 1
                a_one = a3[:1].expand(a3.shape)     # the scaled uplink's shared clips
                for fmt, name in ((E4M3, "quant_pack_amax_tiles"),
                                  (FP4_E2M1, "quant_pack_sub_amax_tiles")):
                    lab = f"{label} cohort a{tuple(a3.shape)} shared {fmt} {keys is not None}"
                    c, m = _one_launch(K, name, lambda: K.quant_pack_amax_many(x3, a_one, keys, fmt),
                                       f"quant_pack_amax_many {lab}")
                    wc, wm = R.quant_pack_amax_tiles_many(x3, a_one, keys, fmt)
                    bad, err = mismatches(c, wc)
                    worst[name] = max(worst[name], err)
                    check(bad == 0 and torch.equal(m, wm),
                          f"quant_pack_amax_many {lab}: {bad} codes differ, or the row max")
                    single = K.quant_pack_amax_tiles if fmt is E4M3 else K.quant_pack_sub_amax_tiles
                    again = K.quant_pack_amax_many(x3, a_one, keys, fmt)
                    check(torch.equal(again[0], c) and torch.equal(again[1], m)
                          and all(all(torch.equal(u, w) for u, w in zip(
                              single(x3[i], a_one[i], ks[i], fmt), (c[i], m[i])))
                              for i in range(COHORT)),
                          f"quant_pack_amax_many {lab}: != a second call or single launches")
        print(f"[kernels] quant_pack_sub_many / unpack_sub_many / quant_pack_amax_many {label} "
              f"({COHORT}, {x2.shape[0]}, 1024): both FP4 formats (E4M3 and E2M1 amax), det "
              f"and rand, alpha column and per element: ok")
    for label, w2, col in planes:
        a3 = _grid_alphas(col, UQP_GRID)
        for keys in (None, qat_probe.key_rows(UQP_GRID, dev, 61)):
            lab = f"{label} grid ({UQP_GRID}, {w2.shape[0]}) {keys is not None}"
            before = K.LAUNCHES["fake_quant_tiles"]
            q = K.fake_quant_many(w2, a3, keys)
            check(K.LAUNCHES["fake_quant_tiles"] == before + 1,
                  f"fake_quant_many {lab}: not one launch")
            bad, err = mismatches(q, R.fake_quant_tiles_many(w2, a3, keys))
            worst["fake_quant_tiles"] = max(worst["fake_quant_tiles"], err)
            check(bad == 0, f"fake_quant_many {lab}: {bad} values differ")
            check(all(torch.equal(q[i], K.fake_quant_tiles(
                w2, a3[i], None if keys is None else keys[i])) for i in range(UQP_GRID)),
                f"fake_quant_many {lab}: != single launches")
            n += 1
        print(f"[kernels] fake_quant_many {label} ({UQP_GRID}, {w2.shape[0]}, 1024): det and "
              f"rand: ok")
    return n


def cohort_timing_cases(K, R, x2, col) -> dict:
    """Timing cases of the batched launches at LeNet's plane ``x2`` (its
    alpha column ``col``), as the main paths launch them: B8's encode and
    decode and B9's amax encodes a cohort of 3 (the amax encode at one
    shared column, as the scaled uplink), B5 the 20 grid points; ``name:
    (kernel, twin, bytes, operations, shape)``. Bytes: x or codes read once
    (4 B or half a byte an element of each plane), codes written (half a
    byte or 1 B) or values (4 B an element a slice), the alphas (4 B a row a
    slice; the shared column once), the row maxima (4 B a row a slice) and
    the keys (8 B a slice)."""
    import qat_probe
    from repro_torch.core.fp8 import FP4_E2M1

    x3, c3 = _perturbed_stack(x2, COHORT), _perturbed_stack(col, COHORT)
    a3 = _grid_alphas(col, UQP_GRID)
    k3 = qat_probe.key_rows(COHORT, x2.device, 62)
    kg = qat_probe.key_rows(UQP_GRID, x2.device, 63)
    n, rows = x2.numel(), x2.shape[0]
    codes3 = K.quant_pack_sub_many(x3, c3, k3)
    shared = col.expand(COHORT, *col.shape)
    return {
        "quant_pack_sub_tiles": (lambda: K.quant_pack_sub_many(x3, c3, k3),
                                 lambda: R.quant_pack_sub_tiles_many(x3, c3, k3, FP4_E2M1),
                                 COHORT * (4.5 * n + 4 * rows + 8), COHORT * 40 * n,
                                 tuple(x3.shape)),
        "fake_quant_tiles": (lambda: K.fake_quant_many(x2, a3, kg),
                             lambda: R.fake_quant_tiles_many(x2, a3, kg),
                             4 * n + UQP_GRID * (4 * n + 4 * rows + 8), UQP_GRID * 40 * n,
                             (UQP_GRID, *x2.shape)),
        "unpack_sub_tiles": (lambda: K.unpack_sub_many(codes3, c3),
                             lambda: R.unpack_sub_tiles_many(codes3, c3, FP4_E2M1),
                             COHORT * (4.5 * n + 4 * rows), COHORT * 12 * n, tuple(x3.shape)),
        "quant_pack_amax_tiles": (lambda: K.quant_pack_amax_many(x3, shared, k3),
                                  lambda: R.quant_pack_amax_tiles_many(x3, shared, k3),
                                  COHORT * (5 * n + 4 * rows + 8) + 4 * rows, COHORT * 41 * n,
                                  tuple(x3.shape)),
        "quant_pack_sub_amax_tiles": (lambda: K.quant_pack_amax_many(x3, shared, k3, FP4_E2M1),
                                      lambda: R.quant_pack_amax_tiles_many(x3, shared, k3,
                                                                           FP4_E2M1),
                                      COHORT * (4.5 * n + 4 * rows + 8) + 4 * rows,
                                      COHORT * 41 * n, tuple(x3.shape)),
    }


def format_timing_cases(K, R, xt, col, key, codes4) -> dict:
    """Timing cases of the FP4 pair and the amax encodes on ``(R, 1024)``
    tiles ``xt`` with an ``(R, 1)`` alpha column: ``name: (kernel, twin,
    bytes, operations, shape)``. Bytes: each input read once (x at 4 B an
    element, FP4 codes at half a byte, alpha 4 B a row, the key 8 B), each
    output written once (FP4 codes half a byte, FP8 codes 1 B, values 4 B,
    the row max 4 B a row)."""
    from repro_torch.core.fp8 import FP4_E2M1

    nt, rows, shp = xt.numel(), xt.shape[0], tuple(xt.shape)
    return {
        "quant_pack_sub_tiles": (lambda: K.quant_pack_sub_tiles(xt, col, key),
                                 lambda: R.quant_pack_sub_tiles(xt, col, key, FP4_E2M1),
                                 4.5 * nt + 4 * rows + 8, 40 * nt, shp),
        "unpack_sub_tiles": (lambda: K.unpack_sub_tiles(codes4, col),
                             lambda: R.unpack_sub_tiles(codes4, col, FP4_E2M1),
                             4.5 * nt + 4 * rows, 12 * nt, shp),
        "quant_pack_amax_tiles": (lambda: K.quant_pack_amax_tiles(xt, col, key),
                                  lambda: R.quant_pack_amax_tiles(xt, col, key),
                                  5 * nt + 8 * rows + 8, 41 * nt, shp),
        "quant_pack_sub_amax_tiles": (lambda: K.quant_pack_sub_amax_tiles(xt, col, key),
                                      lambda: R.quant_pack_sub_amax_tiles(xt, col, key,
                                                                          FP4_E2M1),
                                      4.5 * nt + 8 * rows + 8, 41 * nt, shp),
    }


def _rans_chain_us(freq, cum, s2s, enc) -> dict:
    """The least time of one row of each rANS kernel: its dependent chain
    alone (``rans.chain_probe``, one warp), timed with CUDA events at two
    iteration counts, the difference over the difference in iterations (the
    launch cancels)."""
    from repro_torch.kernels import rans

    out = {}
    for mode in ("decode", "encode"):
        ms = {}
        for iters in (1 << 20, 1 << 21):
            ms[iters] = time_ms(lambda: rans.chain_probe(mode, iters, freq, cum, s2s, enc),
                                reps=3, iters=1, warmup=1)
        out["rans_" + mode] = (ms[1 << 21] - ms[1 << 20]) * 1e3 / (1 << 20)
    return out


def rans_kernel_phase(dev) -> dict:
    """The rANS pair (B12 ``rans_decode`` and the encode) on real code
    streams: the init weights of the format ablation's MLP and of LeNet,
    coded by the E4M3 and FP4 E2M1 wires (plain, against the plain table)
    and by their delta wires (the residual against a slightly moved copy,
    against the delta table): the kernel's buffer, states and lengths and
    the decoded symbols bitwise against the twins', and the decode equal to
    the stream. Then cohorts, one launch each way for three clients (the
    weights moved by seeded noise), as the pareto cells' uplinks code them
    (the MLP's four uplink inners; LeNet's ``fp4_e2m1_det``, its pareto
    cell's EF uplink), each payload bitwise against the twins run one at a
    time; and corrupted streams (bytes replaced, lengths cut below the
    first byte or run past the last column, so lanes read at ``clip(rpos,
    0, cols - 1)``), the decode against the twin. At 8191 x 1024 symbols
    (524k rows a lane) the step-by-step twin is too slow to run, so there
    the pair is held to decode(encode(s)) == s and timed only. Times (CUDA
    events) beside the twin's and two bounds: bytes moved (symbols, the
    table, the coded buffer, states and lengths; the decode reads only the
    ``sum(lens)`` coded bytes it uses) over 3.35 TB/s, or about 12 integer
    operations a symbol over the f32 rate, the larger (``bound_ms``); and
    the chain bound, rows times one row's dependent chain timed alone
    (``_rans_chain_us``), which is what bounds the pair."""
    from repro_torch import tree
    from repro_torch.bench import common
    from repro_torch.core import codec, wire
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import rans
    from repro_torch.kernels import ref as R
    from repro_torch.models import small

    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    models = {"format-mlp": small.init_mlp(0, d_in=64, n_classes=10, device=dev),
              "cifar10-lenet": common.make_model(common.TASKS["cifar10-lenet"], 0, dev)[0]}
    worst = dict.fromkeys(RANS_KERNELS, 0.0)
    streams = {}
    cohorts = {}
    g = torch.Generator().manual_seed(0)
    for mname, params in models.items():
        spec = wire.make_wire_spec(params)
        moved = tree.tree_map(lambda p: p * 0.98, params)
        clients = [tree.tree_map(lambda p: p + 0.02 * torch.randn(p.shape, generator=g).to(dev)
                                 * p.abs().max(), params) for _ in range(3)]
        for grid in ("e4m3", "fp4_e2m1"):
            for inner in (grid, "delta:" + grid):
                rc = codec.get_codec("rans:" + inner)
                ic = rc.inner
                syms = ic.encode(params, spec, key, ref=moved)["codes"].contiguous()
                check(syms.numel() == ic.code_nbytes(spec), f"{mname} {inner}: stream size")
                streams[(mname, inner)] = (syms, rc.table(dev))
            ups = ("delta:" + grid, grid + "_det") if mname == "format-mlp" else \
                (("fp4_e2m1_det",) if grid == "fp4_e2m1" else ())
            for inner in ups:
                rc = codec.get_codec("rans:" + inner)
                cohorts[(mname, inner)] = (torch.stack([
                    rc.inner.encode(c, spec, key, ref=params)["codes"] for c in clients]),
                    rc.table(dev), rc.enc_table(dev))

    def diff(a: torch.Tensor, b: torch.Tensor) -> tuple[int, float]:
        """(values that differ, their largest absolute difference)."""
        d = (a.to(torch.int64) - b.to(torch.int64)).abs()
        return int((d != 0).sum()), float(d.max()) if d.numel() else 0.0

    for (mname, inner), (syms, (freq, cum, s2s)) in streams.items():
        n = syms.numel()
        buf, state, lens = rans.rans_encode(syms, freq, cum)
        per = [diff(a, b) for a, b in zip((buf, state, lens), R.rans_encode(syms, freq, cum))]
        bad = sum(c for c, _ in per)
        worst["rans_encode"] = max(worst["rans_encode"], *(e for _, e in per))
        check(bad == 0, f"rans_encode {mname} {inner} n={n}: {bad} values differ")
        out = rans.rans_decode(buf, state, lens, n, freq, cum, s2s)
        bad, err = diff(out, R.rans_decode(buf, state, lens, n, freq, cum, s2s))
        worst["rans_decode"] = max(worst["rans_decode"], err)
        check(bad == 0, f"rans_decode {mname} {inner} n={n}: {bad} symbols differ")
        check(torch.equal(out, syms), f"rans {mname} {inner}: decode(encode(s)) != s")
        print(f"[kernels] rans pair {mname} {inner}: {n} symbols, {rans.n_steps(n)} rows a "
              f"lane, coded {int(lens.sum())} bytes (bound {buf.numel()}): bitwise ok")
    for (mname, inner), (syms, (freq, cum, s2s), enc) in cohorts.items():
        P, n = syms.shape
        before = dict(K.LAUNCHES)
        buf, state, lens = rans.rans_encode_many(syms, freq, cum, enc)
        out = rans.rans_decode_many(buf, state, lens, n, freq, cum, s2s)
        check(all(K.LAUNCHES[k] == before[k] + 1 for k in RANS_KERNELS),
              f"rans cohort {mname} {inner}: not one launch each way")
        for i in range(P):
            per = [diff(a, b) for a, b in zip((buf[i], state[i], lens[i]),
                                              R.rans_encode(syms[i], freq, cum))]
            worst["rans_encode"] = max(worst["rans_encode"], *(e for _, e in per))
            check(sum(c for c, _ in per) == 0,
                  f"rans_encode_many {mname} {inner} payload {i}: values differ")
            bad, err = diff(out[i], R.rans_decode(buf[i], state[i], lens[i], n, freq, cum, s2s))
            worst["rans_decode"] = max(worst["rans_decode"], err)
            check(bad == 0, f"rans_decode_many {mname} {inner} payload {i}: {bad} differ")
        check(torch.equal(out, syms), f"rans cohort {mname} {inner}: decode(encode(s)) != s")
        print(f"[kernels] rans cohort {mname} {inner}: {P} uplinks of {n} symbols in one launch "
              f"each way, coded {[int(v) for v in lens.sum(1)]} bytes: bitwise ok")
    # corrupted payloads of LeNet's E4M3 stream: the decode against the twin
    syms, (freq, cum, s2s) = streams[("cifar10-lenet", "e4m3")]
    n = syms.numel()
    buf, state, lens = rans.rans_encode(syms, freq, cum)
    cols, step = buf.shape[1], torch.arange(rans.LANES, dtype=torch.int32, device=dev)
    noisy = buf.clone()
    noisy[:, ::7] = torch.randint(0, 256, noisy[:, ::7].shape, generator=g).to(
        torch.uint8).to(dev)
    for label, (b, ln) in {
            "bytes replaced": (noisy, lens),
            "lengths cut below byte 0": (buf, torch.clamp(lens - 40 * step - 1, min=0)),
            "lengths past the last column": (buf, lens + cols // 2 + step)}.items():
        out = rans.rans_decode(b, state, ln, n, freq, cum, s2s)
        bad, err = diff(out, R.rans_decode(b, state, ln, n, freq, cum, s2s))
        worst["rans_decode"] = max(worst["rans_decode"], err)
        check(bad == 0, f"rans_decode corrupted ({label}): {bad} symbols differ from the twin")
        print(f"[kernels] rans decode corrupted lenet e4m3 ({label}): bitwise the twin's "
              f"({int((out != syms).sum())} of {n} symbols off the stream)")
    # the large stream, drawn from the E4M3 plain table (the matched case)
    freq, cum, s2s = codec.get_codec("rans:e4m3").table(dev)
    enc = codec.get_codec("rans:e4m3").enc_table(dev)
    big = s2s.cpu()[torch.randint(0, rans.TAB, (LARGE[0] * LARGE[1],), generator=g)].to(
        torch.uint8).to(dev)
    buf, state, lens = rans.rans_encode(big, freq, cum)
    check(torch.equal(rans.rans_decode(buf, state, lens, big.numel(), freq, cum, s2s), big),
          "rans large stream: decode(encode(s)) != s")
    print(f"[kernels] rans pair random {big.numel()} symbols ({rans.n_steps(big.numel())} "
          f"rows a lane): decode(encode(s)) == s")
    synchronize()
    chain_us = _rans_chain_us(freq, cum, s2s, enc)
    print("[kernels] rans chains alone (one warp): " + ", ".join(
        f"{k} {v * 1e3:.2f} ns a row" for k, v in chain_us.items()))

    timings = {}
    lenet_up, (uf, uc, us), uenc = cohorts[("cifar10-lenet", "fp4_e2m1_det")]
    cases = (("main", streams[("format-mlp", "e4m3")][0][None], (freq, cum, s2s), enc, 3),
             ("lenet", streams[("cifar10-lenet", "e4m3")][0][None], (freq, cum, s2s), enc, 1),
             ("lenet cohort", lenet_up, (uf, uc, us), uenc, 0),
             ("large", big[None], (freq, cum, s2s), enc, 0))
    for label, syms, (tf, tc, ts), te, twin_reps in cases:
        P, n = syms.shape
        steps = rans.n_steps(n)
        buf, state, lens = rans.rans_encode_many(syms, tf, tc, te)
        coded = int(lens.sum())
        table_bytes = 2 * 256 * 4
        runs = {
            "rans_encode": (lambda: rans.rans_encode_many(syms, tf, tc, te),
                            lambda: R.rans_encode(syms[0], tf, tc),
                            P * n + table_bytes + buf.numel() + 8 * rans.LANES * P),
            "rans_decode": (lambda: rans.rans_decode_many(buf, state, lens, n, tf, tc, ts),
                            lambda: R.rans_decode(buf[0], state[0], lens[0], n, tf, tc, ts),
                            coded + 8 * rans.LANES * P + table_bytes + 4 * rans.TAB + P * n),
        }
        for name, (kern, twin, n_bytes) in runs.items():
            reps, iters = (7, 20) if label != "large" else (3, 2)
            ms = time_ms(kern, reps=reps, iters=iters)
            plain_ms = (time_ms(twin, reps=twin_reps, iters=1, warmup=1) if twin_reps
                        else None)
            b_ms, b_by = bound(n_bytes, 12 * steps * rans.LANES * P)
            chain_ms = steps * chain_us[name] / 1e3
            timings.setdefault(name, {})[label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, shape=[P, n],
                steps=steps, coded_bytes=coded, chain_ms=chain_ms,
                us_a_row=ms * 1e3 / steps, chain_us_a_row=chain_us[name])
            print(f"[time] {name:17s} {label:12s} {P} x {n:>8d} symbols ({steps} rows) kernel "
                  f"{ms:.5f} ms = {ms * 1e3 / steps:.4f} us a row  twin "
                  f"{'-' if plain_ms is None else f'{plain_ms:.5f}'} ms  bound {b_ms:.6f} ms "
                  f"({b_by})  chain bound {chain_ms:.5f} ms ({chain_ms / ms:.3f} of it reached)")
    return {"worst": worst, "timings": timings, "chain_us": chain_us}


# ---------------------------------------------------------------------------
# phase 3: small rounds, card against CPU twins
# ---------------------------------------------------------------------------


def _small_round(model: str, device: str, draws, qcfg, **cfg_kw):
    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import clip_value_mask, weight_decay_mask
    from repro_torch.data import (partition_iid, synthetic_classification, synthetic_images,
                                  synthetic_sequences)
    from repro_torch.models import small

    init, apply = small.REGISTRY[model]
    if model == "mlp":
        x, y = synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    elif model == "matchbox":
        x, y = synthetic_sequences(0, 160, n_classes=35, noise=0.9)
    else:
        x, y = synthetic_images(0, 160, n_classes=10, noise=0.45)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    p = init(0, device=device)
    opt = optim.sgd(0.05, weight_decay=1e-3, wd_mask=weight_decay_mask(p),
                    trust_mask=clip_value_mask(p))
    cfg = FedConfig(n_clients=4, participation=0.5, local_steps=3, batch_size=8,
                    qat=qcfg, **cfg_kw)
    sim = FedSim(p, small.make_loss(apply), apply, opt, cfg, cx, cy, nk, device=device)
    if draws is None:
        draws = [sim.engine.draw(torch.Generator().manual_seed(11), sim.nk.cpu(),
                                 cx.shape[1])]
    hist = sim.run(1, draws=draws, eval_data=(x[:64], y[:64]), eval_every=1)
    return sim, hist, draws


def round_phase(dev) -> None:
    """One small round on the card against the same round on the CPU twins,
    with the same draws (cohort, batches, wire keys, and for uq+ the server's
    GD and grid keys, for rand-qat the counter keys of every weight site's
    bits); bytes must be equal. Held to the CPU parity tests' tolerance (loss
    rtol 1e-5, all but 1e-3 of the params within 1e-5 + 1e-4|ref|): the MLP
    (uq, uq+ and rand-qat), and LeNet with weight QAT and the wire but no
    activation quantizers, so that the full conv + weight-QAT + wire round
    is checked tightly. LeNet with activation quantizers is held loosely:
    cuDNN's f32 convolutions differ from the CPU's in the last bits, an
    activation quantizer turns that into another grid point, and that moves
    every later site's input, the step's loss by ~1% and every later
    gradient. There the loss is held to rtol 2e-2 and each quantized weight
    to one top-bin grid step (alpha / 15), the size of a wrong code; the
    count beyond the strict tolerance is printed."""
    from repro_torch.core.qat import QATConfig
    from repro_torch.core.server_opt import ServerOptConfig

    uqp = dict(server_opt=ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20))
    fp4_delayed = dict(down_codec="fp4_e2m1", up_codec="fp4_e2m1", down_scaling="delayed:4",
                       up_scaling="delayed:4")
    fp4_delta = dict(down_codec="fp4_e2m1", up_codec="delta:fp4_e2m1")
    for model, label, qcfg, strict, kw in (
            ("mlp", "mlp uq", QATConfig(), True, {}),
            ("lenet", "lenet weight QAT", QATConfig(quantize_acts=False), True, {}),
            ("lenet", "lenet full QAT", QATConfig(), False, {}),
            ("mlp", "mlp uq+", QATConfig(), True, uqp),
            ("mlp", "mlp rand-qat", QATConfig(mode="rand"), True, {}),
            ("mlp", "mlp fp4 delayed:4", QATConfig(), True, fp4_delayed),
            ("mlp", "mlp fp4 + delta:fp4 up", QATConfig(), True, fp4_delta)):
        card_vs_cpu_round(dev, model, label, qcfg, strict, kw)


def card_vs_cpu_round(dev, model: str, label: str, qcfg, strict: bool, kw: dict,
                      leaf_bars: tuple | None = None) -> None:
    """One small round of ``model`` on the card against the same round on
    the CPU twins (``round_phase``'s draws and tolerances; ``strict`` False:
    the FP8-tie bars). Every leaf that is not a quantized weight is read
    too: the worst absolute difference among the clip values (``*_qa``,
    ``*_qb``) and among the rest (biases, GroupNorm, LayerNorm) is printed,
    and held to ``leaf_bars`` = (clip, rest) where given."""
    from repro_torch import tree

    cpu_sim, cpu_hist, draws = _small_round(model, "cpu", None, qcfg, **kw)
    gpu_sim, gpu_hist, _ = _small_round(model, dev, draws, qcfg, **kw)
    ref = dict(tree.flatten(cpu_sim.params))
    n_bad = n_all = 0
    worst_step = worst_clip = worst_rest = 0.0
    for name, v in tree.flatten(gpu_sim.params):
        r, v = ref[name].double(), v.cpu().double()
        d = (v - r).abs()
        n_bad += int((d > 1e-5 + 1e-4 * r.abs()).sum())
        n_all += r.numel()
        qa = name.rsplit(".", 1)[0] + ".w_qa"
        if name.endswith(".w") and qa in ref:
            worst_step = max(worst_step, (float(d.max()) - 1e-5) / (float(ref[qa]) / 15))
        elif name.endswith(("_qa", "_qb")):
            worst_clip = max(worst_clip, float(d.max()))
        else:
            worst_rest = max(worst_rest, float(d.max()))
    bars = "" if leaf_bars is None else f" (bars {leaf_bars[0]:g}, {leaf_bars[1]:g})"
    print(f"[round] {label}: card vs CPU twins: bytes {gpu_hist.cumulative_bytes[0]} "
          f"vs {cpu_hist.cumulative_bytes[0]}, loss {gpu_hist.loss[0]:.7f} vs "
          f"{cpu_hist.loss[0]:.7f}, {n_bad} of {n_all} params beyond 1e-5 + 1e-4|ref|, "
          f"worst weight {max(worst_step, 0.0):.3f} of a top-bin grid step, "
          f"worst clip value {worst_clip:.3g}, worst other leaf {worst_rest:.3g}{bars}")
    check(gpu_hist.cumulative_bytes == cpu_hist.cumulative_bytes, f"{label}: bytes")
    check(worst_step <= 1.0, f"{label}: a weight is off by more than a grid step")
    if strict:
        check(n_bad <= max(1, 1e-3 * n_all), f"{label}: {n_bad} of {n_all} differ")
    if leaf_bars is not None:
        check(worst_clip <= leaf_bars[0], f"{label}: a clip value is off by {worst_clip:.3g}")
        check(worst_rest <= leaf_bars[1], f"{label}: a bias or norm leaf is off by "
              f"{worst_rest:.3g}")
    check(math.isclose(gpu_hist.loss[0], cpu_hist.loss[0], rel_tol=1e-5 if strict else 2e-2),
          f"{label}: loss {gpu_hist.loss[0]} vs cpu {cpu_hist.loss[0]}")


# ---------------------------------------------------------------------------
# phase 4: the main paths
# ---------------------------------------------------------------------------

PATH_KERNELS = {
    "uq": ("quant_det", "quant_det_bwd", "quant_pack_tiles", "unpack_tiles"),
    "uq+": ("quant_det", "quant_det_bwd", "quant_pack_tiles", "unpack_tiles",
            "fake_quant_tiles"),
}


# every wire kernel: the FP8 pair, B5, the FP4 pair and the three amax encodes
WIRE_KERNELS = ("quant_pack_tiles", "unpack_tiles", "fake_quant_tiles", "quant_pack_sub_tiles",
                "unpack_sub_tiles", "quant_pack_amax_tiles", "quant_pack_sub_amax_tiles",
                "fake_quant_amax_tiles")
# their launches summed over every path of phases 4-8. FP4 legs run 1 + 1
# decode launches a round (the downlink's plane, then the cohort's uplink
# planes together) and delayed legs 1 + 1 amax encodes: unpack_sub_tiles
# 6 MLP format cells x 25 rounds x 2 + 3 LeNet cells x 3 x 2 = 318, 5 pareto
# FP4 cells x 25 x 2 + the LeNet fp4|ef+rans cell 3 x 2 = 256;
# quant_pack_amax_tiles delayed:4 and delayed:16:1 2 x 25 x 2 +
# frozen_down+delayed_up 25 + LeNet e4m3 delayed:4 3 x 2 = 131;
# quant_pack_sub_amax_tiles LeNet fp4_e2m1 delayed:4 3 x 2 = 6
WIRE_LAUNCH_TOTALS = {
    "quant_pack_tiles": 1989, "unpack_tiles": 2276, "fake_quant_tiles": 378,
    "quant_pack_sub_tiles": 568, "unpack_sub_tiles": 574, "quant_pack_amax_tiles": 131,
    "quant_pack_sub_amax_tiles": 6, "fake_quant_amax_tiles": 1,
}


def launches_by_path(uq, uqp, grid, fmt, lm, trainer, b9) -> dict:
    """Each path of phases 4-8 (each driven with the counters zeroed just
    before and read just after): the launches of every kernel on it."""
    return {"cifar10-lenet uq": uq["launches"], "cifar10-lenet uq+": uqp["launches"],
            f"table1 grid ({GRID_ROUNDS} rounds)": grid["table1_launches"],
            "table2 rand-qat": grid["launches"], "format ablation": fmt["launches"],
            "format ablation pareto": fmt["pareto_launches"], "fed_lm": lm["launches"],
            "launch.train": trainer["launches"], "fake_quant_amax_plane": b9["launches"]}


def _make_sim(dev, task_name: str, method: str, sc: dict, **cfg_kw):
    """A ``FedSim`` for ``method`` on ``task_name`` built from the bench
    drivers' pieces (``repro_torch.bench.common``) at scale ``sc``, with
    ``cfg_kw`` replacing fields of the method's config; returns the
    simulator, its config and the test split."""
    import dataclasses

    from repro_torch.bench import common
    from repro_torch.core.fedsim import FedSim
    from repro_torch.data import partition_iid
    from repro_torch.models import small

    task = common.TASKS[task_name]
    (x, y), (xt, yt) = common.make_data(task, sc["n_train"], sc["n_test"], seed=0)
    cx, cy, nk = partition_iid(x, y, k=sc["k"], seed=0)
    params, apply = common.make_model(task, 0, dev)
    cfg = dataclasses.replace(
        common.method_cfg(method, sc["k"], sc["c"], sc["local_steps"], sc["batch"]), **cfg_kw)
    sim = FedSim(params, small.make_loss(apply), apply,
                 common.make_optimizer(task, params), cfg, cx, cy, nk, device=dev)
    return sim, cfg, (xt, yt)


def main_path_phase(dev, method: str, rounds: int = 3) -> dict:
    """``FedSim`` on cifar10-lenet at full width through the Table 1 driver's
    pieces, at its CPU-budget scale."""
    from repro_torch.bench import table1
    from repro_torch.kernels import fp8_quant as K

    sc = table1.CPU_BUDGET
    sim, cfg, (xt, yt) = _make_sim(dev, "cifar10-lenet", method, sc)
    check(sim.bytes_per_round == SLICE_ROUND_BYTES,
          f"{method}: bytes_per_round {sim.bytes_per_round} != {SLICE_ROUND_BYTES}")

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
    for name in PATH_KERNELS[method]:
        check(launches[name] > 0, f"kernel {name} was not launched on the {method} path")
    if method == "uq+":
        check(launches["fake_quant_tiles"] == UQP_LAUNCHES_PER_ROUND * rounds,
              f"fake_quant_tiles launched {launches['fake_quant_tiles']} times in "
              f"{rounds} rounds, not {UQP_LAUNCHES_PER_ROUND} a round")
    check(hist.cumulative_bytes == [rounds * SLICE_ROUND_BYTES],
          f"cumulative bytes {hist.cumulative_bytes}")
    check(all(math.isfinite(v) for v in hist.loss), f"loss {hist.loss}")
    for leaf in sim.params.values():
        for v in leaf.values():
            check(bool(torch.isfinite(v).all()), "non-finite parameter")
    check(0.0 <= acc <= 1.0, f"accuracy {acc}")
    s_round = (t_run - t_eval) / rounds
    print(f"[main] cifar10-lenet {method} K={sc['k']} P={cfg.clients_per_round} "
          f"U={sc['local_steps']} B={sc['batch']}: {rounds} rounds, "
          f"{s_round:.3f} s/round (eval {t_eval:.3f} s), accuracy {acc:.4f}, "
          f"local_loss {hist.loss[-1]:.4f}, bytes/round {sim.bytes_per_round}, "
          f"launches {launches}")
    if method == "uq+":
        time_server_step(sim)
    profile_round(sim, s_round, method)
    return {"launches": launches, "s_per_round": s_round, "accuracy": acc}


def time_server_step(sim) -> None:
    """Host-clock time of one UQ+ server step (``server_optimize``, 5 GD
    steps + 20 grid points) on LeNet's plane with three client messages
    made from the server model, synchronized; the median of 5 calls."""
    from repro_torch.core.server_opt import server_optimize
    from repro_torch.tree import tree_map

    stacked = tree_map(lambda p: torch.stack([p, p * 1.01, p * 0.99]), sim.params)
    nk = torch.tensor([1.0, 2.0, 3.0], device=sim.device)
    d = sim.engine.draw(torch.Generator().manual_seed(5), sim.nk.cpu(),
                        sim.client_data.shape[1]).to(sim.device)
    samples = []
    for _ in range(6):
        synchronize()
        t0 = time.perf_counter()
        server_optimize(stacked, nk, d.gd_keys, d.grid_keys, sim.cfg.server_opt)
        synchronize()
        samples.append(time.perf_counter() - t0)
    print(f"[main] uq+ server step on LeNet's plane (P=3): "
          f"{statistics.median(samples[1:]) * 1e3:.2f} ms (host clock, median of 5)")


# torch.profiler on the card loses device records at the start of a trace in
# two ways (kineto counts both "out of range"): in some traces, those of the
# first millisecond or so, whose times it places before the window; and in
# every trace, its earliest records, more the more traces a process has
# taken, however late they come. So a profiled round whose kernels are
# counted starts 50 ms into the trace, after LEAD_IN spin kernels,
# synchronized: the losses fall on them, and the round's records are whole as
# long as some of them are still recorded.
LEAD_IN = 256


def _lead_in() -> None:
    synchronize()
    time.sleep(0.05)
    for _ in range(LEAD_IN):
        torch.cuda._sleep(100)
    synchronize()


def _lead_in_seen(rows) -> int:
    """Spin kernels of ``_lead_in`` among a profile's device rows."""
    return sum(e.count for e in rows if "spin_kernel" in e.key)


def _kernel_counts(rows) -> dict:
    """Launches of each CUDA kernel in a profile's device rows, by its name
    without template arguments."""
    counts = {}
    for e in rows:
        name = e.key.removeprefix("void ").split("(")[0].split("<")[0]
        counts[name] = counts.get(name, 0) + e.count
    return counts


PROFILE_TRACES = 3   # traces of a profiled round before a lossy one fails it


def _trace_round(sim):
    """One more round of ``sim`` under ``torch.profiler`` after the lead-in:
    ``(device rows without the spin kernels, lead-in kernels seen, wrapper
    launches, wall us)``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import fp8_quant as K

    K.reset_launches()
    synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _lead_in()
        t0 = time.perf_counter()
        sim.run(1, seed=1)
        synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    launches = dict(K.LAUNCHES)
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    seen = _lead_in_seen(rows)
    return [e for e in rows if "spin_kernel" not in e.key], seen, launches, wall_us


def profile_round(sim, s_round: float, label: str) -> dict:
    """One more round of the same simulation under ``torch.profiler``: the
    device's busy time and the kernels that take it, by self device time.
    The profiler slows the host many times over, so the busy share is given
    against the unprofiled round time ``s_round`` as well as against the
    profiled wall. Checked: each B2 call and each B6 call either way
    launched one kernel (``quant_det_bwd_kernel``, ``quant_rand_kernel``,
    ``quant_rand_bwd_kernel``), and nothing named ``sum_partials_kernel``
    ran. The round follows ``_lead_in``'s spin kernels, which are left out
    of what is reported. A trace that shows lost records (none of the
    lead-in seen, or fewer ``quant_det_kernel`` records than B1 calls: B1
    is one kernel a call and always was, so the profiler dropped them) is
    taken again, at most ``PROFILE_TRACES`` times, and the checks hold on
    the first whole one (ROADMAP section 3, mechanism 9). Returns the device
    us per launch of each of the port's kernels that ran."""
    for attempt in range(1, PROFILE_TRACES + 1):
        rows, seen, launches, wall_us = _trace_round(sim)
        b1 = _kernel_counts(rows).get("quant_det_kernel", 0)
        if seen > 0 and b1 == launches["quant_det"]:
            break
        print(f"[profile] {label}: trace {attempt} lost records ({seen} of the {LEAD_IN} "
              f"lead-in kernels, {b1} quant_det_kernel records for "
              f"{launches['quant_det']} B1 calls)")
    check(seen > 0, f"{label}: the profiler lost all {LEAD_IN} lead-in kernels, so it may "
          "have lost the round's first kernels too")
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy = sum(dev_time(e) for e in rows)
    print(f"[profile] {label}: one round: device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (s_round * 1e6):.1f}% of the unprofiled {s_round * 1e3:.1f} ms "
          f"round ({100 * busy / wall_us:.1f}% of the profiled wall "
          f"{wall_us / 1e3:.1f} ms), {len(rows)} kernel names")
    for e in sorted(rows, key=dev_time, reverse=True)[:12]:
        print(f"[profile]   {dev_time(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    # B2 and B6 are one kernel a call each way; the first port's second pass
    # (sum_partials_kernel) is gone
    counts = _kernel_counts(rows)
    one_each = {"quant_det_bwd_kernel": launches["quant_det_bwd"],
                "quant_rand_kernel": launches["quant_rand"],
                "quant_rand_bwd_kernel": launches["quant_rand_bwd"]}
    check(all(counts.get(k, 0) == v for k, v in one_each.items())
          and "sum_partials_kernel" not in counts,
          f"{label}: calls {one_each} launched "
          f"{ {k: counts.get(k, 0) for k in one_each} } kernels and "
          f"{counts.get('sum_partials_kernel', 0)} sum_partials_kernel")
    print(f"[profile] {label}: {launches['quant_det_bwd']} B2 and {launches['quant_rand']} / "
          f"{launches['quant_rand_bwd']} B6 calls, one kernel each; no sum_partials_kernel "
          f"({seen} of the {LEAD_IN} lead-in kernels recorded)")
    ours = ("quant_det_kernel", "quant_det_bwd_kernel", "quant_pack_kernel", "unpack_kernel",
            "quant_pack_elem_kernel", "unpack_elem_kernel", "fake_quant_many_kernel",
            "quant_rand_kernel", "quant_rand_bwd_kernel", "quant_pack_sub_kernel",
            "unpack_sub_kernel", "quant_pack_amax_kernel", "rans_encode_kernel",
            "rans_decode_kernel")
    per_launch = {}
    for e in rows:
        name = e.key.removeprefix("void ").split("(")[0]  # a template: "void f<1>(...)"
        if name.split("<")[0] in ours:
            per_launch[name] = dev_time(e) / max(e.count, 1)
            print(f"[profile] ours: {name:22s} x{e.count:<5d} "
                  f"{per_launch[name]:.2f} us of device time per launch")
    return per_launch


# ---------------------------------------------------------------------------
# phase 6: the format ablation (codecs and scaling policies)
# ---------------------------------------------------------------------------


def _cell_kernels(kw: dict) -> tuple[set, set]:
    """The wire kernels a cell with FedConfig overrides ``kw`` must launch,
    and those it must not: an FP4 leg runs the FP4 pair, an FP8 leg the FP8
    pair (under EF, delta or rANS too); a delayed leg encodes with its
    format's amax kernel; a rANS leg runs the rANS pair, and no other cell
    does."""
    must, never = set(), set()
    if kw.get("comm_mode") == "none":
        return must, {"quant_pack_tiles", "unpack_tiles", *FORMAT_KERNELS, *RANS_KERNELS}
    for leg in ("down", "up"):
        codec = kw.get(f"{leg}_codec") or "e4m3"
        fp4 = "fp4" in codec
        delayed = str(kw.get(f"{leg}_scaling") or "").startswith("delayed")
        must.add("unpack_sub_tiles" if fp4 else "unpack_tiles")
        if delayed:
            must.add("quant_pack_sub_amax_tiles" if fp4 else "quant_pack_amax_tiles")
        else:
            must.add("quant_pack_sub_tiles" if fp4 else "quant_pack_tiles")
        if "rans" in codec:
            must |= set(RANS_KERNELS)
    if not any(str(kw.get(f"{leg}_scaling") or "").startswith("delayed")
               for leg in ("down", "up")):
        never |= {"quant_pack_amax_tiles", "quant_pack_sub_amax_tiles"}
    if not any("rans" in str(kw.get(f"{leg}_codec") or "") for leg in ("down", "up")):
        never |= set(RANS_KERNELS)
    return must, never


def _wire_launches(launches: dict) -> dict:
    """The launches of a cell without the QAT pair's (every cell has those)."""
    return {k: v for k, v in launches.items()
            if v and k not in ("quant_det", "quant_det_bwd")}


def _rans_legs(kw: dict) -> int:
    """The entropy-coded legs of a cell: each rANS kernel launches exactly
    once a leg a round (the downlink's one payload; the cohort's uplink
    payloads together)."""
    return sum("rans" in str(kw.get(f"{leg}_codec") or "") for leg in ("down", "up"))


def _fp4_encode_legs(kw: dict) -> int:
    """The legs of a cell whose encode is B8 ``quant_pack_sub_tiles``: an FP4
    codec (under delta, EF or rANS too) at current scaling. Each launches it
    exactly once a round: the downlink's plane, then the cohort's uplink
    planes together (``quant_pack_sub_many``)."""
    if kw.get("comm_mode") == "none":
        return 0
    return sum("fp4" in str(kw.get(f"{leg}_codec") or "")
               and not str(kw.get(f"{leg}_scaling") or "").startswith("delayed")
               for leg in ("down", "up"))


def _check_pareto_row(r: dict, kw: dict, launches: dict, rounds: int) -> None:
    """A pareto cell: its bound the reference's integer, the two-lane
    contract (measured <= bound with a rANS leg, == without), and each rANS
    kernel launched exactly once an entropy-coded leg a round."""
    name = r["comm_fmt"]
    check(r["round_bytes"] == PARETO_BYTES[name],
          f"{name}: bound {r['round_bytes']} != {PARETO_BYTES[name]}")
    legs = _rans_legs(kw)
    if legs:
        check(0 < r["measured_round_bytes"] <= r["round_bytes"],
              f"{name}: measured {r['measured_round_bytes']} > bound {r['round_bytes']}")
        for k in RANS_KERNELS:
            check(launches[k] == rounds * legs,
                  f"{name}: {k} launched {launches[k]} times, not {rounds * legs}")
    else:
        check(r["measured_round_bytes"] == r["round_bytes"],
              f"{name}: measured {r['measured_round_bytes']} != bound {r['round_bytes']}")
    _check_cell_launches(name, kw, launches, rounds)


def _leg_counts(kw: dict) -> dict:
    """The wire kernels that run exactly once a leg a round, each the legs
    that run it: the FP4 decode on every FP4 leg (under delta, EF or rANS
    too; the downlink's plane, then the cohort's uplink planes together),
    each amax encode on every delayed leg of its format (likewise)."""
    if kw.get("comm_mode") == "none":
        return {}
    out = {"quant_pack_sub_tiles": _fp4_encode_legs(kw), "unpack_sub_tiles": 0,
           "quant_pack_amax_tiles": 0, "quant_pack_sub_amax_tiles": 0}
    for leg in ("down", "up"):
        fp4 = "fp4" in str(kw.get(f"{leg}_codec") or "")
        out["unpack_sub_tiles"] += fp4
        if str(kw.get(f"{leg}_scaling") or "").startswith("delayed"):
            out["quant_pack_sub_amax_tiles" if fp4 else "quant_pack_amax_tiles"] += 1
    return out


def _check_cell_launches(label: str, kw: dict, launches: dict, rounds: int) -> None:
    must, never = _cell_kernels(kw)
    for name in must:
        check(launches[name] > 0, f"{label}: kernel {name} was not launched")
    for name in never:
        check(launches[name] == 0, f"{label}: kernel {name} launched {launches[name]} times")
    for name, legs in _leg_counts(kw).items():
        check(launches[name] == rounds * legs,
              f"{label}: {name} launched {launches[name]} times in {rounds} rounds, not "
              f"{rounds * legs} (once a leg that runs it a round)")


def format_phase(dev) -> dict:
    """The format ablation's 28 cells on the MLP (its ``format``, ``scaling``
    and ``pareto`` sections), then the four cifar10-lenet format cells and
    the cifar10-lenet ``fp4|ef+rans`` cell; every cell with the launch
    counters zeroed just before and read just after. Returns the launches
    summed over the format cells and over the pareto cells and, per profiled
    cell, the device time per launch of each of the port's kernels."""
    from repro_torch.bench import format_ablation, table1
    from repro_torch.kernels import fp8_quant as K

    total = dict.fromkeys(K.KERNELS, 0)
    pareto_total = dict.fromkeys(K.KERNELS, 0)
    t0 = time.perf_counter()
    cells = format_ablation.cells()
    rows = format_ablation.iter_rows(device=dev)
    n_rounds = format_ablation.DEFAULT["rounds"]
    for section, _, kw in cells:
        K.reset_launches()
        synchronize()
        r = next(rows)                   # runs this cell
        synchronize()
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            (pareto_total if section == "pareto" else total)[k] += v
        name = r["comm_fmt"]
        print(f"[{section}] {name:34s} {n_rounds} rounds: final_acc {r['final_acc']:.4f} "
              f"bytes/round {r['round_bytes']} measured "
              f"{r.get('measured_round_bytes', r['round_bytes'])} comm_gain "
              f"{r['comm_gain_vs_fp32']} wall {r['wall_s']:.2f} s wire launches "
              f"{_wire_launches(launches)}")
        check(0.0 <= r["final_acc"] <= 1.0, f"{name}: accuracy {r['final_acc']}")
        if section == "pareto":
            print(f"[pareto] {name:34s} bits/param {r['bits_per_param']} gain to 0.95 "
                  f"{r['gain_to_acc_0p95']} acc vs fp32 {r['acc_delta_vs_fp32']}")
            _check_pareto_row(r, kw, launches, n_rounds)
            continue
        want = FORMAT_BYTES[name]
        check(r["round_bytes"] == want, f"{name}: bytes/round {r['round_bytes']} != {want}")
        _check_cell_launches(name, kw, launches, n_rounds)
    check(next(rows, None) is None, "format ablation: more rows than cells")
    print(f"[format] ablation: {len(cells)} cells in {time.perf_counter() - t0:.1f} s")

    # full-width cifar10-lenet at the Table 1 budget
    sc = table1.CPU_BUDGET
    device_us = {}
    for i, (label, kw, want) in enumerate(LENET_FORMAT_CELLS):
        sim, cfg, (xt, yt) = _make_sim(dev, "cifar10-lenet", "uq", sc, **kw)
        check(sim.bytes_per_round == want,
              f"lenet {label}: bytes/round {sim.bytes_per_round} != {want}")
        K.reset_launches()
        synchronize()
        t0 = time.perf_counter()
        hist = sim.run(FORMAT_ROUNDS, seed=0, eval_data=(xt, yt), eval_every=FORMAT_ROUNDS)
        synchronize()
        wall = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        _check_cell_launches(f"lenet {label}", kw, launches, FORMAT_ROUNDS)
        check(hist.cumulative_bytes == [FORMAT_ROUNDS * want], f"lenet {label}: bytes")
        check(all(math.isfinite(v) for v in hist.loss), f"lenet {label}: loss {hist.loss}")
        for v in sim.state.params.values():
            for leaf in v.values():
                check(bool(torch.isfinite(leaf).all()), f"lenet {label}: non-finite parameter")
        t0 = time.perf_counter()
        sim.evaluate(xt, yt)
        synchronize()
        s_round = (wall - (time.perf_counter() - t0)) / FORMAT_ROUNDS
        acc = hist.accuracy[-1]
        print(f"[format] cifar10-lenet {label:30s} {FORMAT_ROUNDS} rounds: final_acc {acc:.4f} "
              f"bytes/round {sim.bytes_per_round} comm_gain "
              f"{GRID_BYTES[('cifar10-lenet', 'fp32')] / sim.bytes_per_round:.3f} "
              f"wall {wall:.2f} s, {s_round:.3f} s/round (eval excluded) "
              f"wire launches {_wire_launches(launches)}")
        if i != 1:      # (b) runs no kernel that (a) does not
            device_us[label] = profile_round(sim, s_round, f"lenet {label}")
    for name in FORMAT_KERNELS:
        check(total[name] > 0, f"kernel {name} was not launched on the format path")

    # the pareto stack at LeNet's full width: fp4|ef+rans, 3 rounds
    label, kw, want = LENET_PARETO_CELL
    sim, cfg, (xt, yt) = _make_sim(dev, "cifar10-lenet", "uq", sc, **kw)
    check(sim.bytes_per_round == want, f"lenet {label}: bound {sim.bytes_per_round} != {want}")
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    hist = sim.run(FORMAT_ROUNDS, seed=0, eval_data=(xt, yt), eval_every=FORMAT_ROUNDS)
    synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for k, v in launches.items():
        pareto_total[k] += v
    measured = hist.cumulative_bytes[-1] / FORMAT_ROUNDS
    check(0 < measured <= want, f"lenet {label}: measured {measured} > bound {want}")
    for k in RANS_KERNELS:
        check(launches[k] == FORMAT_ROUNDS * _rans_legs(kw),
              f"lenet {label}: {k} launched {launches[k]} times, not "
              f"{FORMAT_ROUNDS * _rans_legs(kw)}")
    _check_cell_launches(f"lenet {label}", kw, launches, FORMAT_ROUNDS)
    check(all(math.isfinite(v) for v in hist.loss), f"lenet {label}: loss {hist.loss}")
    for v in sim.state.params.values():
        for leaf in v.values():
            check(bool(torch.isfinite(leaf).all()), f"lenet {label}: non-finite parameter")
    check(bool(torch.isfinite(sim.state.clients.resid).all()), f"lenet {label}: residuals")
    s_round = wall / FORMAT_ROUNDS
    print(f"[pareto] cifar10-lenet {label} {FORMAT_ROUNDS} rounds: final_acc "
          f"{hist.accuracy[-1]:.4f} bound/round {sim.bytes_per_round} measured/round "
          f"{measured:.1f} wall {wall:.2f} s ({s_round:.3f} s/round, eval included) "
          f"wire launches {_wire_launches(launches)}")
    device_us["lenet " + label] = profile_round(sim, s_round, f"lenet {label}")
    for name in RANS_KERNELS:
        check(pareto_total[name] > 0, f"kernel {name} was not launched on the pareto path")
    return {"launches": total, "pareto_launches": pareto_total, "device_us": device_us}


# ---------------------------------------------------------------------------
# phase 5: the method grid (Table 1) and the stochastic-QAT cells (Table 2)
# ---------------------------------------------------------------------------


def grid_phase(dev) -> dict:
    from repro_torch.bench import table1, table2
    from repro_torch.kernels import fp8_quant as K

    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    rows = table1.run(device=dev, scale=dict(rounds=GRID_ROUNDS),
                      eval_every=GRID_EVAL_EVERY)
    synchronize()
    table1_launches = dict(K.LAUNCHES)
    for r in rows:
        want = GRID_BYTES[(r["task"], r["method"])]
        print(f"[grid] table1 {r['task']:14s} {r['setting']:6s} {r['method']:4s} "
              f"{GRID_ROUNDS} rounds: final_acc {r['final_acc']:.4f} bytes/round "
              f"{r['bytes_per_round']} comm_gain {r['comm_gain']} wall {r['wall_s']:.2f} s")
        check(r["bytes_per_round"] == want,
              f"{r['task']} {r['method']}: bytes/round {r['bytes_per_round']} != {want}")
        check(0.0 <= r["final_acc"] <= 1.0, f"{r['task']} {r['method']}: accuracy")
    check(len(rows) == len(table1.TABLE1_TASKS) * 2 * len(table1.TABLE1_METHODS),
          f"{len(rows)} grid rows")
    print(f"[grid] table1: {len(rows)} cells in {time.perf_counter() - t0:.1f} s")

    # Table 2's stochastic-QAT cell and the same QAT with the rand wire
    cells = (("rand-qat/no-cq", "rand-qat-only"), ("rand-qat/rand-cq", "rand-qat"))
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    rows2 = table2.run(device=dev, cells=cells)
    synchronize()
    launches = dict(K.LAUNCHES)
    for r in rows2:
        print(f"[grid] table2 {r['task']} {r['cell']} ({r['method']}): "
              f"final_acc {r['final_acc']:.4f} bytes/round {r['bytes_per_round']} "
              f"wall {r['wall_s']:.2f} s")
        check(r["bytes_per_round"] == TABLE2_BYTES[r["method"]],
              f"table2 {r['method']}: bytes/round {r['bytes_per_round']}")
    for name in ("quant_rand", "quant_rand_bwd"):
        check(launches[name] > 0, f"kernel {name} was not launched on the rand-qat path")
    check(launches["quant_rand"] >= launches["quant_rand_bwd"],
          "fewer quant_rand forwards than backwards")
    print(f"[grid] table2 rand-qat path: {time.perf_counter() - t0:.1f} s, "
          f"launches {launches}")
    # one profiled round of the rand-qat cell, for the quant_rand pair's
    # device time per launch
    sim, _, _ = _make_sim(dev, "cifar100-mlp", "rand-qat", table2.CPU_BUDGET)
    sim.run(1, seed=0)
    synchronize()
    t0 = time.perf_counter()
    sim.run(1, seed=2)
    synchronize()
    per_launch = profile_round(sim, time.perf_counter() - t0, "table2 rand-qat")
    return {"launches": launches, "table1_launches": table1_launches,
            "device_us": {name: next((v for k, v in per_launch.items()
                                      if k.split("<")[0] == name + "_kernel"), None)
                          for name in ("quant_rand", "quant_rand_bwd")}}


# ---------------------------------------------------------------------------
# phase 9: the paper's ResNet and MatchboxNet, the quickstart and Figure 2
# ---------------------------------------------------------------------------

PAPER_PROFILED = ("cifar10-resnet", "uq+")
WIRE_ROUTE = {"quant_pack_kernel": "B3 16-element (one wave or more)",
              "quant_pack_elem_kernel": "B3 first port's, one element a thread (below a wave)",
              "unpack_kernel": "B4 16-element (one wave or more)",
              "unpack_elem_kernel": "B4 first port's, one element a thread (below a wave)"}


def paper_phase(dev) -> dict:
    """The paths this slice adds, each driven with the counters zeroed just
    before and read just after: Table 1 on cifar10-resnet and
    speech-matchbox (iid and Dir(0.3) x fp32/uq/uq+, ``PAPER_GRID_ROUNDS``
    rounds), every row's bytes the reference's integer; one profiled
    cifar10-resnet uq+ round (s/round, device busy, device us a launch of
    B1-B5 at ResNet's shapes, the B3/B4 route its 175-row plane takes); one
    round of each new model on the card against the CPU twins (FP8-tie
    bars, ``PAPER_LEAF_BARS``); the quickstart at its 40 rounds and Figure 2 at the reference
    driver's CPU-budget scale, bytes the reference's integers. Returns the
    wire launches of each path."""
    from repro_torch.bench import fig2, quickstart, table1
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import fp8_quant as K

    t_phase = time.perf_counter()
    launches = {}
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    rows = table1.run(tasks=PAPER_TASKS, device=dev, scale=dict(rounds=PAPER_GRID_ROUNDS),
                      eval_every=GRID_EVAL_EVERY)
    synchronize()
    launches[f"table1 {'/'.join(PAPER_TASKS)} ({PAPER_GRID_ROUNDS} rounds)"] = dict(K.LAUNCHES)
    for r in rows:
        want = GRID_BYTES[(r["task"], r["method"])]
        print(f"[paper] table1 {r['task']:15s} {r['setting']:6s} {r['method']:4s} "
              f"{PAPER_GRID_ROUNDS} rounds: final_acc {r['final_acc']:.4f} bytes/round "
              f"{r['bytes_per_round']} comm_gain {r['comm_gain']} wall {r['wall_s']:.2f} s")
        check(r["bytes_per_round"] == want,
              f"{r['task']} {r['method']}: bytes/round {r['bytes_per_round']} != {want}")
        check(0.0 <= r["final_acc"] <= 1.0, f"{r['task']} {r['method']}: accuracy")
    check(len(rows) == len(PAPER_TASKS) * 2 * len(table1.TABLE1_METHODS), f"{len(rows)} rows")
    for name in PATH_KERNELS["uq+"]:
        check(launches[next(iter(launches))][name] > 0, f"{name} not launched on phase 9's grid")
    print(f"[paper] table1: {len(rows)} cells in {time.perf_counter() - t0:.1f} s")

    # one profiled cifar10-resnet uq+ round, after a warm one and a timed one
    task_name, method = PAPER_PROFILED
    sim, cfg, _ = _make_sim(dev, task_name, method, table1.CPU_BUDGET)
    sim.run(1, seed=0)
    synchronize()
    t0 = time.perf_counter()
    sim.run(1, seed=2)
    synchronize()
    s_round = time.perf_counter() - t0
    print(f"[paper] {task_name} {method} K={cfg.n_clients} P={cfg.clients_per_round} "
          f"U={cfg.local_steps} B={cfg.batch_size}: {s_round:.3f} s/round")
    per_launch = profile_round(sim, s_round, f"{task_name} {method}")
    routes = sorted({WIRE_ROUTE[k.split("<")[0]] for k in per_launch
                     if k.split("<")[0] in WIRE_ROUTE})
    print(f"[paper] {task_name}'s {PAPER_PLANE_ROWS[task_name]}-row wire plane takes: "
          f"{'; '.join(routes)}")
    check(any(r.startswith("B3") for r in routes) and any(r.startswith("B4") for r in routes),
          f"{task_name}: no B3/B4 kernel seen in the profiled round")

    # one round of each new model, card against CPU twins (FP8-tie bars,
    # and PAPER_LEAF_BARS on the leaves that are not quantized weights)
    for model in ("resnet", "matchbox"):
        card_vs_cpu_round(dev, model, f"{model} uq", QATConfig(), False, {},
                          PAPER_LEAF_BARS[model])

    # the quickstart and Figure 2
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    qs = quickstart.run(device=dev)
    synchronize()
    launches["quickstart"] = dict(K.LAUNCHES)
    for r in qs:
        print(f"[paper] quickstart {r['method']:13s} {quickstart.ROUNDS} rounds: best accuracy "
              f"{r['best_accuracy']:.4f} bytes/round {r['bytes_per_round']} cumulative "
              f"{r['cumulative_bytes'][-1]} wall {r['wall_s']:.2f} s")
        want = QUICKSTART_BYTES[r["method"]]
        check(r["bytes_per_round"] == want
              and r["cumulative_bytes"] == [rd * want for rd in r["rounds"]],
              f"quickstart {r['method']}: bytes {r['bytes_per_round']} != {want}")
    print(f"[paper] quickstart: {time.perf_counter() - t0:.1f} s")
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    f2 = fig2.run(device=dev)
    synchronize()
    launches["fig2 cifar100-mlp"] = dict(K.LAUNCHES)
    for label in FIG2_BYTES:
        curve = [r for r in f2 if r["method"] == label]
        want = FIG2_BYTES[label]
        check(all(r["bytes_per_round"] == want and r["cumulative_bytes"] == r["round"] * want
                  for r in curve) and len(curve) == fig2.CPU_BUDGET["rounds"]
              // fig2.CPU_BUDGET["eval_every"], f"fig2 {label}: bytes or rounds")
        print(f"[paper] fig2 {label:4s}: acc " + " ".join(f"{r['acc']:.4f}" for r in curve)
              + f" at {curve[-1]['mbytes']} MB after {curve[-1]['round']} rounds "
              f"({want} bytes a round), wall {curve[-1]['wall_s']:.2f} s")
    print(f"[paper] fig2: {time.perf_counter() - t0:.1f} s; phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "s_per_round": s_round, "device_us": per_launch}


# ---------------------------------------------------------------------------
# phase 7: federated LM fine-tuning (full-width TinyLlama-1.1B) on B10/B11
# ---------------------------------------------------------------------------

LM_ARCH = "tinyllama_1_1b"
LM_ROUNDS = 2
LM_ROUND_BYTES = 8802606752         # 4 clients x 2 legs x 1100325844 (reference integer)
LM_STEP_LAUNCHES = 22 * 7 + 8       # each B10/B11 kernel: 7 projections a layer + 8 CE chunks
LM_ROUND_LAUNCHES = 4 * 8 * LM_STEP_LAUNCHES   # P = 4 clients x U = 8 local steps
LM_WIRE_LAUNCHES = 5                # quant_pack_tiles / unpack_tiles: 1 down + 4 up
LM_WIRE_INSTANCE = {"quant_pack_tiles": "quant_pack_kernel", "unpack_tiles": "unpack_kernel"}
LM_RAGGED = (77, 130, 200)          # (M, K, N), no dimension a tile multiple
LM_MAIN_SHAPE = (256, 2048, 5632)   # w_gate / w_up, the largest share of a step's products
TRAIN_BATCH = (8, 128)              # launch.train's default batch x sequence
BF16_OPS_PER_S = 989e12             # H100 SXM dense bf16 tensor cores (the product's floor:
                                    # grid values are exact in bf16)
QAT_MATMUL = ("qat_matmul", "qat_matmul_dx", "qat_matmul_dw")
QAT_GEMM_INSTANCE = {   # every CUDA kernel of csrc/qat_matmul.cu a wrapper call launches
    "qat_matmul": ("qat_fwd_wgmma_kernel", "qat_fwd_finish_kernel"),
    "qat_matmul_dx": ("qat_dx_wgmma_kernel", "qat_dx_finish_kernel", "qat_fold_kernel"),
    "qat_matmul_dw": ("qat_dw_wgmma_kernel", "qat_tab_kernel", "qat_fold_kernel"),
}


def _lm_projection_cases(dev) -> list:
    """The operands of each distinct projection shape of the two LM paths
    that run B10/B11 at full width (TinyLlama-1.1B): one ``fed_lm`` local
    step (batch 4 x 64 tokens, client 0's) and one ``launch.train`` step at
    opt_level 0 (batch 8 x 128, the trainer's first batch at seed 0). The
    port's init weights (layer 0, each alpha = max|w| of its layer, so an
    element sits on the clip) and the activations of a real forward, with
    their LSQ-scaled clip values as the model hands them to the kernels."""
    from repro_torch import configs
    from repro_torch.bench import fed_lm
    from repro_torch.core.qat import QATConfig
    from repro_torch.data import LMBatcher, silo_stream
    from repro_torch.kernels import dispatch
    from repro_torch.models import registry

    cfg = configs.get(LM_ARCH)
    model = registry.get_model(cfg)
    params = model.init(0, device=dev)
    x, y = fed_lm.client_data(1, 1, 64, cfg.vocab)
    b, seq = TRAIN_BATCH
    trainer = LMBatcher(silo_stream(cfg.vocab, b * (seq + 1) * 64, 0, 0), b, seq)(0)
    cases = []
    real = dispatch.qat_matmul
    for label, batch in (("tinyllama 4x64", {"tokens": x[0, :4], "labels": y[0, :4]}),
                         (f"trainer {b}x{seq}", {k: torch.from_numpy(v)
                                                 for k, v in trainer.items()})):
        seen = {}

        def record(x2, w, beta, alpha, fmt):
            key = (x2.shape[0], x2.shape[1], w.shape[1])
            if key not in seen:
                seen[key] = tuple(t.detach().clone() for t in (x2, w, beta, alpha))
            return real(x2, w, beta, alpha, fmt)

        dispatch.qat_matmul = record
        try:
            with torch.no_grad():
                model.train_loss(params, {k: v.to(dev) for k, v in batch.items()},
                                 QATConfig())
        finally:
            dispatch.qat_matmul = real
        cases += [(f"{label} {k}", *v) for k, v in seen.items()]
    del params
    torch.cuda.empty_cache()
    return cases


def _lm_real_step_clips(dev) -> dict:
    """Every B11 call of one real full-width local step (``fed_lm``'s client
    0, first batch of 4 x 64 tokens, the port's init weights), captured as
    ``lm_dw_study.py`` captures them: dx's g_beta and dw's g_alpha held to
    ``ref.clip_within_bar``, the distance from the f64 cotangent of the
    twin's quantized operands over the magnitude sum of its terms at most
    max(4x the twin's own, 2^-20); the twin is run only where the kernel is
    past 2^-20. Their terms cancel up to ~1e5-fold, so GA_RTOL, a bound
    relative to the result, gates only the smoke's non-cancelling
    cotangent. Returns the worst distance of each kernel."""
    from repro_torch import configs, tree
    from repro_torch.bench import fed_lm
    from repro_torch.core.fp8 import E4M3
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import fp8_matmul as FM
    from repro_torch.kernels import ref as R
    from repro_torch.models import registry

    t0 = time.perf_counter()
    cfg = configs.get(LM_ARCH)
    model = registry.get_model(cfg)
    params = model.init(0, device=dev)
    xs, ys = fed_lm.client_data(1, 1, 64, cfg.vocab)
    names = [n for n, _ in tree.flatten(params)]
    leaves = [t.detach().requires_grad_() for t in tree.leaves(params)]
    calls = {name: [] for name in ("qat_matmul_dx", "qat_matmul_dw")}
    real = {name: getattr(FM, name) for name in calls}

    def capture(name):
        def fn(g, x, w, beta, alpha, fmt=E4M3):
            out = real[name](g, x, w, beta, alpha, fmt)
            calls[name].append((g.clone(), x.clone(), w, beta.clone(), alpha.clone(), fmt,
                                float(out[1])))
            return out
        return fn
    for name in calls:
        setattr(FM, name, capture(name))
    try:
        loss = model.train_loss(tree.unflatten(names, leaves),
                                {"tokens": xs[0, :4].to(dev), "labels": ys[0, :4].to(dev)},
                                QATConfig())
        torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for name in calls:
            setattr(FM, name, real[name])
    del loss, leaves, params
    worst = {}
    for name, got in calls.items():
        dx = name == "qat_matmul_dx"
        twin = R.qat_matmul_dx if dx else R.qat_matmul_dw
        e_max, cancel, twins, shapes = 0.0, 0.0, 0, set()
        for g, x, w, beta, alpha, fmt, kv in got:
            clip64, mag = R.qat_clip_f64(g, x, w, beta, alpha, fmt, dx=dx)
            ok, e, e_t = R.clip_within_bar(
                kv, clip64, mag, lambda: float(twin(g, x, w, beta, alpha, fmt)[1]))
            twins += e_t is not None
            shp = (x.shape[0], x.shape[1], w.shape[1])
            shapes.add(shp)
            check(ok, f"{name} {shp}: clip cotangent {e:.3g} of its terms' magnitude sum from "
                  f"the f64 one, beyond max({R.BAR_FACTOR:g} x the twin's {e_t}, 2^-20)")
            e_max = max(e_max, e)
            cancel = max(cancel, mag / max(abs(clip64), 1e-300))
        worst[name] = e_max
        print(f"[lm-kernels] real step: {len(got)} {name} calls at {len(shapes)} shapes, "
              f"{'g_beta' if dx else 'g_alpha'} within {e_max:.3g} of its terms' magnitude "
              f"sum from f64 (worst ratio to 2^-20 {e_max / R.BAR_FLOOR:.3g}; twin run at "
              f"{twins}), terms cancelling up to {cancel:.3g}x")
        got.clear()
    torch.cuda.empty_cache()
    print(f"[lm-kernels] real-step clip check {time.perf_counter() - t0:.1f} s")
    return worst


def lm_kernel_phase(dev) -> dict:
    """B10 and both B11 kernels against their twins at every distinct
    projection shape of the LM paths (``fed_lm`` and the trainer at
    opt_level 0) and at a ragged shape. B10's out, dx's gx and dw's gw,
    summed by bf16 tensor cores, against the f64 product of the twin's
    quantized operands (``ref.qat_matmul_f64``, ``qat_matmul_dx_f64``,
    ``qat_matmul_dw_f64``): per element ``|out - ref64| / mag``, the
    kernel's worst at most 4x the twin's own or 2^-20 (``ref.within_bar``);
    gx and gw nonzero only where the masked f64 product is
    (``ref.stray_nonzeros``: every masked element zero); g_beta / g_alpha
    within GA_RTOL; each kernel's second call on the same inputs bitwise equal to
    its first. The cotangent is ``|N(0, 1)| * sign(out)``,
    the gradient of a weighted L1 of the output, so ``g @ wq^T`` leans with x
    and the clip sums do not cancel. Times: the wrapper call and the twin
    (CUDA events), and ``torch.matmul`` on the pre-quantized operands (TF32
    off), the one PyTorch call for the same product. Bound: bytes (each input
    read once, each output written once) over 3.35 TB/s or 2 M N K over the
    bf16 dense peak, the larger. ``max_abs_err``: each output against ref64,
    and each clip cotangent's distance from the twin's. Then every B11 call
    of one real full-width step, its clip cotangent against the magnitude
    bar (``_lm_real_step_clips``)."""
    from repro_torch.kernels import fp8_matmul as FM
    from repro_torch.kernels import ref as R

    g = torch.Generator().manual_seed(7)
    t_phase = time.perf_counter()
    cases = _lm_projection_cases(dev)
    print(f"[lm-kernels] operands of two full-width forwards in "
          f"{time.perf_counter() - t_phase:.1f} s")
    m, k, n = LM_RAGGED
    w = (torch.randn((k, n), generator=g) / math.sqrt(k)).to(dev)
    cases.append(("ragged", (torch.randn((m, k), generator=g) * 1.5).to(dev), w,
                  torch.tensor(2.5, device=dev), w.abs().max().reshape(1, 1)))
    worst = dict.fromkeys(QAT_MATMUL, 0.0)
    errors = {}
    timings = {name: {} for name in QAT_MATMUL}
    for label, x, w, beta, alpha in cases:
        t_case = time.perf_counter()
        m, k, n = x.shape[0], x.shape[1], w.shape[1]
        rout = R.qat_matmul(x, w, beta, alpha)
        gr = (torch.randn((m, n), generator=g).abs().to(dev) * torch.sign(rout)).contiguous()
        got = {"qat_matmul": (FM.qat_matmul(x, w, beta, alpha), None)}
        want = {"qat_matmul": (rout, None)}
        for name in ("qat_matmul_dx", "qat_matmul_dw"):
            got[name] = getattr(FM, name)(gr, x, w, beta, alpha)
            want[name] = getattr(R, name)(gr, x, w, beta, alpha)
        again = {"qat_matmul": (FM.qat_matmul(x, w, beta, alpha), None),
                 **{name: getattr(FM, name)(gr, x, w, beta, alpha)
                    for name in ("qat_matmul_dx", "qat_matmul_dw")}}
        for name in QAT_MATMUL:
            check(all(a is b or torch.equal(a, b) for a, b in zip(got[name], again[name])),
                  f"{name} {label} {(m, k, n)}: two calls differ")
        errs = {}
        for name, f64 in (("qat_matmul", lambda: R.qat_matmul_f64(x, w, beta, alpha)),
                          ("qat_matmul_dx", lambda: R.qat_matmul_dx_f64(gr, x, w, beta, alpha)),
                          ("qat_matmul_dw", lambda: R.qat_matmul_dw_f64(gr, x, w, beta, alpha))):
            ref64, mag = f64()
            e_k = R.product_error(got[name][0], ref64, mag)
            e_t = R.product_error(want[name][0], ref64, mag)
            errs[name] = (e_k, e_t)
            check(R.within_bar(e_k, e_t), f"{name} {label} {(m, k, n)}: error {e_k:.4g} "
                  f"beyond max({R.BAR_FACTOR:g} x twin's {e_t:.4g}, 2^-20)")
            worst[name] = max(worst[name],
                              float((got[name][0].double() - ref64).abs().max()))
            if name != "qat_matmul":
                bad = R.stray_nonzeros(got[name][0], ref64)
                check(bad == 0, f"{name} {label} {(m, k, n)}: {bad} elements nonzero where "
                      "the masked f64 product is zero")
            del ref64, mag
        clips = {}
        for name in ("qat_matmul_dx", "qat_matmul_dw"):
            gc, wc = float(got[name][1]), float(want[name][1])
            rel = abs(gc - wc) / max(abs(wc), 1e-30)
            check(rel <= GA_RTOL, f"{name} {label}: clip cotangent rel err {rel:.3g}")
            worst[name] = max(worst[name], abs(gc - wc))
            clips[name] = (gc, wc, rel)
        errors[(m, k, n)] = errs
        del got, want, again
        xq, wq = R.quant_det(x, beta), R.quant_det(w, alpha)
        ops = 2.0 * m * k * n
        io = {"qat_matmul": 4.0 * (m * k + k * n + m * n),
              "qat_matmul_dx": 4.0 * (m * n + k * n + 2 * m * k),
              "qat_matmul_dw": 4.0 * (m * n + m * k + 2 * k * n)}
        calls = {
            "qat_matmul": (lambda: FM.qat_matmul(x, w, beta, alpha),
                           lambda: R.qat_matmul(x, w, beta, alpha),
                           lambda: torch.matmul(xq, wq)),
            "qat_matmul_dx": (lambda: FM.qat_matmul_dx(gr, x, w, beta, alpha),
                              lambda: R.qat_matmul_dx(gr, x, w, beta, alpha),
                              lambda: torch.matmul(gr, wq.t())),
            "qat_matmul_dw": (lambda: FM.qat_matmul_dw(gr, x, w, beta, alpha),
                              lambda: R.qat_matmul_dw(gr, x, w, beta, alpha),
                              lambda: torch.matmul(xq.t(), gr)),
        }
        for name, (kern, twin, lib) in calls.items():
            b_ms, b_by = max((io[name] / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops / BF16_OPS_PER_S * 1e3, "operations"))
            timings[name][(m, k, n)] = {
                "ms": time_ms(kern, reps=5, iters=10, warmup=2),
                "plain_ms": time_ms(twin, reps=3, iters=1, warmup=1),
                "library_ms": time_ms(lib, reps=5, iters=10, warmup=2),
                "bound_ms": b_ms, "bound_by": b_by, "shape": [m, k, n]}
            if name in errs:
                timings[name][(m, k, n)]["err"], timings[name][(m, k, n)]["err_twin"] = \
                    errs[name]
        t = {name: timings[name][(m, k, n)] for name in QAT_MATMUL}
        print(f"[lm-kernels] {label} (M, K, N) = {(m, k, n)}: "
              + "; ".join(f"{name} err {e_k:.4g} (twin {e_t:.4g})"
                          for name, (e_k, e_t) in errs.items())
              + ", masked zeros held, all repeat bitwise; "
              + "; ".join(f"{name} {t[name]['ms']:.4f} ms (twin {t[name]['plain_ms']:.2f}, "
                          f"matmul {t[name]['library_ms']:.4f}, bound {t[name]['bound_ms']:.5f} "
                          f"{t[name]['bound_by']})" for name in QAT_MATMUL)
              + "; clip cotangents kernel/twin/rel "
              + ", ".join(f"{a:.9g}/{b:.9g}/{r:.2g}" for a, b, r in clips.values())
              + f" ({time.perf_counter() - t_case:.1f} s)")
        del xq, wq, gr
    slower = [(name, shp) for name in QAT_MATMUL
              for shp, t in timings[name].items() if t["ms"] > t["library_ms"]]
    print(f"[lm-kernels] B10 / dx / dw slower than torch.matmul at: {slower or 'no shape'}")
    clips = _lm_real_step_clips(dev)
    print(f"[lm-kernels] phase {time.perf_counter() - t_phase:.1f} s")
    return {"worst": worst, "timings": timings, "real_step_clips": clips}


def lm_wire_phase(dev) -> dict:
    """The FP8 wire pair at the LM cell's own wire plane (full-width
    TinyLlama-1.1B's init weights in the wire's tiles, with the per-element
    alpha tiles its encode hands the kernels, ``qat_probe.lm_wire_plane``),
    E4M3 as the cell runs it, det and counter-RNG, that layout and its
    (R, 1) column: B3's codes and B4's values bitwise against the twins (in
    row chunks, the counter bits at each chunk's rows), two calls bitwise
    equal, one launch a call; each timed (CUDA events) beside its bytes
    bound. Returns the timings of the cell's own case (rand, per element)."""
    import qat_probe
    from repro_torch.core.fp8 import E4M3
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R

    t0 = time.perf_counter()
    x, a_full, col = qat_probe.lm_wire_plane(dev)
    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    n, rows = x.numel(), x.shape[0]
    timings = {}
    for layout, a2 in (("full", a_full), ("column", col)):
        for rnd, k in (("rand", key), ("det", None)):
            r = qat_probe.wire_check(K, R, x, a2, k, E4M3, qat_probe.WIRE_CHUNK)
            label = f"lm {layout} {rnd}"
            check(r["bad_codes"] == 0 and r["bad_values"] == 0,
                  f"{label}: {r['bad_codes']} codes and {r['bad_values']} values differ")
            check(r["repeat_bitwise"] and r["one_launch_each"],
                  f"{label}: two calls differ or not one launch a call ({r})")
            codes = K.quant_pack_tiles(x, a2, k)
            b_pack, b_unpack = qat_probe.wire_bytes(n, rows, layout == "full", k is not None)
            for name, fn, n_bytes in (
                    ("quant_pack_tiles", lambda: K.quant_pack_tiles(x, a2, k), b_pack),
                    ("unpack_tiles", lambda: K.unpack_tiles(codes, a2), b_unpack)):
                ms = time_ms(fn, reps=5, iters=5, warmup=2)
                b_ms, b_by = bound(n_bytes, 0)
                timings.setdefault(name, {})[label] = dict(
                    ms=ms, bound_ms=b_ms, bound_by=b_by, shape=[rows, 1024])
                print(f"[time] {name:17s} {label:15s} {str((rows, 1024)):18s} kernel "
                      f"{ms:.5f} ms  bound {b_ms:.6f} ms ({b_by}, "
                      f"{100 * b_ms / ms:.1f}% of it)")
            del codes
    print(f"[lm-wire] B3/B4 at the LM wire plane {(rows, 1024)}: codes and values bitwise the "
          f"twins' (det and rand, per-element alpha and its column), two calls equal, one "
          f"launch a call; alpha constant along every row: {bool((a_full == col).all())} "
          f"({time.perf_counter() - t0:.1f} s)")
    del x, a_full, col
    torch.cuda.empty_cache()
    return {name: t["lm full rand"] for name, t in timings.items()}


def lm_card_vs_cpu_phase(dev) -> None:
    """One reduced-TinyLlama local step (loss, every gradient, one AdamW(1e-3)
    update) on the card against the same step on the CPU twins, from the
    same weights and tokens. B10, dx and dw sum in another order than their
    twins (a few f32 ULP of their terms); the card's bf16 elementwise ops,
    exp / rsqrt / sin / cos and
    attention sums differ from the CPU's in the last bits, and an FP8
    activation code near a midpoint then takes the other grid point and
    moves its token row: the bars of the CPU parity test against the
    reference (``tests/test_torch_lm.py``): loss within 2e-3, each weight,
    norm and embedding gradient within 0.25 of its magnitude sum, each clip
    gradient within 0.25 of the largest, each updated parameter within 2 lr
    (AdamW's first step is +-lr an element). Each B10/B11 kernel must launch
    once a projection (3 layers x 7 + 2 CE chunks)."""
    from repro_torch import configs, optim, tree
    from repro_torch.bench import fed_lm
    from repro_torch.core.qat import QATConfig
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.models import registry

    cfg = configs.reduced(configs.get(LM_ARCH))
    model = registry.get_model(cfg)
    x, y = fed_lm.client_data(1, 1, 64, cfg.vocab)
    p_cpu = model.init(0, device="cpu")
    lr = 1e-3
    out = {}
    t_phase = time.perf_counter()
    for where in ("cpu", dev):
        p = tree.tree_map(lambda t: t.to(where), p_cpu)
        names = [n for n, _ in tree.flatten(p)]
        leaves = [t.detach().clone().requires_grad_() for t in tree.leaves(p)]
        K.reset_launches()
        loss = model.train_loss(tree.unflatten(names, leaves),
                                {"tokens": x[0].to(where), "labels": y[0].to(where)},
                                QATConfig())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(v) if gr is None else gr for v, gr in zip(leaves, grads)]
        opt = optim.adamw(lr, weight_decay=0.01)
        upd, _ = opt.update(tree.unflatten(names, grads), opt.init(p), p, 0)
        new = optim.apply_updates(p, upd)
        synchronize()
        launches = dict(K.LAUNCHES)
        out[str(where)] = (float(loss.detach()), dict(zip(names, grads)), new, launches)
    (l_c, g_c, p_c, _), (l_g, g_g, p_g, launches) = out["cpu"], out[str(dev)]
    for name in QAT_MATMUL:
        check(launches[name] == 3 * 7 + 2, f"lm step on the card: {name} launched "
              f"{launches[name]} times, not 23")
    clip_scale = max(float(v.abs().max()) for n, v in g_c.items()
                     if n.endswith(("_qa", "_qb")))
    worst_w = worst_c = 0.0
    for name, r in g_c.items():
        d = (g_g[name].cpu().double() - r.double()).abs()
        if name.endswith(("_qa", "_qb")):
            worst_c = max(worst_c, float(d.max()) / clip_scale)
        else:
            worst_w = max(worst_w, float(d.sum()) / max(float(r.double().abs().sum()), 1e-30))
    p_ref = dict(tree.flatten(p_c))
    worst_p = max(float((v.cpu() - p_ref[n]).abs().max()) for n, v in tree.flatten(p_g))
    print(f"[lm-round] reduced tinyllama local step, card vs CPU twins: loss {l_g:.7f} vs "
          f"{l_c:.7f}; worst weight-gradient gap {worst_w:.3g} of its magnitude sum, worst "
          f"clip-gradient gap {worst_c:.3g} of the largest; updated params within "
          f"{worst_p:.3g} (2 lr = {2 * lr}); B10/B11 launches {[launches[k] for k in QAT_MATMUL]} "
          f"({time.perf_counter() - t_phase:.1f} s)")
    check(abs(l_g - l_c) <= 2e-3 * abs(l_c), f"lm step: loss {l_g} vs cpu {l_c}")
    check(worst_w <= 0.25 and worst_c <= 0.25, "lm step: a gradient is beyond its bar")
    check(worst_p <= 2 * lr + 1e-6, f"lm step: a parameter moved {worst_p} apart")


def _profile_kernels(prof, wall_us: float, s_round: float, label: str,
                     instances: dict | None = None) -> dict:
    """Device busy share and the top kernels of a ``torch.profiler`` window;
    returns the device us per call of each wrapper in ``instances`` (name:
    its CUDA name, or the names of every CUDA kernel one call launches, the
    first its main kernel, which may run as several template instances;
    each other kernel launches once a call, and may be shared with another
    wrapper; the B10/B11 kernels by default)."""
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy = sum(dev_time(e) for e in rows)
    print(f"[profile] {label}: device busy {busy / 1e3:.1f} ms = "
          f"{100 * busy / (s_round * 1e6):.1f}% of the unprofiled {s_round:.3f} s "
          f"({100 * busy / wall_us:.1f}% of the profiled wall {wall_us / 1e6:.3f} s), "
          f"{len(rows)} kernel names")
    for e in sorted(rows, key=dev_time, reverse=True)[:14]:
        print(f"[profile]   {dev_time(e) / 1e3:10.3f} ms  x{e.count:<7d} {e.key[:100]}")
    per_launch = {}
    for name, inst in (instances or QAT_GEMM_INSTANCE).items():
        main, *others = (inst,) if isinstance(inst, str) else inst
        mains = [e for e in rows if main in e.key]
        calls = sum(e.count for e in mains)
        if not calls:
            continue
        per_launch[name] = sum(dev_time(e) for e in mains) / calls
        for e in mains + [e for part in others for e in rows if part in e.key]:
            print(f"[profile] ours: {name:14s} x{e.count:<6d} "
                  f"{dev_time(e) / max(e.count, 1):.2f} us of device time per launch "
                  f"in {e.key[:60]}")
            if e not in mains:
                per_launch[name] += dev_time(e) / max(e.count, 1)
        print(f"[profile] ours: {name:14s} {per_launch[name]:.2f} us a call ({calls} calls)")
    return {"busy_ms": busy / 1e3, "device_us": per_launch}


def lm_main_path_phase(dev) -> dict:
    """``repro_torch.bench.fed_lm`` on full-width TinyLlama-1.1B with the
    example's defaults (8 clients, 4 active, 8 local AdamW steps at batch 4,
    sequence 64, det E4M3 QAT, the E4M3 stochastic wire both ways, the
    weighted mean), 2 rounds, the counters zeroed just before and read just
    after; the second round runs under ``torch.profiler``. Each round's wire
    bytes must be the reference's 8802606752, each B10/B11 kernel must
    launch 5184 times a round and the wire pair 5 times, and the loss must
    be finite."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench import fed_lm
    from repro_torch.kernels import fp8_quant as K

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wrap = lambda r: prof if r == LM_ROUNDS - 1 else contextlib.nullcontext()
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    rows = fed_lm.run(arch=LM_ARCH, rounds=LM_ROUNDS, device=dev, wrap_round=wrap,
                      log=lambda s: print(f"[lm] {s}"))
    synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    for r in rows:
        check(r["wire_bytes"] == LM_ROUND_BYTES,
              f"lm round {r['round']}: wire bytes {r['wire_bytes']} != {LM_ROUND_BYTES}")
        check(math.isfinite(r["local_loss"]), f"lm round {r['round']}: loss {r['local_loss']}")
        for name in QAT_MATMUL:
            check(r["launches"][name] == LM_ROUND_LAUNCHES,
                  f"lm round {r['round']}: {name} launched {r['launches'][name]} times, "
                  f"not {LM_ROUND_LAUNCHES}")
        for name in ("quant_pack_tiles", "unpack_tiles"):
            check(r["launches"][name] == LM_WIRE_LAUNCHES,
                  f"lm round {r['round']}: {name} launched {r['launches'][name]} times")
    for name in QAT_MATMUL:
        check(launches[name] == LM_ROUNDS * LM_ROUND_LAUNCHES, f"{name}: {launches[name]}")
    s_round = rows[0]["s_per_round"]
    peak = max(r["peak_mem_bytes"] for r in rows)
    print(f"[lm] full tinyllama, {LM_ROUNDS} rounds in {wall:.1f} s: s/round "
          f"{[round(r['s_per_round'], 3) for r in rows]} (round 2 profiled), loss "
          f"{[round(r['local_loss'], 4) for r in rows]}, wire bytes/round "
          f"{rows[0]['wire_bytes']}, peak device memory {peak} B "
          f"({peak / 2 ** 30:.2f} GiB), launches {launches}")
    prof_wall = rows[-1]["s_per_round"] * 1e6
    stats = _profile_kernels(prof, prof_wall, s_round, "lm round 2",
                             {**QAT_GEMM_INSTANCE, **LM_WIRE_INSTANCE})
    print(f"[lm] profiled round 2: " + "; ".join(
        f"{name} {stats['device_us'].get(name, float('nan')):.2f} us of device time a launch"
        for name in LM_WIRE_INSTANCE))
    return {"launches": launches, "s_per_round": s_round, "peak_mem_bytes": peak, **stats}


# ---------------------------------------------------------------------------
# phase 8: the one-device LM trainer (full-width TinyLlama-1.1B) on B7
# ---------------------------------------------------------------------------

TRAIN_STEPS = 20                    # of launch.train at the reference's defaults
TRAIN_PROFILED = 10                 # the step run under torch.profiler
TRAIN_OPT0_STEPS = 2                # opt_level 0: every projection on B10/B11
FULL_PLANE_ROWS = 1074176           # 43008 rows a layer x 22 + lm_head and embed 64000 each
TRAIN_KERNELS = ("quant_det_tiles", "quant_det_tiles_bwd")
TRAINER_INSTANCES = {   # kernel: its CUDA name in a profile
    "quant_det_tiles": "quant_det_tiles_kernel",
    "quant_det_tiles_bwd": "quant_det_tiles_bwd_kernel",
    "quant_det": "quant_det_kernel<__nv_bfloat16, 0>",
    "quant_det_bwd": "quant_det_bwd_kernel<__nv_bfloat16, 0>",
}


def _b7_case(label, x, col, g, worst, timed: bool) -> dict:
    """B7 forward and backward against their twins: out and gx bitwise,
    each row's clip cotangent within GA_RTOL of its terms' magnitude sum
    (g signed like x, so the clipped terms add up). ``timed``: each beside
    its twin and its bound."""
    from repro_torch.core.fp8 import E4M3
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R

    n, rows = x.numel(), x.shape[0]
    bad, err = mismatches(K.quant_det_tiles(x, col), R.quant_det_tiles(x, col))
    worst["quant_det_tiles"] = max(worst["quant_det_tiles"], err)
    check(bad == 0, f"quant_det_tiles {label} {tuple(x.shape)}: {bad} of {n} differ")
    gx, ga = K.quant_det_tiles_bwd(x, col, g)
    rgx, rga = R.quant_det_tiles_bwd(x, col, g)
    bad, err = mismatches(gx, rgx)
    del gx, rgx
    torch.cuda.empty_cache()
    # a row's clip terms inside the clip, g * (q - y) * s / a, take either
    # sign whatever g's, so a row sum may cancel: each row is held to its
    # terms' magnitude sum (the twin's own terms)
    mag = R._ste(x, col, g, E4M3)[1].abs_().sum(dim=1, keepdim=True)
    torch.cuda.empty_cache()
    rel = float(((ga - rga).abs() / mag.clamp(min=1e-30)).max())
    worst["quant_det_tiles_bwd"] = max(worst["quant_det_tiles_bwd"], err,
                                       float((ga - rga).abs().max()))
    check(bad == 0, f"quant_det_tiles_bwd gx {label}: {bad} of {n} differ")
    check(rel <= GA_RTOL, f"quant_det_tiles_bwd ga_row {label}: {rel:.3g} of its terms' "
          "magnitude sum")
    print(f"[trainer-kernels] B7 {label} {tuple(x.shape)}: out and gx bitwise, ga_row within "
          f"{rel:.3g} of its terms' magnitude sum (worst row)")
    if not timed:
        return {}
    cases = {"quant_det_tiles": (lambda: K.quant_det_tiles(x, col),
                                 lambda: R.quant_det_tiles(x, col), 8 * n + 4 * rows, 15 * n),
             "quant_det_tiles_bwd": (lambda: K.quant_det_tiles_bwd(x, col, g),
                                     lambda: R.quant_det_tiles_bwd(x, col, g),
                                     12 * n + 8 * rows, 25 * n)}
    out = {}
    for name, (kern, twin, n_bytes, n_ops) in cases.items():
        b_ms, b_by = bound(n_bytes, n_ops)
        out[name] = dict(ms=time_ms(kern, reps=5, iters=10, warmup=2),
                         plain_ms=time_ms(twin, reps=3, iters=1, warmup=1),
                         bound_ms=b_ms, bound_by=b_by, shape=list(x.shape))
        torch.cuda.empty_cache()
        print(f"[time] {name:19s} {label:9s} {str(tuple(x.shape)):16s} kernel "
              f"{out[name]['ms']:.5f} ms  twin {out[name]['plain_ms']:.5f} ms  bound "
              f"{b_ms:.6f} ms ({b_by})")
    return out


def trainer_kernel_phase(dev) -> dict:
    """The trainer's kernels against their twins on the card: B7 at the
    full-width TinyLlama-1.1B plane (its init weights packed as the trainer
    packs them, each row with its segment's clip), at the reduced model's
    plane and at a ragged multi-block plane of stacked segments; B9 in both
    RNG modes and both alpha layouts at LeNet's plane (135, 1024) and at
    (8191, 1024), its values bitwise against B5 (kernel and twin) and its
    row max equal to ``torch.amax``; the bf16 B1/B2 instances at the
    trainer's activation shapes (batch 8 x 128 tokens). Each is timed beside
    its twin and its bound."""
    from repro_torch import configs
    from repro_torch.core import plane
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R
    from repro_torch.models import registry

    t_phase = time.perf_counter()
    g = torch.Generator().manual_seed(11)
    worst = dict.fromkeys((*TRAIN_KERNELS, "fake_quant_amax_tiles"), 0.0)
    timings = {}

    def signed_like(x):
        return (torch.randn(x.shape, generator=g).abs().to(dev) * torch.sign(x)).contiguous()

    # ragged, multi-block: a stacked leaf's 3 layers, then 2 single leaves
    seg_rows = (2000, 2000, 2000, 191, 7)
    x = (torch.randn((sum(seg_rows), 1024), generator=g) * 0.2).to(dev)
    col = torch.empty((x.shape[0], 1), device=dev)
    r0 = 0
    for i, n in enumerate(seg_rows):
        col[r0:r0 + n] = x[r0:r0 + n].abs().max() * (0.6 + 0.1 * i)
        x[r0 + n - 1, 600:] = 0.0
        r0 += n
    _b7_case("ragged", x, col, signed_like(x), worst, False)
    for reduced in (True, False):
        cfg = configs.get(LM_ARCH)
        cfg = configs.reduced(cfg) if reduced else cfg
        params = registry.get_model(cfg).init(0, device=dev)
        spec = plane.make_plane_spec(params)
        x2, alphas = plane.pack_tiles(params, spec)
        col = plane.alpha_column(alphas, spec)
        del params
        torch.cuda.empty_cache()
        label = "reduced" if reduced else "full"
        if not reduced:
            whole = all(sz == r * 1024 for sz, r in zip(spec.seg_sizes, spec.seg_rows))
            check(spec.n_rows == FULL_PLANE_ROWS and whole,
                  f"full plane: {spec.n_rows} rows, whole rows a segment: {whole}")
            print(f"[trainer-kernels] full-width plane {tuple(x2.shape)} in {spec.n_seg} "
                  f"segments of whole rows ({len(spec.q_slots)} leaves)")
        timings[label] = _b7_case(label, x2, col, signed_like(x2), worst, not reduced)
        del x2, col
        torch.cuda.empty_cache()

    # B9 through its kernel, against B5 and the row max
    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    b9_timings = {}
    for label, shape in (("main", (135, 1024)), ("large", LARGE)):
        x = (torch.randn(shape, generator=g) * 0.2).to(dev)
        c = x.abs().amax(dim=1, keepdim=True) * 0.9
        for a2 in (c, c.expand(shape).contiguous()):
            for k2 in (None, key):
                q, mx = K.fake_quant_amax_tiles(x, a2, k2)
                rq, rmx = R.fake_quant_amax_tiles(x, a2, k2)
                bad, err = mismatches(q, rq)
                worst["fake_quant_amax_tiles"] = max(worst["fake_quant_amax_tiles"], err)
                check(bad == 0 and torch.equal(q, K.fake_quant_tiles(x, a2, k2)),
                      f"fake_quant_amax_tiles {label} a{tuple(a2.shape)}: values != B5")
                check(torch.equal(mx, rmx) and torch.equal(mx, torch.amax(x.abs(), 1,
                                                                          keepdim=True)),
                      f"fake_quant_amax_tiles {label}: rowmax != the twin's or torch.amax")
        n, rows = x.numel(), shape[0]
        b_ms, b_by = bound(8 * n + 8 * rows + 8, 40 * n)
        b9_timings[label] = dict(ms=time_ms(lambda: K.fake_quant_amax_tiles(x, c, key)),
                                 plain_ms=time_ms(lambda: R.fake_quant_amax_tiles(x, c, key),
                                                  reps=5, iters=10),
                                 bound_ms=b_ms, bound_by=b_by, shape=list(shape))
        t = b9_timings[label]
        print(f"[trainer-kernels] B9 {label} {shape}: det and rand, alpha column and per "
              f"element: bitwise against B5, row max == torch.amax; kernel {t['ms']:.5f} ms "
              f"twin {t['plain_ms']:.5f} ms bound {b_ms:.6f} ms ({b_by})")
    timings["fake_quant_amax_tiles"] = b9_timings

    # bf16 B1/B2 at the trainer's activation shapes, at odd n and misaligned
    import qat_probe
    qat_pair_edge_cases(dev, torch.bfloat16, dict.fromkeys(("quant_det", "quant_det_bwd"), 0.0))
    bf16 = {}
    for shape in ((8, 128, 2048), (8, 128, 5632), (8, 16, 2048)):
        x = (torch.randn(shape, generator=g) * 1.5).to(dev).to(torch.bfloat16)
        gr = signed_like(x.float()).to(torch.bfloat16)
        for a in (torch.tensor(4.0, device=dev), torch.tensor(2.7, device=dev)):
            check(torch.equal(K.quant_det(x, a), R.quant_det(x, a)),
                  f"quant_det bf16 {shape}: differs from its twin")
            gx, ga = K.quant_det_bwd(x, a, gr)
            rgx, rga = R.quant_det_bwd(x, a, gr)
            rel = abs(float(ga) - float(rga)) / max(abs(float(rga)), 1e-30)
            check(torch.equal(gx, rgx) and gx.dtype == torch.bfloat16,
                  f"quant_det_bwd bf16 gx {shape}")
            check(rel <= GA_RTOL, f"quant_det_bwd bf16 g_alpha {shape}: rel err {rel:.3g}")
        n = x.numel()
        a = torch.tensor(4.0, device=dev)
        bf16[str(shape)] = {
            "quant_det": dict(ms=time_ms(lambda: K.quant_det(x, a)),
                              plain_ms=time_ms(lambda: R.quant_det(x, a), reps=5, iters=10),
                              bound_ms=bound(4 * n + 4, 12 * n)[0]),
            "quant_det_bwd": dict(ms=time_ms(lambda: K.quant_det_bwd(x, a, gr)),
                                  plain_ms=time_ms(lambda: R.quant_det_bwd(x, a, gr),
                                                   reps=5, iters=10),
                                  bound_ms=bound(6 * n + 8, 20 * n)[0])}
        t = bf16[str(shape)]
        t["quant_det"]["device_us"] = qat_probe.device_us(lambda: K.quant_det(x, a))
        t["quant_det_bwd"]["device_us"] = qat_probe.device_us(lambda: K.quant_det_bwd(x, a, gr))
        for v in t.values():
            v["fraction"] = v["bound_ms"] * 1e3 / v["device_us"]
        print(f"[trainer-kernels] bf16 quant_det/bwd {shape}: bitwise, g_alpha within GA_RTOL; "
              f"device {t['quant_det']['device_us']:.3f} / {t['quant_det_bwd']['device_us']:.3f} "
              f"us a call ({100 * t['quant_det']['fraction']:.1f}% / "
              f"{100 * t['quant_det_bwd']['fraction']:.1f}% of the bytes bound "
              f"{t['quant_det']['bound_ms'] * 1e3:.3f} / {t['quant_det_bwd']['bound_ms'] * 1e3:.3f} "
              f"us); back-to-back calls {t['quant_det']['ms']:.5f} / "
              f"{t['quant_det_bwd']['ms']:.5f} ms (the host's), twin "
              f"{t['quant_det']['plain_ms']:.5f} / {t['quant_det_bwd']['plain_ms']:.5f} ms")
    timings["bf16"] = bf16
    # what bounds them: copy and arithmetic probes, SASS counts
    timings["qat_probe"] = qat_probe.measure(dev, K)
    print(f"[trainer-kernels] phase {time.perf_counter() - t_phase:.1f} s")
    return {"worst": worst, "timings": timings}


def b9_path_phase(dev) -> dict:
    """B9's only caller, ``dispatch.fake_quant_amax_plane`` (the reference
    calls it from nowhere), forward and backward on LeNet's real plane with
    the counters zeroed just before and read just after: one launch, the
    values B5's, the backward B5's STE; then its device time a call."""
    from repro_torch.bench import common
    from repro_torch.core import plane
    from repro_torch.kernels import dispatch
    from repro_torch.kernels import fp8_quant as K

    params, _ = common.make_model(common.TASKS["cifar10-lenet"], 0, dev)
    spec = plane.make_plane_spec(params)
    w2, alphas = plane.pack_tiles(params, spec)
    col = plane.alpha_column(alphas, spec)
    key = torch.tensor([5, 6], dtype=torch.int64).to(torch.uint32).to(dev)
    g = torch.randn(w2.shape, generator=torch.Generator().manual_seed(3)).to(dev)
    grads = []
    K.reset_launches()
    for fn in ("fake_quant_amax_plane", "fake_quant_plane"):
        x = w2.clone().requires_grad_()
        a = col.clone().requires_grad_()
        out = getattr(dispatch, fn)(x, a, key)
        q = out[0] if isinstance(out, tuple) else out
        (q * g).sum().backward()
        grads.append((q.detach(), x.grad, a.grad))
        if fn == "fake_quant_amax_plane":
            synchronize()
            launches = dict(K.LAUNCHES)
    for got, want in zip(grads[0], grads[1]):
        check(torch.equal(got, want), "fake_quant_amax_plane: value or gradient != B5's")
    check(launches["fake_quant_amax_tiles"] == 1 and launches["fake_quant_tiles"] == 0,
          f"fake_quant_amax_plane launches {launches}")
    print(f"[b9] dispatch.fake_quant_amax_plane on LeNet's plane {tuple(w2.shape)}: 1 launch, "
          f"values and STE gradients equal to fake_quant_plane's (B5)")
    # B9's device time a launch: 50 more calls under the profiler after the
    # lead-in (a trace without one lost this call's only record, ROADMAP §3
    # mechanism 9), the fake_quant_amax_kernel records of them, over 50;
    # where the profiler gave none, the calls' stream time, so labelled
    import qat_probe

    n_fallbacks = len(qat_probe.FALLBACKS)
    device_us = qat_probe.device_us(lambda: dispatch.fake_quant_amax_plane(w2, col, key),
                                    kernel="fake_quant_amax_kernel")
    timing = "device_us" if len(qat_probe.FALLBACKS) == n_fallbacks else "stream_us"
    what = ("us of device time a call (fake_quant_amax_kernel, one launch a call)"
            if timing == "device_us" else
            "us of STREAM time a call (the profiler gave no device records; every kernel "
            "of the call and the gaps between them count)")
    print(f"[b9] profiled calls: {device_us:.2f} {what}")
    return {"launches": launches, timing: device_us}


def _train_step_grads(model, p, batch, qcfg, opt_level, accum, where, per_leaf=False):
    """One train step from ``p`` on ``where`` with an optimizer that hands
    back the step's gradient as its state: ``(loss, {name: grad},
    launches)``. ``per_leaf``: the weight tree is quantized by
    ``quantize_params_once_per_leaf`` (the plain chain, autograd) in place
    of the plane."""
    from repro_torch import tree
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.launch import steps
    from repro_torch.optim.base import Optimizer

    grads_as_state = Optimizer(init=lambda p: (), update=lambda gr, s, p, t: (
        tree.tree_map(torch.zeros_like, p), gr))
    plane_once = steps.quantize_params_once
    if per_leaf:
        steps.quantize_params_once = lambda params, q, spec=None: \
            steps.quantize_params_once_per_leaf(params, q)
    try:
        step = steps.make_train_step(model, grads_as_state, qcfg, accum=accum,
                                     opt_level=opt_level)
        K.reset_launches()
        _, gr, m = step(tree.tree_map(lambda t: t.to(where), p), (),
                        {k: torch.from_numpy(v).to(where) for k, v in batch.items()}, 0)
        synchronize()
    finally:
        steps.quantize_params_once = plane_once
    return float(m["loss"]), dict(tree.flatten(gr)), dict(K.LAUNCHES)


def trainer_card_vs_cpu_phase(dev) -> None:
    """Reduced-TinyLlama train steps, each one step from the same weights
    and tokens; the optimizer hands back the step's gradient as its state,
    so the gradients themselves are compared.

    As shipped (bf16, QAT on), card against the CPU twins, at opt_level 1
    (accum 1), 0 and 2 (accum 2), at the bars of the CPU parity tests
    against the reference (``tests/test_torch_train.py``, the FP8
    activation-tie mechanism): loss within 2e-3, each weight, norm and
    embedding gradient within 0.25 of its magnitude sum, each clip gradient
    within 0.25 of the largest. B7 launches once forward and once backward a
    step at opt_level >= 1, B10/B11 at every projection at opt_level 0.

    Tie-free, at opt_level 1 (accum 1) and 2 (accum 2): weight-only QAT in
    f32 (activations unquantized, the models' compute dtype f32) on the
    card, the plane step (B7) against the same step with the weight tree
    quantized leaf by leaf by the plain chain under autograd, at the bars of
    ``tests/test_torch_plane_quant.py::test_quantize_params_once_matches_the_per_leaf_loop``,
    with its clips nudged off ``|w| == alpha`` as there: the same quantized weights, so the loss is bitwise equal; each weight
    gradient within 1e-6 of itself element by element (the chain
    multiplies by ``s`` and divides by it again); each weight clip within
    1e-4 of itself (the plane sums rows, then segments); activation clips
    zero. Card against CPU is not tie-free even so: the two devices' log2
    and exp2 differ in the last bit, so a segment's grid scale may differ
    by an ulp and a weight near a rounding boundary takes the neighbouring
    grid point; the phase counts both on the reduced plane and prints the
    card-vs-CPU gaps of the f32 step beside them."""
    from repro_torch import configs, tree
    from repro_torch.core import plane
    from repro_torch.core.qat import QATConfig
    from repro_torch.data import LMBatcher, silo_stream
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R
    from repro_torch.launch import steps
    from repro_torch.models import common, registry, transformer

    cfg = configs.reduced(configs.get(LM_ARCH))
    model = registry.get_model(cfg)
    p_cpu = model.init(0, device="cpu")
    batch = LMBatcher(silo_stream(cfg.vocab, 4 * 65 * 64, 0, 0), 4, 64)(0)
    sites = 7 * cfg.n_layers + cfg.ce_chunks
    clips = lambda g: {n for n in g if n.endswith(("_qa", "_qb"))}

    for opt_level, accum in ((1, 1), (0, 2), (2, 2)):
        tag = f"as shipped opt_level {opt_level} accum {accum}"
        l_c, g_c, _ = _train_step_grads(model, p_cpu, batch, QATConfig(), opt_level, accum,
                                        "cpu")
        l_g, g_g, launches = _train_step_grads(model, p_cpu, batch, QATConfig(), opt_level,
                                               accum, dev)
        if opt_level >= 1:
            check(launches["quant_det_tiles"] == launches["quant_det_tiles_bwd"] == 1
                  and launches["quant_det"] == accum * sites
                  and all(launches[k] == 0 for k in QAT_MATMUL),
                  f"trainer step {tag}: launches {launches}")
        else:
            check(launches["quant_det_tiles"] == 0
                  and all(launches[k] == accum * sites for k in QAT_MATMUL),
                  f"trainer step {tag}: launches {launches}")
        clip_scale = max(float(g_c[n].abs().max()) for n in clips(g_c))
        worst_w = worst_c = 0.0
        for name, r in g_c.items():
            r, d = r.double(), (g_g[name].cpu().double() - r.double()).abs()
            if name in clips(g_c):
                worst_c = max(worst_c, float(d.max()) / clip_scale)
            else:
                worst_w = max(worst_w, float(d.sum()) / max(float(r.abs().sum()), 1e-30))
        print(f"[trainer-step] reduced tinyllama {tag}, card vs CPU twins: loss {l_g:.7f} vs "
              f"{l_c:.7f}; worst weight-gradient gap {worst_w:.3g} of its magnitude sum, worst "
              f"clip-gradient gap {worst_c:.3g} of the largest (bars 0.25, 0.25)")
        check(abs(l_g - l_c) <= 2e-3 * abs(l_c), f"trainer step {tag}: loss {l_g} vs {l_c}")
        check(worst_w <= 0.25 and worst_c <= 0.25, f"trainer step {tag}: a gradient beyond "
              "its bar")

    # tie-free: f32, weight-only QAT, plane against the per-leaf chain on the
    # card; every clip nudged off |w| == alpha, where the chain's autograd
    # splits the subgradient and the kernels do not (tests/test_plane.py:216)
    qcfg = QATConfig(quantize_acts=False)
    flat = tree.flatten(p_cpu)
    p_cpu = tree.unflatten([n for n, _ in flat], [v * 1.05 if n.endswith(("_qa", "_qb"))
                                                  else v for n, v in flat])
    dtypes = [(m, m.COMPUTE_DTYPE) for m in (common, transformer, steps)]
    for m, _ in dtypes:
        m.COMPUTE_DTYPE = torch.float32
    try:
        for opt_level, accum in ((1, 1), (2, 2)):
            tag = f"f32 weight-only opt_level {opt_level} accum {accum}"
            l_p, g_p, launches = _train_step_grads(model, p_cpu, batch, qcfg, opt_level,
                                                   accum, dev)
            l_l, g_l, leaf_launches = _train_step_grads(model, p_cpu, batch, qcfg, opt_level,
                                                        accum, dev, per_leaf=True)
            check(launches["quant_det_tiles"] == launches["quant_det_tiles_bwd"] == 1
                  and leaf_launches["quant_det_tiles"] == 0 and launches["quant_det"] == 0,
                  f"trainer step {tag}: launches {launches} / {leaf_launches}")
            check(l_p == l_l, f"trainer step {tag}: plane loss {l_p} != per-leaf {l_l}")
            worst_w = worst_c = 0.0
            for name, r in g_l.items():
                r, t = r.double(), g_p[name].double()
                if name.endswith("_qb"):
                    check(not r.any() and not t.any(), f"{tag}: {name} not zero")
                    continue
                rel = float(((t - r).abs() / r.abs()).nan_to_num(0.0).max()) if r.any() else \
                    float(t.abs().max())
                if name.endswith("_qa"):
                    check(bool(r.any()), f"{tag}: {name} zero")
                    worst_c = max(worst_c, rel)
                else:
                    worst_w = max(worst_w, rel)
            print(f"[trainer-step] reduced tinyllama {tag}, on the card, plane (B7) vs per-leaf "
                  f"chain: loss {l_p:.7f} == {l_l:.7f}; worst weight gradient {worst_w:.3g} of "
                  f"itself, worst weight clip {worst_c:.3g} of itself (bars 1e-6, 1e-4)")
            check(worst_w <= 1e-6 and worst_c <= 1e-4,
                  f"trainer step {tag}: plane vs per-leaf beyond the bars")
        # card against CPU: the weight codes the two devices' quantizers set apart
        spec = plane.make_plane_spec(p_cpu)
        x2, alphas = plane.pack_tiles(p_cpu, spec)
        col = plane.alpha_column(alphas, spec)
        q_g, q_c = K.quant_det_tiles(x2.to(dev), col.to(dev)).cpu(), R.quant_det_tiles(x2, col)
        d = (q_g - q_c).abs()
        last_bits = int(((d > 0) & (d <= 1e-5 * q_c.abs())).sum())
        flips = int((d > 1e-5 * q_c.abs()).sum())
        l_c, g_c, _ = _train_step_grads(model, p_cpu, batch, qcfg, 1, 1, "cpu")
        l_g, g_g, _ = _train_step_grads(model, p_cpu, batch, qcfg, 1, 1, dev)
    finally:
        for m, d in dtypes:
            m.COMPUTE_DTYPE = d
    worst_w = max(float((g_g[n].cpu().double() - r.double()).abs().sum())
                  / max(float(r.double().abs().sum()), 1e-30)
                  for n, r in g_c.items() if n not in clips(g_c))
    print(f"[trainer-step] reduced tinyllama f32 weight-only opt_level 1, card vs CPU: "
          f"of {x2.numel()} quantized weights, {last_bits} differ between the card's B7 and "
          f"the CPU twin in the last bits (the grid scale from log2/exp2) and {flips} sit on "
          f"another grid point; loss {l_g:.7f} vs {l_c:.7f}, worst weight-gradient gap "
          f"{worst_w:.3g} of its magnitude sum")


def trainer_main_path_phase(dev) -> dict:
    """``repro_torch.launch.train`` at the reference's defaults (full-width
    TinyLlama-1.1B, AdamW 3e-4, batch 8 x 128 tokens, det E4M3 QAT,
    opt_level 1) for TRAIN_STEPS steps, the counters zeroed just before and
    read just after: exactly one B7 forward and one backward a step, B1/B2
    (bf16) at every activation site, no B10/B11, every loss finite; step
    TRAIN_PROFILED runs under ``torch.profiler``. Then TRAIN_OPT0_STEPS
    steps at opt_level 0 show the reverse: B10/B11 at every projection, no
    B7."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.launch import train

    cfg = configs.get(LM_ARCH)
    sites = 7 * cfg.n_layers + cfg.ce_chunks    # aq sites a microbatch: 7 a layer, the head a chunk
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wrap = lambda i: prof if i == TRAIN_PROFILED else contextlib.nullcontext()
    torch.cuda.empty_cache()
    K.reset_launches()
    synchronize()
    t0 = time.perf_counter()
    out = train.run(steps=TRAIN_STEPS, device=dev, wrap_step=wrap,
                    log=lambda s: print(s if s.startswith("[") else f"[train] {s}"))
    synchronize()
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    check(launches["quant_det_tiles"] == launches["quant_det_tiles_bwd"] == TRAIN_STEPS,
          f"B7 launched {launches['quant_det_tiles']} / {launches['quant_det_tiles_bwd']} "
          f"times in {TRAIN_STEPS} steps")
    check(launches["quant_det"] == launches["quant_det_bwd"] == TRAIN_STEPS * sites,
          f"B1/B2 launched {launches['quant_det']} / {launches['quant_det_bwd']} times")
    check(all(launches[k] == 0 for k in QAT_MATMUL), f"B10/B11 launched: {launches}")
    check(all(math.isfinite(v) for v in out["losses"]), f"loss {out['losses']}")
    steady = [t for i, t in enumerate(out["step_s"]) if i not in (0, TRAIN_PROFILED)]
    s_step = statistics.mean(steady)
    peak = out["peak_mem_bytes"]
    print(f"[train] full tinyllama, {TRAIN_STEPS} steps at opt_level 1 in {wall:.1f} s "
          f"(init included): {s_step:.4f} s/step (mean of steps 2-{TRAIN_STEPS} without the "
          f"profiled one; min {min(steady):.4f}, max {max(steady):.4f}), "
          f"{out['tokens_per_step'] / s_step:.1f} tokens/s, first step {out['step_s'][0]:.3f} s, "
          f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, peak device memory {peak} B "
          f"({peak / 2 ** 30:.2f} GiB), launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    stats = _profile_kernels(prof, out["step_s"][TRAIN_PROFILED] * 1e6, s_step,
                             f"train step {TRAIN_PROFILED + 1}", TRAINER_INSTANCES)
    counts = _kernel_counts([e for e in prof.key_averages()
                             if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA])
    check(counts.get("quant_det_bwd_kernel", 0) == sites
          and counts.get("sum_partials_kernel", 0) == 0,
          f"train step {TRAIN_PROFILED + 1}: {counts.get('quant_det_bwd_kernel', 0)} "
          f"quant_det_bwd_kernel and {counts.get('sum_partials_kernel', 0)} "
          f"sum_partials_kernel for {sites} B2 calls")
    print(f"[train] profiled step: B1 {stats['device_us'].get('quant_det', 0.0):.2f} / B2 "
          f"{stats['device_us'].get('quant_det_bwd', 0.0):.2f} us of device time a launch, "
          f"{sites} launches each, one kernel a B2 call; B1 + B2 "
          f"{sites * (stats['device_us'].get('quant_det', 0.0) + stats['device_us'].get('quant_det_bwd', 0.0)) / 1e3:.3f} ms a step")
    del prof
    torch.cuda.empty_cache()
    K.reset_launches()
    out0 = train.run(steps=TRAIN_OPT0_STEPS, device=dev, opt_level=0,
                     log=lambda s: print(s if s.startswith("[") else f"[train opt0] {s}"))
    synchronize()
    l0 = dict(K.LAUNCHES)
    check(l0["quant_det_tiles"] == l0["quant_det_tiles_bwd"] == 0, f"opt_level 0: B7 {l0}")
    check(all(l0[k] == TRAIN_OPT0_STEPS * sites for k in QAT_MATMUL),
          f"opt_level 0: B10/B11 launches {l0}")
    check(all(math.isfinite(v) for v in out0["losses"]), f"opt_level 0 loss {out0['losses']}")
    print(f"[train opt0] {TRAIN_OPT0_STEPS} steps at opt_level 0: "
          f"{[round(t, 3) for t in out0['step_s']]} s/step, loss {out0['losses']}, launches "
          f"{ {k: v for k, v in l0.items() if v} }")
    torch.cuda.empty_cache()
    return {"launches": launches, "s_per_step": s_step, "peak_mem_bytes": peak,
            "losses": out["losses"], **stats}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import fp8_quant as K

    t_start = time.perf_counter()
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
    log2f_phase(dev)
    kern = kernel_phase(dev)
    rans_kern = rans_kernel_phase(dev)
    kern["worst"].update(rans_kern["worst"])
    kern["timings"].update(rans_kern["timings"])
    lm_kern = lm_kernel_phase(dev)
    kern["worst"].update(lm_kern["worst"])
    lm_wire = lm_wire_phase(dev)
    trainer_kern = trainer_kernel_phase(dev)
    kern["worst"].update(trainer_kern["worst"])
    round_phase(dev)
    lm_card_vs_cpu_phase(dev)
    trainer_card_vs_cpu_phase(dev)
    b9 = b9_path_phase(dev)
    uq = main_path_phase(dev, "uq")
    uqp = main_path_phase(dev, "uq+")
    lm = lm_main_path_phase(dev)
    torch.cuda.empty_cache()
    trainer = trainer_main_path_phase(dev)
    fmt = format_phase(dev)
    grid = grid_phase(dev)
    paper = paper_phase(dev)

    def path(name: str) -> tuple[str, int]:
        if name in TRAIN_KERNELS:
            return (f"launch.train full-width {LM_ARCH}, {TRAIN_STEPS} steps at opt_level 1",
                    trainer["launches"][name])
        if name == "fake_quant_amax_tiles":
            return "dispatch.fake_quant_amax_plane on the cifar10-lenet plane", \
                b9["launches"][name]
        if name in QAT_MATMUL:
            return (f"fed_lm full-width {LM_ARCH}, {LM_ROUNDS} rounds", lm["launches"][name])
        if name in FORMAT_KERNELS:
            return ("format ablation (18 MLP cells, 4 cifar10-lenet cells)",
                    fmt["launches"][name])
        if name in RANS_KERNELS:
            return ("format ablation pareto (10 MLP cells, cifar10-lenet fp4|ef+rans)",
                    fmt["pareto_launches"][name])
        if name.startswith("quant_rand"):
            return "table2 rand-qat", grid["launches"][name]
        return "cifar10-lenet uq+", uqp["launches"][name]

    by_path = launches_by_path(uq, uqp, grid, fmt, lm, trainer, b9)
    totals = {name: {"all_paths": sum(v[name] for v in by_path.values()),
                     "by_path": {p: v[name] for p, v in by_path.items() if v[name]}}
              for name in WIRE_KERNELS}
    print(f"[launches] wire kernels over every path of phases 4-8: {json.dumps(totals)}")
    for name, want in WIRE_LAUNCH_TOTALS.items():
        check(totals[name]["all_paths"] == want,
              f"[launches] {name}: {totals[name]['all_paths']} over every path, not {want}")
    paper_totals = {name: {"all_paths": sum(v[name] for v in paper["launches"].values()),
                           "by_path": {p: v[name] for p, v in paper["launches"].items()
                                       if v[name]}}
                    for name in WIRE_KERNELS}
    print(f"[launches] wire kernels over phase 9's paths: {json.dumps(paper_totals)}")

    rows = []
    for name in K.KERNELS:
        source, replaces = KERNEL_INFO[name]
        label, launches = path(name)
        if name in QAT_MATMUL:
            t = lm_kern["timings"][name][LM_MAIN_SHAPE]
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
                "path": label, "max_abs_err": kern["worst"][name],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "shape")},
                "device_us": lm["device_us"].get(name),
                "shapes": list(lm_kern["timings"][name].values()),
            })
            continue
        if name in TRAIN_KERNELS or name == "fake_quant_amax_tiles":
            tt = trainer_kern["timings"]
            t = tt["full"][name] if name in TRAIN_KERNELS else tt[name]["main"]
            extra = ({"device_us": trainer["device_us"].get(name)} if name in TRAIN_KERNELS
                     else {"large": tt[name]["large"],
                           **{k: v for k, v in b9.items() if k != "launches"}})
            rows.append({
                "name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": f"src/repro/kernels/{replaces}", "launches": launches,
                "path": label, "max_abs_err": kern["worst"][name],
                **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "shape")},
                "library_ms": None, **extra,
            })
            continue
        t = kern["timings"][name]["main"]
        extra = {}
        if name in ("quant_det", "quant_det_bwd"):
            paths = {p: v[name] for p, v in by_path.items()}
            extra = {"bf16": {shp: v[name] for shp, v in
                              trainer_kern["timings"]["bf16"].items()},
                     "trainer_launches": trainer["launches"][name],
                     "trainer_device_us": trainer["device_us"].get(name),
                     "launches_by_path": paths,
                     "launches_all_paths": sum(paths.values())}
        if name.startswith("quant_rand"):
            # the main path's route draws the bits in the kernel; the read
            # route (the reference's replayed bits) beside it
            extra = {"bits_route": kern["timings"][name + " bits"],
                     "device_us": grid["device_us"][name]}
        if name in LM_WIRE_INSTANCE:
            extra = {"lm": lm_wire[name], "lm_device_us": lm["device_us"].get(name)}
        if name in FORMAT_KERNELS:
            extra = {"mlp": kern["timings"][name]["mlp"], "device_us": fmt["device_us"][
                PROFILED_IN[name][0]].get(PROFILED_IN[name][1])}
        elif name in RANS_KERNELS:
            extra = {"lenet": kern["timings"][name]["lenet"],
                     "lenet_cohort": kern["timings"][name]["lenet cohort"],
                     "steps": t["steps"], "chain_ms": t["chain_ms"],
                     "us_a_row": t["us_a_row"], "chain_us_a_row": t["chain_us_a_row"],
                     "device_us": fmt["device_us"]["lenet " + LENET_PARETO_CELL[0]].get(
                         name + "_kernel")}
            if name in MIRRORS:
                extra["mirrors"] = MIRRORS[name]
        if "batched" in kern["timings"].get(name, {}):
            extra["batched"] = kern["timings"][name]["batched"]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces and f"src/repro/kernels/{replaces}",
            "launches": launches,
            "path": label,
            "max_abs_err": kern["worst"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "shape": t["shape"],
            "large": kern["timings"][name]["large"], **extra,
            **({"launches_by_path": totals[name]["by_path"],
                "launches_all_paths": totals[name]["all_paths"]} if name in totals else {}),
        })
    print(f"[setup] whole run {time.perf_counter() - t_start:.1f} s")
    print(f"[setup] {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
