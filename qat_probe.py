#!/usr/bin/env python3
"""What bounds the QAT kernels B1/B2, the stochastic pair B6, the FP8 wire
pair B3/B4, the batched launches of B8, B5 and B9's amax encode, and B9's
fake-quant with its row max on the card.

Run from the repository root:
python3 qat_probe.py [--src DIR] [--b6 | --wire | --sub-fq | --sub-dec | --b9 | --ga]

At the one-device trainer's bf16 activation shapes (batch 8 x 128 tokens:
(8, 128, 2048), (8, 128, 5632), and a CE chunk's (8, 16, 2048)), at f32
(8191, 1024) and at three of LeNet's f32 QAT sites, it prints for each
kernel:

- its device time a call (``device_us``: the self device time of every
  CUDA kernel that 50 back-to-back calls launched, under ``torch.profiler``
  after a lead-in of spin kernels, over 50; the inputs stay in the 50 MB L2
  between calls) beside its bytes
  bound (each input read once, each output written once, over 3.35 TB/s)
  and the fraction of the bound it reaches; also the wall time a call of
  back-to-back wrapper calls (``call_ms``, CUDA events), which at these
  sizes is the host's Python and ctypes overhead, not the kernel's, and the
  stream time a call (``stream_us``: the same calls queued behind a sleep
  kernel, so the gaps between kernels count: a call of two kernels pays
  the second launch);
- the copy probe's device time: the kernel's own grid and access pattern
  with the arithmetic removed (``out = x``; the backward ``gx = g`` with its
  partial sums over x), and the same for one element a thread in a
  grid-stride loop of at most 8192 blocks (the pattern of the first port of
  these kernels);
- the arithmetic probe's rate: each element function on values held in
  registers, no global traffic (G elements/s over a full grid, from its
  device time);
- the static SASS instruction count of det_code's element functions
  (``cuobjdump -sass`` of the built library: a one-element kernel less a
  plain copy; the division's slow path included).

Then, for B6 (``quant_rand`` / ``quant_rand_bwd``, stochastic QAT's weight
quantizer; :func:`measure_b6`), at every rand-qat weight shape of
cifar100-mlp and at (8191, 1024):

- each kernel's device time a call, its CUDA kernels a call and its stream
  time a call, with the u32 bits read from memory and, where the package
  has the counter route (``ref.CounterKey``), with the bits drawn inside the
  kernel; the bytes bound of each route;
- one weight site as the rand-qat path runs it: the site's bits from
  ``CounterQatBits.provider`` and ``dispatch.quantize_rand``'s forward, then
  its backward, at (64, 100): CUDA kernels and device time of each;
- one profiled round of Table 2's rand-qat cell (cifar100-mlp at
  ``bench.table2.CPU_BUDGET``): the wall of five rounds, device busy against
  their median, the round's top kernels, B6's kernels and the site bits (a
  ``record_function`` range around each provider call) in it.

With ``--wire``, only the FP8 wire pair B3 ``quant_pack_tiles`` / B4
``unpack_tiles`` (:func:`measure_wire`): at (9, 1024), (135, 1024), (8191,
1024) (random tiles, alpha 0.9 x each row's max) and at the LM cell's own
wire plane (:func:`lm_wire_plane`: full-width TinyLlama-1.1B's init
weights in the wire's tiles, with the alpha tiles its encode hands the
kernels), det and counter-RNG rounding, E4M3 and E5M2, alpha as an (R, 1)
column and as (R, 1024): each kernel's device time and stream time a call
beside its bytes bound, and its output against its twin bit for bit
(at the LM plane in row chunks), two calls bitwise equal, one launch a
call.

With ``--sub-fq``, only B8's FP4 encode and B5's fake-quant as the port's
main paths call them (:func:`sub_fq_cases`): B8 at (P, R, 1024) for R = 9
and 135 with cohorts of P = 1 and 3 planes, and at (1, 8191, 1024), E2M1
and E3M0, det and rand, alpha as an (R, 1) column and as (R, 1024); B5 at
E4M3, det and rand, on cifar10-lenet's, cifar100-mlp's and speech-kwt's
UQ+ planes (their init weights) at G = 1 and 20 clip columns (0.5x to 1x
each segment's clip, as Eq. 5's grid spans its interval) and at (8191,
1024). A call is one batched launch (``quant_pack_sub_many``,
``fake_quant_many``), or where the package has none (``--src`` of an older checkout) the P (G)
single-plane launches its callers made. Each case prints device us a call
(profiler), host ms a call (CUDA events around back-to-back calls), the
wrapper launches a call and the bytes bound of the batched work (x read
once, codes or values written once, alphas and keys), and counts the codes
or values that differ from this checkout's twins. Then the UQ+ server step
on LeNet's plane, host ms (:func:`server_step_ms`).

With ``--sub-dec``, only B8's FP4 decode and B9's amax encode as the port's
uplinks call them (:func:`sub_dec_cases`), at (P, R, 1024) for (P, R) in
(1, 9), (3, 9), (1, 135), (3, 135) and (1, 8191), det and rand, alpha as
an (R, 1) column and as (R, 1024): B8's decode of E2M1 and E3M0 codes
(made by the same rounding), each plane at its own clips; the amax encode at
K = 1 (E4M3) and K = 2 (E2M1), every plane at one slice of clips expanded
over P (``WireLink.up_scaled``'s shared effective scales). A call is one
batched launch (``unpack_sub_many``, ``quant_pack_amax_many``), or where
the package has none (``--src`` of an older checkout) the P single-plane
launches its callers made. Each case prints device us a call (profiler),
host ms a call, the wrapper launches a call and the bytes bound of the
batched work (codes or x read once, values or codes and row maxima written
once, alphas and keys), and counts the values, codes and row maxima that
differ from this checkout's twins. At P = 1 the single-plane wrappers
(``unpack_sub_tiles``, ``quant_pack_amax_tiles`` /
``quant_pack_sub_amax_tiles``) are timed too, on the same plane (device us
and host ms a call).

With ``--b9``, only B9 ``fake_quant_amax_tiles`` (:func:`b9_cases`) as the
trainer's ``dispatch.fake_quant_amax_plane`` calls it: on cifar10-lenet's
real plane (135, 1024) at its own alpha column and on a random (8191,
1024), det and rand, alpha as an (R, 1) column and as (R, 1024). Each case
prints device us a call (profiler), host ms a call, the wrapper launches a
call, the bytes bound (x read once, values written once, alphas, row
maxima and the key) and the share of it reached, and counts the values and
row maxima that differ from this checkout's twin and the values that differ
from B5 ``fake_quant_tiles`` on the same inputs.

With ``--ga``, only B2 ``quant_det_bwd``'s scalar clip cotangent
(:func:`ga_cases`) against its f64 sum, on the cases of ``chip_smoke.py``'s
phase 2 at speech-kwt's (64, 64): random x at 0.3 clipped at 0.8 max|x|,
and each (64, 64) init weight at its own alpha, every draw a new cotangent
signed like x (and a new x for the random case). For each case it counts
the draws whose kernel result lies more than GA_RTOL (1e-5) from the
twin's, and says which of the two f32 sums lies nearer the f64 sum there
and over all draws; it prints the worst error of each on the terms'
magnitude sum (``ref.clip_within_bar``'s measure) and the worst
cancellation (the magnitude sum over the result).

``--b6`` runs only the B6 part. With ``--src DIR`` it times the kernels of
the package under ``DIR/src`` instead (for example an unpacked parent
commit), and runs only the probes and routes that package has. Needs a
card; prints ``{"qat_probe": ...}`` last. ``chip_smoke.py`` calls
:func:`measure`, :func:`lm_wire_plane`, :func:`wire_case` and
:func:`wire_check` too, and ``tests/test_torch_cuda.py`` :func:`wire_check`.
"""
from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
SHAPES = (((8, 128, 2048), "bf16"), ((8, 128, 5632), "bf16"), ((8, 16, 2048), "bf16"),
          ((8191, 1024), "f32"),
          # LeNet's QAT sites at batch 32: the conv1 input, the dense input, a weight
          ((32, 32, 32, 3), "f32"), ((32, 1024), "f32"), ((5, 5, 6, 16), "f32"))
ARITH_ITERS = 64
# the arithmetic probe's element functions, by the op code of repro_qat_arith_probe
ARITH_OPS = {0: "quant_det_elem", 1: "ste_terms", 2: "quant_det_tab", 3: "ste_terms_tab"}
# sass_elem_kernel<OP>: 0 the baseline copy, then one element function each
SASS_OPS = {1: "quant_det_elem", 2: "ste_terms"}
FALLBACKS: list = []   # device_us calls the profiler left without device events


def time_ms(fn, reps: int = 7, iters: int = 50, warmup: int = 5) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls."""
    import torch
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


LEAD_IN = 256   # spin kernels that start a profile whose kernels are counted


def _lead_in() -> None:
    """50 ms, then LEAD_IN spin kernels: the profiler on the card drops
    device records at a trace's start (chip_smoke.py's ``_lead_in``), and
    the loss falls on them."""
    import torch
    torch.cuda.synchronize()
    time.sleep(0.05)
    for _ in range(LEAD_IN):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def _counted_rows(prof):
    """A lead-in profile's device rows without the spin kernels, or None
    where the profiler lost the whole lead-in (it may then have lost more)."""
    rows = _cuda_rows(prof)
    if not any("spin_kernel" in e.key for e in rows):
        return None
    return [e for e in rows if "spin_kernel" not in e.key]


def device_us(fn, iters: int = 50, kernel: str | None = None) -> float:
    """Device time a call of ``fn``, us: the summed self device time of
    every CUDA kernel ``iters`` calls launched (torch.profiler, after the
    lead-in), or of those whose name holds ``kernel``, over ``iters``.
    Where five profiles in a row come back without such records, the call's
    stream time instead (``stream_us``), and ``fn`` is noted in FALLBACKS."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):   # a profile now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in _counted_rows(prof) or () if kernel is None or kernel in e.key]
        total = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
        if total > 0:
            return total / iters
        time.sleep(0.1)
    FALLBACKS.append(getattr(fn, "__name__", "call"))
    return stream_us(fn, iters)


def stream_us(fn, iters: int = 50) -> float:
    """Stream time a call of ``fn``, us: CUDA events around ``iters`` calls
    queued behind a 20M-cycle sleep kernel, so the device runs them back to
    back with no host gap; every kernel of a call and the gaps between
    kernels count (a call of two kernels pays its second launch)."""
    import torch
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) * 1e3 / iters


def bytes_bound_ms(n: int, esize: int, bwd: bool) -> float:
    """B1 reads x and writes out; B2 reads x and g, writes gx and g_alpha;
    both read alpha."""
    n_bytes = (3 * n * esize + 8) if bwd else (2 * n * esize + 4)
    return n_bytes / HBM_BYTES_PER_S * 1e3


def sass_counts(lib_path: Path) -> dict:
    """Static SASS instructions of every kernel in the library whose name
    holds ``quant_det`` or ``sass_elem``, and of each element function (its
    one-element kernel less the plain copy's)."""
    cuobjdump = next((str(p) for p in (Path("/usr/local/cuda/bin/cuobjdump"),)
                      if p.exists()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=300).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = 0
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/\s+\S", line):
            counts[name] += 1
    ours = {k: v for k, v in counts.items() if "quant_det" in k or "sass_elem" in k}
    elem = {}
    base = next((v for k, v in ours.items() if "sass_elem_kernelILi0E" in k), None)
    for op, label in SASS_OPS.items():
        hit = next((v for k, v in ours.items() if f"sass_elem_kernelILi{op}E" in k), None)
        if hit is not None and base is not None:
            elem[label] = hit - base
    return {"kernels": ours, "element_functions": elem}


def measure(dev, K, verbose: bool = True) -> dict:
    """Times, bounds, probes and SASS counts of B1/B2 with the wrapper module
    ``K`` (``repro_torch.kernels.fp8_quant`` of the tree under test)."""
    import ctypes

    import torch

    lib = K.load()
    p, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    has_probe = hasattr(lib, "repro_quant_det_probe")
    if has_probe:
        lib.repro_quant_det_probe.argtypes = [i32, p, p, i64, i32, p]
        lib.repro_quant_det_bwd_probe.argtypes = [i32, p, p, p, p, p, i64, i32, p]
        lib.repro_qat_arith_probe.argtypes = [i32, p, p, i32, i32, i32, i32, f32, p]
        for fn in (lib.repro_quant_det_probe, lib.repro_quant_det_bwd_probe,
                   lib.repro_qat_arith_probe):
            fn.restype = ctypes.c_int
    stream = lambda: torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(22)
    res = {"shapes": {}}
    for shape, dt in SHAPES:
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x = (torch.randn(shape, generator=g) * 1.5).to(dev).to(dtype)
        gr = (torch.randn(shape, generator=g).abs().to(dev) * torch.sign(x.float())).to(dtype)
        a = torch.tensor(4.0, device=dev)
        n, esize = x.numel(), x.element_size()
        row = {}
        for name, fn, bwd in (("quant_det", lambda: K.quant_det(x, a), False),
                              ("quant_det_bwd", lambda: K.quant_det_bwd(x, a, gr), True)):
            us = device_us(fn)
            b_ms = bytes_bound_ms(n, esize, bwd)
            row[name] = {"device_us": us, "bound_us": b_ms * 1e3,
                         "fraction": b_ms * 1e3 / us, "stream_us": stream_us(fn),
                         "call_ms": time_ms(fn)}
        if has_probe:
            out, gx = torch.empty_like(x), torch.empty_like(x)
            part = torch.zeros(1 << 16, dtype=torch.float32, device=dev)  # ticket at 0
            ga = torch.empty((), dtype=torch.float32, device=dev)
            bf = int(dtype == torch.bfloat16)
            for kind, label in ((0, "copy"), (1, "copy_one_a_thread")):
                def fwd(kind=kind):
                    rc = lib.repro_quant_det_probe(kind, x.data_ptr(), out.data_ptr(), n, bf,
                                                   stream())
                    assert rc == 0, f"copy probe: CUDA error {rc}"

                def bwd(kind=kind):
                    rc = lib.repro_quant_det_bwd_probe(kind, x.data_ptr(), gr.data_ptr(),
                                                       gx.data_ptr(), part.data_ptr(),
                                                       ga.data_ptr(), n, bf, stream())
                    assert rc == 0, f"copy probe: CUDA error {rc}"
                row["quant_det"][label + "_us"] = device_us(fwd)
                row["quant_det_bwd"][label + "_us"] = device_us(bwd)
        res["shapes"][f"{tuple(shape)} {dt}"] = row
        if verbose:
            for name, r in row.items():
                probes = "".join(f", {k[:-3]} probe {v:.3f} us" for k, v in r.items()
                                 if k.startswith("copy"))
                print(f"[qat-probe] {name:13s} {str(tuple(shape)):16s} {dt}: device "
                      f"{r['device_us']:.3f} us a call, bytes bound {r['bound_us']:.3f} us, "
                      f"{100 * r['fraction']:.1f}% of it{probes}; stream {r['stream_us']:.3f} "
                      f"us a call; wall a call of back-to-back calls {r['call_ms'] * 1e3:.2f} us")
    if has_probe:
        from repro_torch.core.fp8 import E4M3
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        blocks = sms * 8
        sink = torch.empty(blocks * 256, dtype=torch.float32, device=dev)
        a = torch.tensor(4.0, device=dev)
        rates = {}
        for op, label in ARITH_OPS.items():
            def run(op=op):
                return lib.repro_qat_arith_probe(op, a.data_ptr(), sink.data_ptr(), blocks,
                                                 ARITH_ITERS, E4M3.exp, E4M3.mant,
                                                 E4M3.mant_const, stream())
            if run() != 0:      # an op this library does not have
                torch.cuda.synchronize()
                continue
            us = device_us(run, iters=20)
            rates[label] = blocks * 256 * ARITH_ITERS / (us * 1e-6) / 1e9
            if verbose:
                print(f"[qat-probe] arithmetic probe {label}: {rates[label]:.1f} G elements/s "
                      f"({blocks} blocks x 256 threads x {ARITH_ITERS}, E4M3, alpha 4)")
        res["arith_g_elements_per_s"] = rates
        # the table's cost alone: the probe with no evaluations, table (op 2)
        # against none (op 0), on the grid B1 takes at (8, 128, 2048) bf16
        prologue = {}
        for op, label in ((0, "alpha_and_bias"), (2, "with_table")):
            def bare(op=op):
                return lib.repro_qat_arith_probe(op, a.data_ptr(), sink.data_ptr(), 256, 0,
                                                 E4M3.exp, E4M3.mant, E4M3.mant_const,
                                                 stream())
            if bare() == 0:
                prologue[label] = device_us(bare)
        res["prologue_us"] = prologue
        if verbose and prologue:
            print(f"[qat-probe] a block's prologue (256 blocks, no elements): alpha and bias "
                  f"{prologue.get('alpha_and_bias', 0.0):.3f} us, with the scale table "
                  f"{prologue.get('with_table', 0.0):.3f} us a launch")
        try:
            res["sass"] = sass_counts(K.library_path())
        except (OSError, subprocess.SubprocessError) as e:
            res["sass"] = f"not measured: {e}"
        if verbose:
            print(f"[qat-probe] static SASS instructions: {res['sass']}")
    res["profiler_fallbacks"] = len(FALLBACKS)
    if FALLBACKS and verbose:
        print(f"[qat-probe] {len(FALLBACKS)} timings by CUDA events behind a sleep kernel "
              "(the profiler recorded no device events five times)")
    return res


B6_SHAPES = ((32, 64), (64, 64), (64, 10), (64, 100), (8191, 1024))
B6_SITE_SHAPE = (64, 100)   # the largest rand-qat weight (cifar100-mlp)
B6_KERNELS = ("quant_rand_kernel", "quant_rand_bwd_kernel", "sum_partials_kernel")
ROUND_REPEATS = 5   # timed rounds of the Table 2 cell before the profiled one


def b6_bytes_bound_ms(n: int, bwd: bool, counter: bool) -> float:
    """B6 reads x (and g backward) and the bits unless it draws them, writes
    out (gx backward); alpha, the key and g_alpha besides."""
    per = 4 + (0 if counter else 4) + (8 if bwd else 4)
    return (per * n + 4 + (8 if counter else 0) + (4 if bwd else 0)) / HBM_BYTES_PER_S * 1e3


def _cuda_rows(prof):
    import torch
    return [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]


def profile_calls(calls, warm=None) -> dict:
    """Every CUDA kernel the callables in ``calls`` launch, one call each,
    under torch.profiler (``warm`` called once before): ``{"kernels": per
    call, "device_us": per call, "names": {kernel: launches}}``. A call
    that launches nothing gives five empty profiles in a row: 0 kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm is not None:
        warm()
    torch.cuda.synchronize()
    for _ in range(5):   # a profile now and then comes back without device events
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _lead_in()
            for fn in calls:
                fn()
            torch.cuda.synchronize()
        rows = _counted_rows(prof) or []
        total = sum(getattr(e, "self_device_time_total", 0.0) for e in rows)
        if total > 0:
            names = {}
            for e in rows:
                k = e.key.removeprefix("void ").split("(")[0].split("<")[0]
                names[k] = names.get(k, 0) + e.count
            return {"kernels": sum(e.count for e in rows) / len(calls),
                    "device_us": total / len(calls), "names": names}
        time.sleep(0.1)
    return {"kernels": 0, "device_us": 0.0, "names": {}}


def measure_b6(dev, verbose: bool = True) -> dict:
    """B6's kernels, one weight site and one profiled Table 2 rand-qat round
    with the package on the path (module docstring)."""
    import torch

    from repro_torch.core import engine as E
    from repro_torch.kernels import dispatch as D
    from repro_torch.kernels import fp8_quant as K
    from repro_torch.kernels import ref as R

    counter = hasattr(R, "CounterKey")
    g = torch.Generator().manual_seed(23)
    u32 = lambda shape: torch.randint(0, 2 ** 32, shape, generator=g,
                                      dtype=torch.int64).to(torch.uint32).to(dev)
    res = {"counter_route": counter, "shapes": {}}
    for shape in B6_SHAPES:
        x = (torch.randn(shape, generator=g) * 0.3).to(dev)
        gr = torch.randn(shape, generator=g).to(dev)
        a = x.abs().max() * 0.8
        routes = {"bits": u32(shape)}
        if counter:
            routes["counter"] = R.CounterKey(u32((2,)), 7)
        row = {}
        for route, bits in routes.items():
            for name, fn, bwd in (
                    ("quant_rand", lambda: K.quant_rand(x, a, bits), False),
                    ("quant_rand_bwd", lambda: K.quant_rand_bwd(x, a, bits, gr), True)):
                prof = profile_calls([fn] * 50, warm=fn)
                b_us = b6_bytes_bound_ms(x.numel(), bwd, route == "counter") * 1e3
                row[f"{name} {route}"] = {
                    "device_us": prof["device_us"], "kernels": prof["kernels"],
                    "stream_us": stream_us(fn), "bound_us": b_us}
        res["shapes"][str(shape)] = row
        if verbose:
            for label, r in row.items():
                print(f"[b6-probe] {label:22s} {str(shape):13s}: device {r['device_us']:.3f} "
                      f"us a call in {r['kernels']} kernels, stream {r['stream_us']:.3f} us, "
                      f"bytes bound {r['bound_us']:.4f} us")
    # one weight site of the rand-qat path: its bits, the forward, the backward
    keys = u32((1, 1, 2))
    src = E.CounterQatBits(keys)
    xw = (torch.randn(B6_SITE_SHAPE, generator=g) * 0.3).to(dev).requires_grad_()
    aw = (xw.detach().abs().max() * 0.8).requires_grad_()
    gw = torch.randn(B6_SITE_SHAPE, generator=g).to(dev)

    def site_fwd():
        return D.quantize_rand(xw, aw, src.provider(0, 0)(3, B6_SITE_SHAPE))
    fwd = profile_calls([site_fwd] * 50, warm=site_fwd)
    outs = [site_fwd() for _ in range(51)]
    bwd = profile_calls([lambda o=o: torch.autograd.grad(o, (xw, aw), gw) for o in outs[:50]],
                        warm=lambda: torch.autograd.grad(outs[50], (xw, aw), gw))
    with torch.no_grad():
        bits_fn = lambda: src.provider(0, 0)(3, B6_SITE_SHAPE)
        bits_only = profile_calls([bits_fn] * 50, warm=bits_fn)
    res["site"] = {"shape": list(B6_SITE_SHAPE), "forward": fwd, "backward": bwd,
                   "bits": bits_only}
    if verbose:
        for label, r in (("bits", bits_only), ("forward", fwd), ("backward", bwd)):
            print(f"[b6-probe] one site {B6_SITE_SHAPE} {label:8s}: {r['kernels']} CUDA "
                  f"kernels, {r['device_us']:.3f} us of device time a call ({r['names']})")
    rnd = rand_qat_round(dev, verbose)
    # the bits' share again from the site probe: its device time x the round's sites
    rnd["bits_est_ms"] = bits_only["device_us"] * rnd["sites"] / 1e3
    if verbose:
        print(f"[b6-probe] table2 rand-qat round: the site probe's bits x {rnd['sites']} "
              f"sites = {rnd['bits_est_ms']:.3f} ms")
    res["table2_round"] = rnd
    return res


def rand_qat_round(dev, verbose: bool = True) -> dict:
    """One profiled round of Table 2's rand-qat cell (cifar100-mlp at
    ``table2.CPU_BUDGET``), after a warm round and ROUND_REPEATS timed ones:
    their walls (unprofiled), device busy, the top kernels, B6's kernels and
    the site bits in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.bench import common, table2
    from repro_torch.core import engine as E
    from repro_torch.core.fedsim import FedSim
    from repro_torch.data import partition_iid
    from repro_torch.models import small

    sc = table2.CPU_BUDGET
    task = common.TASKS["cifar100-mlp"]
    (x, y), _ = common.make_data(task, sc["n_train"], sc["n_test"], seed=0)
    cx, cy, nk = partition_iid(x, y, k=sc["k"], seed=0)
    params, apply = common.make_model(task, 0, dev)
    cfg = common.method_cfg("rand-qat", sc["k"], sc["c"], sc["local_steps"], sc["batch"])
    sim = FedSim(params, small.make_loss(apply), apply, common.make_optimizer(task, params),
                 cfg, cx, cy, nk, device=dev)
    sim.run(1, seed=0)
    torch.cuda.synchronize()
    walls = []
    for r in range(ROUND_REPEATS):
        t0 = time.perf_counter()
        sim.run(1, seed=2 + r)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    provider = E.CounterQatBits.provider
    sites = [0]

    def traced(self, client, step):
        fn = provider(self, client, step)

        def bits(site, shape):
            sites[0] += 1
            with record_function("qat_site_bits"):
                return fn(site, shape)
        return bits
    E.CounterQatBits.provider = traced
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.run(1, seed=1)
            torch.cuda.synchronize()
    finally:
        E.CounterQatBits.provider = provider
    events = prof.key_averages()
    # kernels only: the device-side rows of the record_function ranges span
    # the time their kernels waited in the queue as well
    rows = [e for e in _cuda_rows(prof) if e.key != "qat_site_bits"]
    self_us = lambda e: getattr(e, "self_device_time_total", 0.0)
    busy = sum(self_us(e) for e in rows)
    b6 = {}
    for e in rows:
        k = e.key.removeprefix("void ").split("(")[0].split("<")[0]
        if k in B6_KERNELS:
            b6[k] = {"launches": e.count, "device_ms": self_us(e) / 1e3}
    # the host-side ranges: the device time of the kernels their ops launched
    # (the device-side annotation of the same name spans queue time too)
    bits_us = sum(getattr(e, "device_time_total", 0.0) for e in events
                  if e.key == "qat_site_bits"
                  and getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU)
    top = sorted(rows, key=self_us, reverse=True)[:8]
    out = {"wall_ms": wall_ms, "walls_ms": walls, "busy_ms": busy / 1e3,
           "busy_share": busy / 1e3 / wall_ms,
           "top": [(e.key[:60], e.count, self_us(e) / 1e3) for e in top],
           "b6": b6, "b6_ms": sum(v["device_ms"] for v in b6.values()),
           "sites": sites[0], "bits_ms": bits_us / 1e3,
           "kernels": sum(e.count for e in rows)}
    if verbose:
        print(f"[b6-probe] table2 rand-qat round: wall a round "
              + ", ".join(f"{w:.1f}" for w in walls) + " ms (unprofiled); top kernels "
              + "; ".join(f"{k} x{c} {ms:.3f} ms" for k, c, ms in out["top"]))
        print(f"[b6-probe] table2 rand-qat round: wall {wall_ms:.1f} ms (median), device "
              f"busy {out['busy_ms']:.3f} ms ({100 * out['busy_share']:.1f}%), "
              f"{out['kernels']} CUDA kernels; B6 {out['b6_ms']:.3f} ms "
              f"({100 * out['b6_ms'] / max(out['busy_ms'], 1e-9):.1f}% of busy) {b6}; "
              f"{sites[0]} site bits calls, {out['bits_ms']:.3f} ms of device time under them "
              f"({100 * out['bits_ms'] / max(out['busy_ms'], 1e-9):.1f}% of busy)")
    return out


def log2f_monotone(dev, K) -> dict:
    """The scale table's premise on this card: log2f non-decreasing over
    every f32 pattern from +0 to FLT_MAX (``repro_log2f_monotone``, one
    launch). Returns the count of decreases and the first pattern of one."""
    import ctypes

    import torch

    lib = K.load()
    lib.repro_log2f_monotone.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.repro_log2f_monotone.restype = ctypes.c_int
    bad = torch.tensor([0, -1], dtype=torch.int64, device=dev)   # -1: all ones
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    rc = lib.repro_log2f_monotone(bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    stop.record()
    torch.cuda.synchronize()
    if rc != 0:
        raise RuntimeError(f"log2f monotonicity check: CUDA error {rc}")
    n_bad, first = (int(v) for v in bad.cpu())
    return {"decreases": n_bad, "first": None if n_bad == 0 else first & 0xFFFFFFFF,
            "patterns": 0x7F7FFFFF + 1, "ms": start.elapsed_time(stop)}


WIRE_SHAPES = ((9, 1024), (135, 1024), (8191, 1024))
WIRE_CHUNK = 1 << 15       # rows of one twin check at the LM plane
LM_ARCH = "tinyllama_1_1b"


def wire_bytes(n: int, rows: int, full_alpha: bool, keyed: bool) -> tuple[int, int]:
    """Bytes that B3 and B4 must move on n elements of ``rows`` tiles: x
    (4 B an element) in, a code (1 B) out, or the reverse, a code in and a
    value (4 B) out; alpha 4 B a row as a column or 4 B an element; B3's
    key 8 B."""
    a = 4 * n if full_alpha else 4 * rows
    return 5 * n + a + (8 if keyed else 0), 5 * n + a


def lm_wire_plane(dev):
    """The LM cell's wire plane: full-width TinyLlama-1.1B's init weights
    (the port's, seed 0) in the wire's ``(R, 1024)`` tiles, and the alpha
    tiles that the cell's encode hands B3 and B4 (``wire.alpha_tiles``).
    Its clips are stacked a layer, so that is the per-element ``(R, 1024)``
    layout, constant along each row (every layer's slice fills whole rows).
    Returns ``(x2, a2, col)``, ``col`` the first column of ``a2``."""
    import torch

    from repro_torch import configs, tree
    from repro_torch.core import wire
    from repro_torch.models import registry

    params = registry.get_model(configs.get(LM_ARCH)).init(0, device=dev)
    spec = wire.make_wire_spec(params)
    leaves = tree.leaves(params)
    x2 = wire.weight_tiles(leaves, spec)
    a2 = wire.alpha_tiles(tuple(leaves[i] for i in spec.other_slots), spec)
    del params, leaves
    torch.cuda.empty_cache()
    return x2, a2, a2[:, :1].contiguous()


def _differ(a, b) -> int:
    """Elements whose bits differ (f32 through int32: -0 and +0 differ)."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return int((a != b).sum())


def wire_check(K, R, x2, a2, key, fmt, chunk: int | None = None) -> dict:
    """B3's codes and B4's values on them against the twins, bit for bit,
    in row chunks of ``chunk`` (all rows at once when None); a second call
    of each bitwise the first; one launch a call."""
    import torch
    before = dict(K.LAUNCHES)
    codes = K.quant_pack_tiles(x2, a2, key, fmt)
    vals = K.unpack_tiles(codes, a2, fmt)
    one_each = (K.LAUNCHES["quant_pack_tiles"] - before["quant_pack_tiles"] == 1
                and K.LAUNCHES["unpack_tiles"] - before["unpack_tiles"] == 1)
    repeat = (torch.equal(K.quant_pack_tiles(x2, a2, key, fmt), codes)
              and torch.equal(K.unpack_tiles(codes, a2, fmt).view(torch.int32),
                              vals.view(torch.int32)))
    rows = x2.shape[0]
    step = chunk or rows
    bad_codes = bad_vals = 0
    for r0 in range(0, rows, step):
        sl = slice(r0, r0 + step)
        bad_codes += _differ(R.quant_pack_tiles(x2[sl], a2[sl], key, fmt, row0=r0), codes[sl])
        bad_vals += _differ(R.unpack_tiles(codes[sl], a2[sl], fmt), vals[sl])
    return {"bad_codes": bad_codes, "bad_values": bad_vals, "repeat_bitwise": repeat,
            "one_launch_each": one_each}


def wire_case(K, x2, a2, key, fmt) -> dict:
    """Device time (profiler) and stream time a call of B3 and of B4, and
    their bytes bounds, us."""
    codes = K.quant_pack_tiles(x2, a2, key, fmt)
    b_pack, b_unpack = wire_bytes(x2.numel(), x2.shape[0], a2.shape[1] != 1, key is not None)
    out = {}
    for name, fn, n_bytes in (
            ("quant_pack_tiles", lambda: K.quant_pack_tiles(x2, a2, key, fmt), b_pack),
            ("unpack_tiles", lambda: K.unpack_tiles(codes, a2, fmt), b_unpack)):
        iters = 50 if x2.numel() < (1 << 26) else 10
        out[name] = {"device_us": device_us(fn, iters), "stream_us": stream_us(fn, iters),
                     "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6}
    return out


def measure_wire(dev, K, R, verbose: bool = True) -> dict:
    """The wire pair at WIRE_SHAPES and at the LM plane (module docstring)."""
    import torch

    from repro_torch.core.fp8 import E4M3, E5M2

    g = torch.Generator().manual_seed(24)
    key = torch.tensor([0x9E3779B9, 0x7F4A7C15], dtype=torch.int64).to(torch.uint32).to(dev)
    planes = []
    for shape in WIRE_SHAPES:
        x = (torch.randn(shape, generator=g) * 0.2).to(dev)
        col = x.abs().amax(dim=1, keepdim=True) * 0.9
        planes.append((str(shape), x, col, col.expand(shape).contiguous(), None))
    t0 = time.perf_counter()
    x, a_full, col = lm_wire_plane(dev)
    row_const = bool((a_full == col).all())
    planes.append((f"lm {tuple(x.shape)}", x, col, a_full, WIRE_CHUNK))
    if verbose:
        print(f"[wire-probe] LM wire plane {tuple(x.shape)} ({x.numel()} elements) made in "
              f"{time.perf_counter() - t0:.1f} s; its alpha tiles constant along every row: "
              f"{row_const}")
    res = {"lm_rows": x.shape[0], "lm_alpha_row_constant": row_const, "cases": {}}
    for label, x, col, full, chunk in planes:
        for layout, a2 in (("column", col), ("full", full)):
            for rnd, k in (("det", None), ("rand", key)):
                for fmt in (E4M3, E5M2):
                    case = f"{label} {layout} {rnd} E{fmt.exp}M{fmt.mant}"
                    r = {**wire_case(K, x, a2, k, fmt), **wire_check(K, R, x, a2, k, fmt, chunk)}
                    res["cases"][case] = r
                    if verbose:
                        print(f"[wire-probe] {case}: " + "; ".join(
                            f"{n} device {r[n]['device_us']:.3f} us, stream "
                            f"{r[n]['stream_us']:.3f} us, bound {r[n]['bound_us']:.3f} us "
                            f"({100 * r[n]['bound_us'] / r[n]['device_us']:.1f}%)"
                            for n in ("quant_pack_tiles", "unpack_tiles"))
                            + f"; differ from the twins: {r['bad_codes']} codes, "
                            f"{r['bad_values']} values; repeat bitwise {r['repeat_bitwise']}, "
                            f"one launch each {r['one_launch_each']}")
        del x, col, full
    torch.cuda.empty_cache()
    res["all_bitwise"] = all(r["bad_codes"] == 0 and r["bad_values"] == 0
                             and r["repeat_bitwise"] and r["one_launch_each"]
                             for r in res["cases"].values())
    if verbose:
        print(f"[wire-probe] every case bitwise the twins, repeatable, one launch a call: "
              f"{res['all_bitwise']}")
    return res


SUB_ROWS = ((9, (1, 3)), (135, (1, 3)), (8191, (1,)))   # B8: rows, cohorts P
FQ_TASKS = ("cifar10-lenet", "cifar100-mlp", "speech-kwt")  # B5: the UQ+ planes
FQ_GRID = (1, 20)        # B5: grid points a call (the paper's method grid: 20)


def key_rows(n: int, dev, seed: int):
    """``(n, 2)`` u32 key words from ``seed``."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, (n, 2), generator=g, dtype=torch.int64).to(
        torch.int32).view(torch.uint32).to(dev)


def _timed(fn, launches) -> dict:
    """Device time (profiler) and host wall time of back-to-back calls (CUDA
    events), a call, and the wrapper launches a call makes."""
    before = sum(launches.values())
    fn()
    made = sum(launches.values()) - before
    return {"device_us": device_us(fn), "call_ms": time_ms(fn), "launches": made}


def server_step_ms(dev) -> float:
    """Host-clock ms of one UQ+ server step (``server_optimize`` at the
    method grid's 5 GD steps and 20 grid points) on LeNet's plane with three
    client messages made from its init weights, synchronized; the median of
    5 calls after one (``chip_smoke.time_server_step``'s measure)."""
    import torch

    from repro_torch.bench import common
    from repro_torch.core.server_opt import server_optimize
    from repro_torch.tree import tree_map

    params, _ = common.make_model(common.TASKS["cifar10-lenet"], 0, dev)
    stacked = tree_map(lambda p: torch.stack([p, p * 1.01, p * 0.99]), params)
    nk = torch.tensor([1.0, 2.0, 3.0], device=dev)
    cfg = common.method_cfg("uq+", 10, 0.3, 10, 32).server_opt
    gd_keys, grid_keys = key_rows(cfg.gd_steps, dev, 5), key_rows(cfg.n_grid, dev, 6)
    samples = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server_optimize(stacked, nk, gd_keys, grid_keys, cfg)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples[1:]) * 1e3


def sub_fq_cases(dev, K, R, verbose: bool = True) -> dict:
    """B8's cohort encode and B5's clip search as the port's main paths call
    them (module docstring, ``--sub-fq``). Where ``K`` has the batched entries
    (``quant_pack_sub_many``, ``fake_quant_many``) a call is one of them;
    else it is the P (G) single-plane launches the parent's callers made.
    Each call's output is held against this checkout's twins, bitwise."""
    import torch

    from repro_torch.bench import common
    from repro_torch.core import plane
    from repro_torch.core.fp8 import E4M3, FP4_E2M1, FP4_E3M0

    batched = hasattr(K, "quant_pack_sub_many")
    g = torch.Generator().manual_seed(25)
    res = {"batched": batched, "b8": {}, "b5": {}}
    for rows, cohorts in SUB_ROWS:
        for P in cohorts:
            x3 = (torch.randn((P, rows, 1024), generator=g) * 0.2).to(dev)
            col3 = x3.abs().amax(dim=2, keepdim=True) * 0.9
            for layout, a3 in (("column", col3), ("full", col3.expand(x3.shape).contiguous())):
                for rnd, keys in (("det", None), ("rand", key_rows(P, dev, rows + P))):
                    for fmt in (FP4_E2M1, FP4_E3M0):
                        if batched:
                            def call(x3=x3, a3=a3, keys=keys, fmt=fmt):
                                return K.quant_pack_sub_many(x3, a3, keys, fmt)
                        else:
                            def call(x3=x3, a3=a3, keys=keys, fmt=fmt):
                                return torch.stack([K.quant_pack_sub_tiles(
                                    x3[p], a3[p], None if keys is None else keys[p], fmt)
                                    for p in range(x3.shape[0])])
                        codes = call()
                        bad = sum(_differ(codes[p], R.quant_pack_sub_tiles(
                            x3[p], a3[p], None if keys is None else keys[p], fmt))
                            for p in range(P))
                        n = x3.numel()
                        n_bytes = 4.5 * n + 4 * (a3.numel()) + (8 * P if keys is not None else 0)
                        case = f"({P}, {rows}, 1024) {layout} {rnd} E{fmt.exp}M{fmt.mant}"
                        r = {**_timed(call, K.LAUNCHES), "bound_us": n_bytes / HBM_BYTES_PER_S
                             * 1e6, "bad_codes": bad}
                        res["b8"][case] = r
                        if verbose:
                            print(f"[sub-fq] B8 {case}: device {r['device_us']:.3f} us, host "
                                  f"{r['call_ms'] * 1e3:.2f} us a call, {r['launches']} "
                                  f"launches, bound {r['bound_us']:.3f} us, {bad} codes differ")
    fq_planes = []
    for task_name in FQ_TASKS:
        params, _ = common.make_model(common.TASKS[task_name], 0, dev)
        spec = plane.make_plane_spec(params)
        w2, alphas = plane.pack_tiles(params, spec)
        fq_planes.append((task_name, w2, alphas, spec))
    x = (torch.randn((8191, 1024), generator=g) * 0.2).to(dev)
    fq_planes.append(("random", x, x.abs().amax(dim=1) * 0.9, None))
    for label, w2, alphas, spec in fq_planes:
        for G in (FQ_GRID if spec is not None else (1,)):
            # G clip columns between 0.5x and 1x the plane's own, as Eq. 5's grid
            ts = torch.linspace(0.5, 1.0, G, device=dev)[:, None]
            a_seg = ts * alphas[None, :]
            a3 = torch.stack([a if spec is None else plane.alpha_column(a, spec)
                              for a in a_seg]).reshape(G, -1, 1)
            for rnd, keys in (("det", None), ("rand", key_rows(G, dev, 7 + G))):
                if batched:
                    def call(w2=w2, a3=a3, keys=keys):
                        return K.fake_quant_many(w2, a3, keys)
                else:
                    def call(w2=w2, a3=a3, keys=keys):
                        return torch.stack([K.fake_quant_tiles(
                            w2, a3[i], None if keys is None else keys[i])
                            for i in range(a3.shape[0])])
                q = call()
                bad = sum(_differ(q[i], R.fake_quant_tiles(
                    w2, a3[i], None if keys is None else keys[i], E4M3)) for i in range(G))
                n = w2.numel()
                n_bytes = 4 * n + 4 * G * n + 4 * a3.numel() + (8 * G if keys is not None else 0)
                case = f"{label} ({G}, {w2.shape[0]}, 1024) {rnd} E4M3"
                r = {**_timed(call, K.LAUNCHES), "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
                     "bad_values": bad}
                res["b5"][case] = r
                if verbose:
                    print(f"[sub-fq] B5 {case}: device {r['device_us']:.3f} us, host "
                          f"{r['call_ms'] * 1e3:.2f} us a call, {r['launches']} launches, "
                          f"bound {r['bound_us']:.3f} us, {bad} values differ")
    res["uqp_server_step_ms"] = server_step_ms(dev)
    if verbose:
        print(f"[sub-fq] UQ+ server step on LeNet's plane (P = 3, 5 GD steps, 20 grid "
              f"points): {res['uqp_server_step_ms']:.2f} ms (host clock, median of 5)")
    res["all_bitwise"] = (all(r["bad_codes"] == 0 for r in res["b8"].values())
                          and all(r["bad_values"] == 0 for r in res["b5"].values()))
    res["profiler_fallbacks"] = len(FALLBACKS)
    if verbose:
        print(f"[sub-fq] every call bitwise this checkout's twins: {res['all_bitwise']}")
    return res


SUB_DEC_SHAPES = ((1, 9), (3, 9), (1, 135), (3, 135), (1, 8191))   # (P, R)


def _dec_case(K, R, c3, a3, fmt, batched) -> tuple:
    """B8's decode call on ``(c3, a3)`` and its values' differences from
    this checkout's twin."""
    if batched:
        def call():
            return K.unpack_sub_many(c3, a3, fmt)
    else:
        def call():
            return [K.unpack_sub_tiles(c3[p], a3[p], fmt) for p in range(c3.shape[0])]
    vals = call()
    bad = sum(_differ(vals[p], R.unpack_sub_tiles(c3[p], a3[p], fmt))
              for p in range(c3.shape[0]))
    return call, bad


def _amax_case(K, R, x3, a3, keys, fmt, batched) -> tuple:
    """B9's amax encode call on ``(x3, a3, keys)`` and its codes' and row
    maxima's differences from this checkout's twins."""
    fp8 = fmt.bits == 8
    if batched:
        def call():
            return K.quant_pack_amax_many(x3, a3, keys, fmt)
    else:
        single = K.quant_pack_amax_tiles if fp8 else K.quant_pack_sub_amax_tiles

        def call():
            out = [single(x3[p], a3[p], None if keys is None else keys[p], fmt)
                   for p in range(x3.shape[0])]
            return [c for c, _ in out], [m for _, m in out]
    codes, rowmax = call()
    twin = R.quant_pack_amax_tiles if fp8 else R.quant_pack_sub_amax_tiles
    bad = 0
    for p in range(x3.shape[0]):
        wc, wm = twin(x3[p], a3[p], None if keys is None else keys[p], fmt)
        bad += _differ(codes[p], wc) + _differ(rowmax[p], wm)
    return call, bad


def sub_dec_cases(dev, K, R, verbose: bool = True) -> dict:
    """B8's cohort decode and B9's cohort amax encode as the port's uplinks
    call them (module docstring, ``--sub-dec``). Where ``K`` has the batched
    entries (``unpack_sub_many``, ``quant_pack_amax_many``) a call is one of
    them; else it is the P single-plane launches the parent's callers made.
    Each call's output is held against this checkout's twins, bitwise."""
    import torch

    from repro_torch.core.fp8 import E4M3, FP4_E2M1, FP4_E3M0

    batched = hasattr(K, "unpack_sub_many") and hasattr(K, "quant_pack_amax_many")
    g = torch.Generator().manual_seed(26)
    res = {"batched": batched, "b8_dec": {}, "b9_amax": {}, "b8_dec_single": {},
           "b9_amax_single": {}}
    for P, rows in SUB_DEC_SHAPES:
        x3 = (torch.randn((P, rows, 1024), generator=g) * 0.2).to(dev)
        x3[:, -1, 517:] = 0.0                                   # an odd leaf's tail
        col3 = x3.abs().amax(dim=2, keepdim=True) * 0.9
        for layout, a3 in (("column", col3), ("full", col3.expand(x3.shape).contiguous())):
            for rnd, keys in (("det", None), ("rand", key_rows(P, dev, rows + P))):
                for fmt in (FP4_E2M1, FP4_E3M0):
                    c3 = R.quant_pack_sub_tiles_many(x3, a3, keys, fmt)
                    call, bad = _dec_case(K, R, c3, a3, fmt, batched)
                    n_bytes = c3.numel() + 4 * a3.numel() + 4 * x3.numel()
                    case = f"({P}, {rows}, 1024) {layout} {rnd} E{fmt.exp}M{fmt.mant}"
                    r = {**_timed(call, K.LAUNCHES),
                         "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6, "bad": bad}
                    res["b8_dec"][case] = r
                    if verbose:
                        print(f"[sub-dec] B8 decode {case}: device {r['device_us']:.3f} us, host "
                              f"{r['call_ms'] * 1e3:.2f} us a call, {r['launches']} launches, "
                              f"bound {r['bound_us']:.3f} us, {bad} values differ")
                    if P == 1:
                        c2, a2 = c3[0], a3[0]
                        call, bad = _dec_case(K, R, c2[None], a2[None], fmt, False)
                        r = {**_timed(lambda: K.unpack_sub_tiles(c2, a2, fmt), K.LAUNCHES),
                             "bad": bad}
                        res["b8_dec_single"][case] = r
                        if verbose:
                            print(f"[sub-dec] B8 decode single {case}: device "
                                  f"{r['device_us']:.3f} us, host {r['call_ms'] * 1e3:.2f} us "
                                  f"a call, {bad} values differ")
                # the amax encode: every plane at one slice of clips, expanded over P
                a_one = a3[:1].expand(a3.shape)
                for fmt in (E4M3, FP4_E2M1):
                    call, bad = _amax_case(K, R, x3, a_one, keys, fmt, batched)
                    k = 8 // fmt.bits
                    n_bytes = (4 * x3.numel() + x3.numel() // k + 4 * a3[0].numel()
                               + 4 * P * rows + (8 * P if keys is not None else 0))
                    case = f"({P}, {rows}, 1024) {layout} {rnd} K={k}"
                    r = {**_timed(call, K.LAUNCHES),
                         "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6, "bad": bad}
                    res["b9_amax"][case] = r
                    if verbose:
                        print(f"[sub-dec] B9 amax {case}: device {r['device_us']:.3f} us, host "
                              f"{r['call_ms'] * 1e3:.2f} us a call, {r['launches']} launches, "
                              f"bound {r['bound_us']:.3f} us, {bad} codes or maxima differ")
                    if P == 1:
                        single = (K.quant_pack_amax_tiles if fmt.bits == 8
                                  else K.quant_pack_sub_amax_tiles)
                        x2, a2 = x3[0], a_one[0]
                        k2 = None if keys is None else keys[0]
                        call, bad = _amax_case(K, R, x2[None], a2[None],
                                               None if k2 is None else k2[None], fmt, False)
                        r = {**_timed(lambda: single(x2, a2, k2, fmt), K.LAUNCHES), "bad": bad}
                        res["b9_amax_single"][case] = r
                        if verbose:
                            print(f"[sub-dec] B9 amax single {case}: device "
                                  f"{r['device_us']:.3f} us, host {r['call_ms'] * 1e3:.2f} us "
                                  f"a call, {bad} codes or maxima differ")
        del x3, col3
    res["all_bitwise"] = all(r["bad"] == 0 for part in ("b8_dec", "b9_amax", "b8_dec_single",
                                                        "b9_amax_single")
                             for r in res[part].values())
    res["profiler_fallbacks"] = len(FALLBACKS)
    if verbose:
        print(f"[sub-dec] every call bitwise this checkout's twins: {res['all_bitwise']}")
    return res


B9_SHAPES = ("cifar10-lenet", (8191, 1024))   # LeNet's real plane, then a random one


def b9_cases(dev, K, R, verbose: bool = True) -> dict:
    """B9 ``fake_quant_amax_tiles`` as the trainer's ``fake_quant_amax_plane``
    calls it (module docstring, ``--b9``), on LeNet's real plane (135, 1024)
    at its own alpha column and on a random (8191, 1024) at 0.9 x each row's
    max, det and rand, alpha as an (R, 1) column and as (R, 1024): device us
    and host ms a call, launches, the bytes bound, and the values and row
    maxima that differ from this checkout's twin and from B5's kernel."""
    import torch

    from repro_torch.bench import common
    from repro_torch.core import plane

    g = torch.Generator().manual_seed(27)
    key = key_rows(1, dev, 27)[0]
    res = {"b9": {}}
    planes = []
    for shape in B9_SHAPES:
        if isinstance(shape, str):
            params, _ = common.make_model(common.TASKS[shape], 0, dev)
            spec = plane.make_plane_spec(params)
            x2, alphas = plane.pack_tiles(params, spec)
            planes.append((shape, x2, plane.alpha_column(alphas, spec)))
        else:
            x2 = (torch.randn(shape, generator=g) * 0.2).to(dev)
            planes.append(("random", x2, x2.abs().amax(dim=1, keepdim=True) * 0.9))
    for label, x2, col in planes:
        for layout, a2 in (("column", col), ("full", col.expand(x2.shape).contiguous())):
            for rnd, k2 in (("det", None), ("rand", key)):
                def call(x2=x2, a2=a2, k2=k2):
                    return K.fake_quant_amax_tiles(x2, a2, k2)
                q, mx = call()
                wq, wm = R.fake_quant_amax_tiles(x2, a2, k2)
                bad = _differ(q, wq) + _differ(mx, wm)
                bad_b5 = _differ(q, K.fake_quant_tiles(x2, a2, k2))
                n, rows = x2.numel(), x2.shape[0]
                n_bytes = 8 * n + 4 * a2.numel() + 4 * rows + (8 if k2 is not None else 0)
                case = f"{label} ({rows}, 1024) {layout} {rnd}"
                r = {**_timed(call, K.LAUNCHES), "bound_us": n_bytes / HBM_BYTES_PER_S * 1e6,
                     "bad": bad, "bad_b5": bad_b5}
                r["fraction"] = r["bound_us"] / r["device_us"]
                res["b9"][case] = r
                if verbose:
                    print(f"[b9] {case}: device {r['device_us']:.3f} us, host "
                          f"{r['call_ms'] * 1e3:.2f} us a call, {r['launches']} launches, "
                          f"bound {r['bound_us']:.3f} us ({100 * r['fraction']:.1f}%), "
                          f"{bad} values or maxima differ from the twin, {bad_b5} values "
                          f"from B5")
    res["all_bitwise"] = all(r["bad"] == 0 and r["bad_b5"] == 0 for r in res["b9"].values())
    res["profiler_fallbacks"] = len(FALLBACKS)
    if verbose:
        print(f"[b9] every call bitwise this checkout's twin and B5: {res['all_bitwise']}")
    return res


GA_RTOL, GA_DRAWS = 1e-5, 500   # chip_smoke.py's bar on B2's g_alpha; draws a case


def ga_cases(dev, K, R, draws: int = GA_DRAWS, verbose: bool = True) -> dict:
    """B2's g_alpha, kernel and twin, against the f64 sum of its terms on
    the cases of the module docstring's ``--ga``: per case the draws over
    GA_RTOL, which side lies nearer the f64 sum there and over all draws,
    the worst errors on the magnitude sum and the worst cancellation."""
    import torch

    from repro_torch import tree
    from repro_torch.bench import common

    g = torch.Generator().manual_seed(27)
    params, _ = common.make_model(common.TASKS["speech-kwt"], 0, dev)
    flat = dict(tree.flatten(params))
    cases = [("random", None, None)] + [
        (name, w, flat[name + "_qa"]) for name, w in flat.items()
        if name.endswith(".w") and name + "_qa" in flat and tuple(w.shape) == (64, 64)]
    res = {}
    for label, w, alpha in cases:
        r = dict(draws=draws, over_bar=0, over_bar_kernel_nearer=0, kernel_nearer=0,
                 twin_nearer=0, equal=0, worst_rel=0.0, worst_kernel_on_mag=0.0,
                 worst_twin_on_mag=0.0, worst_cancellation=0.0)
        for _ in range(draws):
            x = (torch.randn((64, 64), generator=g) * 0.3).to(dev) if w is None else w
            a = x.abs().max() * 0.8 if alpha is None else alpha
            gr = torch.randn((64, 64), generator=g).abs().to(dev) * torch.sign(x)
            kern = float(K.quant_det_bwd(x, a, gr)[1])
            twin = float(R.quant_det_bwd(x, a, gr)[1])
            exact, mag = R.quant_det_clip_f64(x, a, gr)
            ek, et = abs(kern - exact), abs(twin - exact)
            rel = abs(kern - twin) / max(abs(twin), 1e-30)
            r["worst_rel"] = max(r["worst_rel"], rel)
            r["worst_kernel_on_mag"] = max(r["worst_kernel_on_mag"], ek / mag)
            r["worst_twin_on_mag"] = max(r["worst_twin_on_mag"], et / mag)
            r["worst_cancellation"] = max(r["worst_cancellation"], mag / max(abs(exact), 1e-30))
            side = "kernel_nearer" if ek < et else "twin_nearer" if et < ek else "equal"
            r[side] += 1
            if rel > GA_RTOL:
                r["over_bar"] += 1
                r["over_bar_kernel_nearer"] += ek < et
                if verbose:
                    print(f"[ga] {label}: kernel {kern:.9g} twin {twin:.9g} f64 {exact:.12g} "
                          f"(rel {rel:.3g}; kernel off {ek:.3g}, twin off {et:.3g}, "
                          f"magnitude sum {mag:.6g})")
        res[label] = r
        if verbose:
            print(f"[ga] {label}: {draws} draws, {r['over_bar']} over GA_RTOL "
                  f"({r['over_bar_kernel_nearer']} with the kernel nearer the f64 sum); "
                  f"kernel nearer {r['kernel_nearer']}, twin nearer {r['twin_nearer']}, "
                  f"equal {r['equal']}; worst on the magnitude sum kernel "
                  f"{r['worst_kernel_on_mag']:.3g} twin {r['worst_twin_on_mag']:.3g}; worst "
                  f"rel {r['worst_rel']:.3g}; worst cancellation {r['worst_cancellation']:.4g}")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("qat_probe: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    # the wire pair's twins are this checkout's (``quant_pack_tiles``' row0
    # for a chunk's counter bits), whichever package the kernels come from
    from repro_torch.kernels import ref as R
    if "--src" in sys.argv[1:]:
        root = Path(sys.argv[sys.argv.index("--src") + 1]).resolve()
        for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
            del sys.modules[name]
        sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import fp8_quant as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"[qat-probe] kernels of {root}")
    K.build()
    dev = torch.device("cuda")
    if "--wire" in sys.argv[1:]:
        res = {"wire": measure_wire(dev, K, R)}
    elif "--sub-fq" in sys.argv[1:]:
        res = {"sub_fq": sub_fq_cases(dev, K, R)}
    elif "--sub-dec" in sys.argv[1:]:
        res = {"sub_dec": sub_dec_cases(dev, K, R)}
    elif "--b9" in sys.argv[1:]:
        res = {"b9": b9_cases(dev, K, R)}
    elif "--ga" in sys.argv[1:]:
        res = {"ga": ga_cases(dev, K, R)}
    else:
        res = {} if "--b6" in sys.argv[1:] else measure(dev, K)
        res["b6"] = measure_b6(dev)
    print(json.dumps({"qat_probe": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
