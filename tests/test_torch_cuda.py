"""The hand-written CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and ``nvcc``; without a card
they skip. They import neither ``jax`` nor the reference package, so they
run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bitwise, except the scalar clip cotangent at relative 1e-5 (the
kernel reduces per-block partial sums in a fixed order, the twin with
``torch.sum``; the cotangent is drawn with the sign of x, so the sum does
not cancel and a relative error measures the kernel), and B10 / B11 (dx and
dw), which sum bf16 frames on tensor cores: per element ``|out - ref64| /
mag`` against the f64 product of the twin's quantized operands, at most 4x
the twin's own worst or 2^-20 (``ref.within_bar``), nonzero only where the
masked f64 product is (``ref.stray_nonzeros``), and two
calls bitwise equal.
"""
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tree
from repro_torch.core.fp8 import E4M3, E5M2, FP4_E2M1, FP4_E3M0
from repro_torch.kernels import dispatch, fp8_quant, ref

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import qat_probe  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _randn(shape, seed, scale, dev):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(dev)


def _key(dev):
    return torch.tensor([7, 0xFFFFFFF0], dtype=torch.int64).to(torch.uint32).to(dev)


# every LeNet QAT site and weight shape, the wire plane, a multi-block ragged
# shape, and odd lengths around the 16-byte vectors: a lone element, one
# vector less and more one, a ragged tail, and 2^21 + 3 (the scale table)
QAT_PAIR_SHAPES = [
    (32, 32, 32, 3), (32, 16, 16, 6), (32, 1024), (32, 120), (32, 84),
    (5, 5, 3, 6), (5, 5, 6, 16), (1024, 120), (120, 84), (84, 10),
    (135, 1024), (8191, 1024), (1,), (7,), (8,), (9,), (4097,), (2 ** 21 + 3,)]


@pytest.mark.parametrize("shape", QAT_PAIR_SHAPES)
def test_quant_det_pair_bitwise_against_twins(dev, shape):
    x = _randn(shape, 1, 0.2, dev)
    g = _randn(shape, 2, 1.0, dev).abs() * torch.sign(x)  # g_alpha terms do not cancel
    a = x.abs().max() * 0.8
    assert torch.equal(fp8_quant.quant_det(x, a), ref.quant_det(x, a))
    gx, ga = fp8_quant.quant_det_bwd(x, a, g)
    rgx, rga = ref.quant_det_bwd(x, a, g)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)
    gx2, ga2 = fp8_quant.quant_det_bwd(x, a, g)
    assert torch.equal(gx2, gx) and torch.equal(ga2, ga)   # the same grid, the same sum


@pytest.mark.parametrize("n", [7, 4097, 2 ** 21 + 3])
@pytest.mark.parametrize("offsets", [(1, 3), (5, 0), (0, 7), (6, 2), (4, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_det_pair_on_misaligned_views(dev, n, offsets, dtype):
    """Views 1-7 elements into their storage, x and g misaligned differently
    (the one-element path), or alike (the vector path from a ragged head)."""
    ox, og = offsets
    x = (_randn((n + 8,), 3, 1.5, dev).to(dtype))[ox:ox + n]
    g = (_randn((n + 8,), 4, 1.0, dev).abs().to(dtype))[og:og + n]
    g.mul_(torch.sign(x))
    a = x.float().abs().max() * 0.8
    assert torch.equal(fp8_quant.quant_det(x, a), ref.quant_det(x, a))
    gx, ga = fp8_quant.quant_det_bwd(x, a, g)
    rgx, rga = ref.quant_det_bwd(x, a, g)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)
    gx2, ga2 = fp8_quant.quant_det_bwd(x, a, g)
    assert torch.equal(gx2, gx) and torch.equal(ga2, ga)


@pytest.mark.parametrize("fmt", [E5M2, FP4_E2M1, FP4_E3M0])
@pytest.mark.parametrize("alpha", [0.0731, 2.7, 37.0])
def test_quant_det_pair_scale_table_at_every_format(dev, fmt, alpha):
    """From 2^20 elements on, B1/B2 take s from the per-call scale table:
    bitwise det_code's at every format's exponent steps."""
    x = _randn(((1 << 20) + 5,), 5, alpha / 3, dev)
    g = _randn(((1 << 20) + 5,), 6, 1.0, dev).abs() * torch.sign(x)
    a = torch.tensor(alpha, device=dev)
    assert torch.equal(fp8_quant.quant_det(x, a, fmt), ref.quant_det(x, a, fmt))
    gx, ga = fp8_quant.quant_det_bwd(x, a, g, fmt)
    rgx, rga = ref.quant_det_bwd(x, a, g, fmt)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_det_bwd_is_one_kernel_a_call(dev, dtype):
    from torch.profiler import ProfilerActivity, profile
    x = _randn((8, 128, 2048), 7, 1.5, dev).to(dtype)
    g = _randn((8, 128, 2048), 8, 1.0, dev).to(dtype)
    a = torch.tensor(4.0, device=dev)
    fp8_quant.quant_det_bwd(x, a, g)    # the workspace is allocated before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in()
        for _ in range(3):
            fp8_quant.quant_det_bwd(x, a, g)
        torch.cuda.synchronize()
    kernels = _cuda_kernels(prof)
    assert all("quant_det_bwd_kernel" in e.key for e in kernels), [e.key for e in kernels]
    assert sum(e.count for e in kernels) == 3


@pytest.mark.parametrize("shape", [(135, 1024), (8191, 1024)])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_pack_unpack_bitwise_against_twins(dev, shape, alpha_layout, stochastic):
    x = _randn(shape, 3, 0.2, dev)
    a2 = x.abs().amax(dim=1, keepdim=True) * 0.9
    if alpha_layout == "full":
        a2 = a2.expand(shape).contiguous()
    k = _key(dev) if stochastic else None
    codes = fp8_quant.quant_pack_tiles(x, a2, k)
    assert torch.equal(codes, ref.quant_pack_tiles(x, a2, k))
    assert torch.equal(fp8_quant.unpack_tiles(codes, a2), ref.unpack_tiles(codes, a2))


def _wire_against_twins(x, a2, key, fmt, chunk=None):
    """B3's codes and B4's values on them against the twins bit for bit, in
    row chunks of ``chunk``; a second call of each bitwise the first; one
    launch a call (``qat_probe.wire_check``)."""
    r = qat_probe.wire_check(fp8_quant, ref, x, a2, key, fmt, chunk)
    assert r == {"bad_codes": 0, "bad_values": 0, "repeat_bitwise": True,
                 "one_launch_each": True}, r


def _wire_alphas(x, layout):
    """The clips of a wire case: a row-max column, a column alternating
    between two clips row by row, each expanded to (R, 1024) (constant along
    a row, as the LM's stacked clips are), or (R, 1024) varying within rows."""
    col = x.abs().amax(dim=1, keepdim=True) * 0.9
    alt = torch.where(torch.arange(x.shape[0], device=x.device).reshape(-1, 1) % 2 == 0,
                      torch.tensor(0.0731, device=x.device), torch.tensor(0.45, device=x.device))
    if layout == "column":
        return col
    if layout == "alternating":
        return alt
    if layout == "full":
        return col.expand(x.shape).contiguous()
    if layout == "alternating full":
        return alt.expand(x.shape).contiguous()
    return col * (1.0 + torch.rand(x.shape, device=x.device))   # varying within rows


WIRE_LAYOUTS = ["column", "alternating", "full", "alternating full", "varying"]


@pytest.mark.parametrize("rows", [1, 3, 9, 135, 4097, 8191])
@pytest.mark.parametrize("layout", WIRE_LAYOUTS)
@pytest.mark.parametrize("fmt", [E4M3, E5M2])
@pytest.mark.parametrize("stochastic", [False, True])
def test_wire_pair_bitwise_at_odd_rows_and_every_alpha_layout(dev, rows, layout, fmt,
                                                              stochastic):
    x = _randn((rows, 1024), 40 + rows, 0.2, dev)
    x[0, :4] = torch.tensor([0.0, -0.0, 1e-40, -3e-45])
    _wire_against_twins(x, _wire_alphas(x, layout), _key(dev) if stochastic else None, fmt)


@pytest.mark.parametrize("rows", [(1 << 14) + 3, (1 << 20) + 5])
def test_wire_pair_past_2_24_and_2_30_elements(dev, rows):
    """Element indices (the counter bits' input) beyond 2^24 and 2^30."""
    g = torch.Generator(device=dev).manual_seed(41)
    x = torch.randn((rows, 1024), generator=g, device=dev) * 0.02
    for layout in ("alternating", "alternating full"):
        a2 = _wire_alphas(x, layout)
        for key in (None, _key(dev)):
            _wire_against_twins(x, a2, key, E4M3, chunk=1 << 15)
        del a2
        torch.cuda.empty_cache()


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 3, 0), (0, 4, 0), (0, 0, 2), (3, 7, 1),
                                     (4, 16, 4)])
@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("rows", [135, 8191])
def test_wire_pair_on_misaligned_views(dev, offsets, stochastic, rows):
    """x, the codes and the (R, 1024) clips as views whose rows start off a
    16-byte boundary (storage offsets in elements: f32, u8, f32), below one
    wave and above it (where aligned operands take the 16-element kernels)."""
    ox, oc, oa = offsets
    n = rows * 1024
    x = _randn((n + 16,), 42, 0.2, dev)[ox:ox + n].view(rows, 1024)
    key = _key(dev) if stochastic else None
    for layout in ("column", "full", "varying"):
        a = _wire_alphas(x, layout)
        if a.shape[1] != 1:
            a = torch.cat([torch.ones(oa, device=dev), a.reshape(-1)])[oa:].view(rows, 1024)
        _wire_against_twins(x, a, key, E4M3)
        codes = fp8_quant.quant_pack_tiles(x, a, key)
        c = torch.zeros(n + 16, dtype=torch.uint8, device=dev)[oc:oc + n].view(rows, 1024)
        c.copy_(codes)
        assert torch.equal(fp8_quant.unpack_tiles(c, a).view(torch.int32),
                           ref.unpack_tiles(c, a).view(torch.int32))


def _bits(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, shape, generator=g, dtype=torch.int64).to(
        torch.int32).view(torch.uint32).to(dev)


# every MLP and LeNet QAT weight shape (the rand-qat MLP's (64, 100) too), a
# multi-block ragged shape, odd lengths around the 16-byte vectors, and
# 2^21 + 3 (the scale table)
RAND_SHAPES = [(32, 64), (64, 64), (64, 10), (64, 100), (5, 5, 3, 6), (5, 5, 6, 16),
               (1024, 120), (120, 84), (84, 10), (8191, 1024), (1,), (7,), (9,), (4097,),
               (2 ** 21 + 3,)]


def _site_key(seed, site, dev):
    g = torch.Generator().manual_seed(seed)
    k = torch.randint(0, 2 ** 32, (2,), generator=g, dtype=torch.int64)
    return ref.CounterKey(k.to(torch.int32).view(torch.uint32).to(dev), site)


@pytest.mark.parametrize("route", ["bits", "counter"])
@pytest.mark.parametrize("shape", RAND_SHAPES)
def test_quant_rand_pair_bitwise_against_twins(dev, shape, route):
    x = _randn(shape, 7, 0.2, dev)
    bits = _bits(shape, 8, dev) if route == "bits" else _site_key(8, 3, dev)
    g = _randn(shape, 9, 1.0, dev).abs() * torch.sign(x)
    a = x.abs().max() * 0.8
    assert torch.equal(fp8_quant.quant_rand(x, a, bits), ref.quant_rand(x, a, bits))
    gx, ga = fp8_quant.quant_rand_bwd(x, a, bits, g)
    rgx, rga = ref.quant_rand_bwd(x, a, bits, g)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)
    gx2, ga2 = fp8_quant.quant_rand_bwd(x, a, bits, g)
    assert torch.equal(gx2, gx) and torch.equal(ga2, ga)


def test_quant_rand_routes_agree_and_take_misaligned_views(dev):
    """The counter route is bitwise the bits route on the key's materialized
    bits, and both take operands whose offsets differ mod 16."""
    key = _site_key(21, 5, dev)
    for shape in ((64, 100), (8191, 1024)):
        x = _randn(shape, 22, 0.3, dev)
        a = x.abs().max() * 0.7
        assert torch.equal(fp8_quant.quant_rand(x, a, key),
                           fp8_quant.quant_rand(x, a, key.bits(shape)))
    n = (1 << 19) + 3   # past the one-element shapes, short of the scale table
    base = _randn((n + 8,), 23, 0.3, dev)
    bits = _bits((n + 8,), 24, dev)
    g = _randn((n + 8,), 25, 1.0, dev)
    a = base.abs().max() * 0.7
    for ox, ob, og in ((0, 0, 0), (1, 0, 2), (3, 3, 3)):
        x, b, gg = base[ox:ox + n], bits[ob:ob + n], g[og:og + n]
        assert torch.equal(fp8_quant.quant_rand(x, a, b), ref.quant_rand(x, a, b))
        gx, _ = fp8_quant.quant_rand_bwd(x, a, b, gg)
        assert torch.equal(gx, ref.quant_rand_bwd(x, a, b, gg)[0])


def _lead_in():
    """50 ms and spin kernels that start a profiled region whose kernels are
    counted: the profiler on the card loses device records at the start of a
    trace (those of its first millisecond in some traces, and its earliest
    records, more the more traces the process has taken), and the loss falls
    on them."""
    torch.cuda.synchronize()
    time.sleep(0.05)
    for _ in range(256):
        torch.cuda._sleep(100)
    torch.cuda.synchronize()


def _cuda_kernels(prof):
    """The device kernels of a profile that began with ``_lead_in``, which
    must still show some of its spin kernels; those are left out."""
    rows = [e for e in prof.key_averages()
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
            and "memset" not in e.key.lower() and "memcpy" not in e.key.lower()]
    assert any("spin_kernel" in e.key for e in rows), "the profiler lost the whole lead-in"
    return [e for e in rows if "spin_kernel" not in e.key]


@pytest.mark.parametrize("route", ["bits", "counter"])
@pytest.mark.parametrize("shape", [(64, 100), (8191, 1024)])
def test_quant_rand_bwd_is_one_kernel_a_call(dev, shape, route):
    from torch.profiler import ProfilerActivity, profile
    x = _randn(shape, 26, 0.3, dev)
    g = _randn(shape, 27, 1.0, dev)
    bits = _bits(shape, 28, dev) if route == "bits" else _site_key(28, 2, dev)
    a = x.abs().max() * 0.8
    fp8_quant.quant_rand_bwd(x, a, bits, g)   # the workspace is allocated before the profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in()
        for _ in range(3):
            fp8_quant.quant_rand_bwd(x, a, bits, g)
        torch.cuda.synchronize()
    kernels = _cuda_kernels(prof)
    assert all("quant_rand_bwd_kernel" in e.key for e in kernels), [e.key for e in kernels]
    assert sum(e.count for e in kernels) == 3


def test_a_rand_qat_site_is_one_kernel_each_way_with_a_counter_key(dev):
    """A weight site of the rand-qat path as the engine runs it: its key from
    ``CounterQatBits``, one B6 kernel forward and one backward, no bits
    tensor made, and no ``sum_partials_kernel`` anywhere."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.engine import CounterQatBits
    g = torch.Generator().manual_seed(29)
    keys = torch.randint(0, 2 ** 32, (2, 3, 2), generator=g, dtype=torch.int64)
    src = CounterQatBits(keys.to(torch.int32).view(torch.uint32).to(dev))
    w = _randn((64, 100), 30, 0.3, dev).requires_grad_()
    a = (w.detach().abs().max() * 0.8).requires_grad_()
    gw = _randn((64, 100), 31, 1.0, dev)
    dispatch.quantize_rand(w, a, src.provider(1, 2)(3, (64, 100))).backward(gw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_f:
        _lead_in()
        key = src.provider(1, 2)(3, (64, 100))
        out = dispatch.quantize_rand(w, a, key)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_b:
        _lead_in()
        gx, ga = torch.autograd.grad(out, (w, a), gw)
        torch.cuda.synchronize()
    fwd, bwd = _cuda_kernels(prof_f), _cuda_kernels(prof_b)
    assert [e.key.split("<")[0].removeprefix("void ") for e in fwd] == ["quant_rand_kernel"]
    assert sum(e.count for e in fwd) == 1
    assert [e.key.split("<")[0].removeprefix("void ") for e in bwd] == ["quant_rand_bwd_kernel"]
    assert sum(e.count for e in bwd) == 1
    assert isinstance(key, ref.CounterKey)
    bits = key.bits((64, 100))
    assert torch.equal(out, ref.quant_rand(w.detach(), a.detach(), bits))
    rgx, rga = ref.quant_rand_bwd(w.detach(), a.detach(), bits, gw)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)


def test_no_path_launches_sum_partials_kernel(dev):
    """The second pass of the first port's backward is gone: a rand-qat
    MLP round launches B6 and B2 one kernel a backward call, and nothing
    named ``sum_partials_kernel``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import QATConfig
    from repro_torch.data import partition_iid, synthetic_classification
    from repro_torch.models import small
    x, y = synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    cfg = FedConfig(n_clients=4, participation=0.5, local_steps=2, batch_size=8,
                    qat=QATConfig(mode="rand"))
    sim = FedSim(small.init_mlp(0, device=dev), small.make_loss(small.apply_mlp),
                 small.apply_mlp, optim.sgd(0.05), cfg, cx, cy, nk, device=dev)
    sim.run(1, seed=0)
    torch.cuda.synchronize()
    fp8_quant.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _lead_in()
        sim.run(1, seed=1)
        torch.cuda.synchronize()
    counts = {}
    for e in _cuda_kernels(prof):
        k = e.key.removeprefix("void ").split("(")[0].split("<")[0]
        counts[k] = counts.get(k, 0) + e.count
    assert "sum_partials_kernel" not in counts, counts
    assert fp8_quant.LAUNCHES["quant_rand_bwd"] > 0
    assert counts.get("quant_rand_bwd_kernel", 0) == fp8_quant.LAUNCHES["quant_rand_bwd"]
    assert counts.get("quant_rand_kernel", 0) == fp8_quant.LAUNCHES["quant_rand"]
    assert counts.get("quant_det_bwd_kernel", 0) == fp8_quant.LAUNCHES["quant_det_bwd"]


@pytest.mark.parametrize("shape", [(135, 1024), (8191, 1024)])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_fake_quant_tiles_bitwise_against_twin_and_wire(dev, shape, alpha_layout,
                                                        stochastic):
    x = _randn(shape, 10, 0.2, dev)
    a2 = x.abs().amax(dim=1, keepdim=True) * 0.9
    if alpha_layout == "full":
        a2 = a2.expand(shape).contiguous()
    k = _key(dev) if stochastic else None
    q = fp8_quant.fake_quant_tiles(x, a2, k)
    assert torch.equal(q, ref.fake_quant_tiles(x, a2, k))
    # the same grid point as the wire's encode -> decode, within 1 f32 ULP
    wire = fp8_quant.unpack_tiles(fp8_quant.quant_pack_tiles(x, a2, k), a2)
    aw = wire.abs()
    ulp = torch.nextafter(aw, torch.full_like(aw, float("inf"))) - aw
    assert bool((torch.abs(q - wire) <= ulp).all())


def test_autograd_function_runs_both_kernels(dev):
    x = _randn((64, 33), 4, 0.2, dev).requires_grad_()
    a = (x.detach().abs().max() * 0.7).requires_grad_()
    before = dict(fp8_quant.LAUNCHES)
    y = dispatch.quantize_det(x, a)
    y.sum().backward()
    assert fp8_quant.LAUNCHES["quant_det"] == before["quant_det"] + 1
    assert fp8_quant.LAUNCHES["quant_det_bwd"] == before["quant_det_bwd"] + 1
    rgx, rga = ref.quant_det_bwd(x.detach(), a.detach(), torch.ones_like(x))
    assert torch.equal(x.grad, rgx)
    np.testing.assert_allclose(float(a.grad), float(rga), rtol=1e-5)


def test_rand_and_plane_functions_run_their_kernels(dev):
    x = _randn((64, 33), 11, 0.2, dev).requires_grad_()
    a = (x.detach().abs().max() * 0.7).requires_grad_()
    bits = _bits((64, 33), 12, dev)
    before = dict(fp8_quant.LAUNCHES)
    dispatch.quantize_rand(x, a, bits).sum().backward()
    assert fp8_quant.LAUNCHES["quant_rand"] == before["quant_rand"] + 1
    assert fp8_quant.LAUNCHES["quant_rand_bwd"] == before["quant_rand_bwd"] + 1
    rgx, rga = ref.quant_rand_bwd(x.detach(), a.detach(), bits, torch.ones_like(x))
    assert torch.equal(x.grad, rgx)
    np.testing.assert_allclose(float(a.grad), float(rga), rtol=1e-5)
    w2 = _randn((4, 1024), 13, 0.2, dev).requires_grad_()
    col = w2.detach().abs().amax(dim=1, keepdim=True)
    dispatch.fake_quant_plane(w2, col, _key(dev)).sum().backward()
    assert fp8_quant.LAUNCHES["fake_quant_tiles"] == before["fake_quant_tiles"] + 1
    assert torch.equal(w2.grad, (w2.detach().abs() <= col).float())


def test_dispatch_raises_on_the_card_where_no_kernel_applies(dev):
    x = _randn((2, 4, 3), 6, 0.2, dev)
    with pytest.raises(NotImplementedError, match="not ported"):
        dispatch.quantize_det(x, torch.full((2, 1, 1), 0.5, device=dev))
    with pytest.raises(NotImplementedError, match="not ported"):
        dispatch.quantize_det(x[0, 0, 0], torch.tensor(0.5, device=dev))


def test_wrappers_validate_inputs(dev):
    x = _randn((4, 1024), 5, 0.2, dev)
    with pytest.raises(ValueError, match="contiguous"):
        fp8_quant.quant_det(x.t(), x.abs().max())
    with pytest.raises(TypeError, match="float32"):
        fp8_quant.quant_det(x.double(), x.abs().max())
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        fp8_quant.quant_pack_tiles(x, torch.ones((4, 2), device=dev))
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fp8_quant.quant_det(x, torch.tensor(1.0))


FP4 = {"e2m1": FP4_E2M1, "e3m0": FP4_E3M0}


def _fp4_case(shape, seed, alpha_layout, dev):
    x = _randn(shape, seed, 0.2, dev)
    x[-1, 517:] = 0.0                      # an odd-length leaf's tail, zero fill after
    a2 = x.abs().amax(dim=1, keepdim=True) * 0.9
    if alpha_layout == "full":
        a2 = a2.expand(shape).contiguous()
    return x, a2


@pytest.mark.parametrize("shape", [(9, 1024), (135, 1024), (8191, 1024)])
@pytest.mark.parametrize("fmt", list(FP4))
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_fp4_pack_unpack_bitwise_against_twins(dev, shape, fmt, alpha_layout, stochastic):
    f = FP4[fmt]
    x, a2 = _fp4_case(shape, 14, alpha_layout, dev)
    k = _key(dev) if stochastic else None
    codes = fp8_quant.quant_pack_sub_tiles(x, a2, k, f)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (shape[0], 512)
    assert torch.equal(codes, ref.quant_pack_sub_tiles(x, a2, k, f))
    assert not codes[-1, 517 // 2 + 1:].any() and int(codes[-1, 517 // 2]) >> 4 == 0
    vals = fp8_quant.unpack_sub_tiles(codes, a2, f)
    assert torch.equal(vals, ref.unpack_sub_tiles(codes, a2, f))
    # packing never changes a rounding decision: B5 at the FP4 format, 1 ULP
    q = fp8_quant.fake_quant_tiles(x, a2, k, f)
    aw = vals.abs()
    assert bool((torch.abs(q - vals) <= torch.nextafter(aw, aw + 1) - aw).all())


@pytest.mark.parametrize("shape", [(9, 1024), (135, 1024), (8191, 1024)])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e2m1", "e3m0"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_amax_kernels_bitwise_against_twins_and_plain_encodes(dev, shape, fmt, stochastic):
    f = {"e4m3": E4M3, "e5m2": E5M2, **FP4}[fmt]
    x, a2 = _fp4_case(shape, 15, "column", dev)
    k = _key(dev) if stochastic else None
    if f.bits == 8:
        codes, rowmax = fp8_quant.quant_pack_amax_tiles(x, a2, k, f)
        plain = fp8_quant.quant_pack_tiles(x, a2, k, f)
        twin = ref.quant_pack_amax_tiles(x, a2, k, f)
    else:
        codes, rowmax = fp8_quant.quant_pack_sub_amax_tiles(x, a2, k, f)
        plain = fp8_quant.quant_pack_sub_tiles(x, a2, k, f)
        twin = ref.quant_pack_sub_amax_tiles(x, a2, k, f)
    assert torch.equal(codes, plain) and torch.equal(codes, twin[0])
    assert torch.equal(rowmax, torch.amax(x.abs(), 1, keepdim=True))
    assert torch.equal(rowmax, twin[1])


def test_new_wrappers_count_and_validate(dev):
    x = _randn((4, 1024), 16, 0.2, dev)
    col = x.abs().amax(dim=1, keepdim=True)
    before = dict(fp8_quant.LAUNCHES)
    c = dispatch.quant_pack_sub_tiles(x, col, _key(dev))
    dispatch.unpack_sub_tiles(c, col)
    dispatch.quant_pack_amax_tiles(x, col)
    dispatch.quant_pack_sub_amax_tiles(x, col, _key(dev), FP4_E3M0)
    for name in ("quant_pack_sub_tiles", "unpack_sub_tiles", "quant_pack_amax_tiles",
                 "quant_pack_sub_amax_tiles"):
        assert fp8_quant.LAUNCHES[name] == before[name] + 1, name
    with pytest.raises(TypeError, match="float32"):
        fp8_quant.quant_pack_sub_tiles(x.double(), col)
    with pytest.raises(ValueError, match=r"\(R, 512\)"):
        fp8_quant.unpack_sub_tiles(torch.zeros((4, 1024), dtype=torch.uint8, device=dev), col)
    with pytest.raises(TypeError, match="uint8"):
        fp8_quant.unpack_sub_tiles(c.int(), col)
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        fp8_quant.quant_pack_amax_tiles(x, torch.ones((4, 2), device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fp8_quant.quant_pack_sub_amax_tiles(x.t().contiguous().t(), col)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fp8_quant.quant_pack_sub_tiles(x, col.cpu())
    with pytest.raises(ValueError, match="one byte each"):
        fp8_quant.quant_pack_sub_tiles(x, col, None, E4M3)


# --- the cohort launches: B8 over P planes, B5 over G clip slices -----------


def _alpha_stack(x3, layout):
    """Clips for a stack of planes: a row-max column, it expanded to (R,
    1024), or (R, 1024) varying within rows."""
    col = x3.abs().amax(dim=2, keepdim=True) * 0.9
    if layout == "column":
        return col
    if layout == "full":
        return col.expand(x3.shape).contiguous()
    g = torch.Generator(device=x3.device).manual_seed(3)
    return col * (0.7 + 0.3 * torch.rand(x3.shape, generator=g, device=x3.device))


@pytest.mark.parametrize("p", [1, 3, 20])
@pytest.mark.parametrize("rows", [1, 9, 135, 8191])
@pytest.mark.parametrize("fmt", list(FP4))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cohort_encode_is_its_twin_and_p_single_launches(dev, p, rows, fmt, layout,
                                                         stochastic):
    f = FP4[fmt]
    x3 = _randn((p, rows, 1024), 43 + rows, 0.2, dev)
    x3[:, -1, 517:] = 0.0
    a3 = _alpha_stack(x3, layout)
    keys = qat_probe.key_rows(p, dev, 44) if stochastic else None
    before = fp8_quant.LAUNCHES["quant_pack_sub_tiles"]
    codes = fp8_quant.quant_pack_sub_many(x3, a3, keys, f)
    assert fp8_quant.LAUNCHES["quant_pack_sub_tiles"] == before + 1
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (p, rows, 512)
    assert torch.equal(codes, ref.quant_pack_sub_tiles_many(x3, a3, keys, f))
    for i in range(p):
        k = None if keys is None else keys[i]
        assert torch.equal(codes[i], fp8_quant.quant_pack_sub_tiles(x3[i], a3[i], k, f))


@pytest.mark.parametrize("g_count", [1, 3, 20])
@pytest.mark.parametrize("rows", [1, 9, 135, 8191])
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_clip_search_is_its_twin_and_g_single_launches(dev, g_count, rows, layout, stochastic):
    x = _randn((rows, 1024), 45 + rows, 0.2, dev)
    a3 = _alpha_stack(x[None].expand(g_count, rows, 1024), layout)
    a3 = a3 * torch.linspace(0.5, 1.0, g_count, device=dev)[:, None, None]
    keys = qat_probe.key_rows(g_count, dev, 46) if stochastic else None
    before = fp8_quant.LAUNCHES["fake_quant_tiles"]
    q = fp8_quant.fake_quant_many(x, a3, keys)
    assert fp8_quant.LAUNCHES["fake_quant_tiles"] == before + 1
    assert q.dtype == torch.float32 and tuple(q.shape) == (g_count, rows, 1024)
    assert torch.equal(q.view(torch.int32),
                       ref.fake_quant_tiles_many(x, a3, keys).view(torch.int32))
    for i in range(g_count):
        k = None if keys is None else keys[i]
        assert torch.equal(q[i].view(torch.int32),
                           fp8_quant.fake_quant_tiles(x, a3[i], k).view(torch.int32))


def test_cohort_wrappers_validate_inputs(dev):
    x3 = _randn((3, 4, 1024), 47, 0.2, dev)
    a3 = x3.abs().amax(dim=2, keepdim=True)
    keys = qat_probe.key_rows(3, dev, 48)
    with pytest.raises(TypeError, match="float32"):
        fp8_quant.quant_pack_sub_many(x3.double(), a3, keys)
    with pytest.raises(TypeError, match="uint32"):
        fp8_quant.quant_pack_sub_many(x3, a3, keys.to(torch.int64))
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        fp8_quant.quant_pack_sub_many(x3, a3, keys[:2])
    with pytest.raises(ValueError, match="contiguous"):
        fp8_quant.quant_pack_sub_many(x3.transpose(0, 1).contiguous().transpose(0, 1), a3)
    with pytest.raises(ValueError, match=r"\(P, R, 1024\)"):
        fp8_quant.quant_pack_sub_many(x3, a3[:2])
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fp8_quant.quant_pack_sub_many(x3, a3.cpu(), keys)
    with pytest.raises(ValueError, match="one byte each"):
        fp8_quant.quant_pack_sub_many(x3, a3, None, E4M3)
    with pytest.raises(TypeError, match="float32"):
        fp8_quant.fake_quant_many(x3[0], a3.double(), keys)
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        fp8_quant.fake_quant_many(x3[0], torch.ones((3, 4, 2), device=dev), keys)
    with pytest.raises(ValueError, match=r"\(G, R, 1\)"):
        fp8_quant.fake_quant_many(x3[0], a3[0], keys)
    with pytest.raises(ValueError, match="contiguous"):
        fp8_quant.fake_quant_many(x3[0].t().contiguous().t(), a3, keys)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fp8_quant.fake_quant_many(x3[0], a3, keys.cpu())


def test_cohort_encode_takes_views_off_a_16_byte_boundary(dev):
    """x and the alphas as views off a 16-byte boundary: the same codes."""
    n = 3 * 9 * 1024
    x3 = _randn((n + 4,), 49, 0.2, dev)[1:1 + n].view(3, 9, 1024)
    for layout in ("column", "full"):
        a3 = _alpha_stack(x3, layout)
        keys = qat_probe.key_rows(3, dev, 50)
        assert torch.equal(fp8_quant.quant_pack_sub_many(x3, a3, keys),
                           ref.quant_pack_sub_tiles_many(x3, a3, keys, FP4_E2M1))


def test_server_step_on_lenet_is_the_per_point_search_in_six_launches(dev):
    """UQ+ on LeNet's plane (P = 3, the paper's 5 GD steps and 20 grid
    points): the parent's tree bitwise, in 5 + 1 launches of B5."""
    from test_torch_cohort_launch import server_optimize_per_point

    from repro_torch.core.server_opt import ServerOptConfig, server_optimize
    from repro_torch.models import small
    from repro_torch.tree import tree_map

    params = small.init_lenet(0, device=dev)
    stacked = tree_map(lambda v: torch.stack([v, v * 1.01, v * 0.99]), params)
    nk = torch.tensor([1.0, 2.0, 3.0], device=dev)
    cfg = ServerOptConfig(enabled=True, gd_steps=5, lr=0.1, n_grid=20)
    gd_keys, grid_keys = qat_probe.key_rows(5, dev, 51), qat_probe.key_rows(20, dev, 52)
    before = fp8_quant.LAUNCHES["fake_quant_tiles"]
    got = server_optimize(stacked, nk, gd_keys, grid_keys, cfg)
    assert fp8_quant.LAUNCHES["fake_quant_tiles"] == before + 6
    want = server_optimize_per_point(stacked, nk, gd_keys, grid_keys, cfg)
    for (n, a), (_, b) in zip(tree.flatten(got), tree.flatten(want)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), n


@pytest.mark.parametrize("up", ["fp4_e2m1", "fp4_e3m0_det", "delta:fp4_e2m1",
                                "rans:fp4_e2m1", "ef:fp4_e2m1_det", "ef:rans:fp4_e2m1_det"])
def test_cohort_uplink_on_the_card_is_one_encode_launch(dev, up):
    """A cohort's FP4 uplink is one B8 launch, and its messages are the
    per-client uplink's bit for bit."""
    from test_torch_cohort_launch import ef_per_client, up_per_client

    from repro_torch.core import codec, wire
    from repro_torch.core.engine import WireLink
    from repro_torch.models import small

    params = small.init_lenet(0, device=dev)
    clients = [tree.tree_map(lambda v, s=s: v * s, params) for s in (1.01, 0.99, 1.02)]
    spec = wire.make_wire_spec(params)
    keys = qat_probe.key_rows(3, dev, 53)
    c = codec.get_codec(up)
    before = fp8_quant.LAUNCHES["quant_pack_sub_tiles"]
    if up.startswith("ef:"):
        e_sel = torch.zeros((3, spec.total), device=dev)
        msgs, new_e, _ = c.up_transit(list(clients), spec, keys, e_sel)
        launched = fp8_quant.LAUNCHES["quant_pack_sub_tiles"] - before
        want, want_e, _ = ef_per_client(c, clients, spec, keys, e_sel)
        assert torch.equal(new_e, want_e)
    else:
        msgs, _ = WireLink("fp4_e2m1", up).up(list(clients), spec, keys, ref=params)
        launched = fp8_quant.LAUNCHES["quant_pack_sub_tiles"] - before
        want, _, _ = up_per_client(c, clients, spec, keys, ref_model=params)
    assert launched == 1
    for m, w in zip(msgs, want):
        for (n, a), (_, b) in zip(tree.flatten(m), tree.flatten(w)):
            assert torch.equal(a, b), (up, n)


def test_format_round_on_the_card_runs_the_new_kernels(dev):
    """A CUDA tensor never reaches a twin: an FP4 + delayed round launches
    the sub-byte kernels, and an E4M3 delayed round the FP8 amax kernel."""
    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import QATConfig
    from repro_torch.data import partition_iid, synthetic_classification
    from repro_torch.models import small

    x, y = synthetic_classification(0, 200, d=32, n_classes=10)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    for kw, kernels in (
            (dict(down_codec="fp4", up_codec="fp4", down_scaling="delayed:4",
                  up_scaling="delayed:4"), ("quant_pack_sub_amax_tiles", "unpack_sub_tiles")),
            (dict(down_codec="fp4", up_codec="delta:fp4"),
             ("quant_pack_sub_tiles", "unpack_sub_tiles")),
            (dict(down_scaling="delayed:4", up_scaling="delayed:4"),
             ("quant_pack_amax_tiles", "unpack_tiles"))):
        p = small.init_mlp(0, device=dev)
        cfg = FedConfig(n_clients=4, participation=0.5, local_steps=2, batch_size=8,
                        qat=QATConfig(), **kw)
        sim = FedSim(p, small.make_loss(small.apply_mlp), small.apply_mlp, optim.sgd(0.05),
                     cfg, cx, cy, nk, device=dev)
        fp8_quant.reset_launches()
        sim.run(1, seed=0)
        torch.cuda.synchronize()
        for name in kernels:
            assert fp8_quant.LAUNCHES[name] > 0, (kw, name)
        if kw.get("down_codec") == "fp4":   # no FP8 encode on an FP4 link
            assert fp8_quant.LAUNCHES["quant_pack_tiles"] == 0



# --- the cohort decode (B8) and the cohort amax encode (B9) -----------------


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("rows", [9, 135, 8191])
@pytest.mark.parametrize("fmt", list(FP4))
@pytest.mark.parametrize("layout", ["column", "full", "varying"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cohort_decode_is_its_twin_and_p_single_launches(dev, p, rows, fmt, layout, stochastic):
    """The decode bitwise its twin and the P single launches, one launch a
    call, two calls equal; the last row an odd leaf's tail (a pad nibble,
    then zero fill)."""
    f = FP4[fmt]
    x3 = _randn((p, rows, 1024), 61 + rows, 0.2, dev)
    x3[:, -1, 517:] = 0.0
    a3 = _alpha_stack(x3, layout)
    keys = qat_probe.key_rows(p, dev, 62) if stochastic else None
    codes = fp8_quant.quant_pack_sub_many(x3, a3, keys, f)
    before = fp8_quant.LAUNCHES["unpack_sub_tiles"]
    vals = fp8_quant.unpack_sub_many(codes, a3, f)
    assert fp8_quant.LAUNCHES["unpack_sub_tiles"] == before + 1
    assert vals.dtype == torch.float32 and tuple(vals.shape) == (p, rows, 1024)
    assert torch.equal(vals.view(torch.int32),
                       ref.unpack_sub_tiles_many(codes, a3, f).view(torch.int32))
    assert torch.equal(vals.view(torch.int32),
                       fp8_quant.unpack_sub_many(codes, a3, f).view(torch.int32))
    assert not vals[:, -1, 517:].any()
    for i in range(p):
        assert torch.equal(vals[i].view(torch.int32),
                           fp8_quant.unpack_sub_tiles(codes[i], a3[i], f).view(torch.int32))


@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("rows", [9, 135, 8191])
@pytest.mark.parametrize("fmt", ["e4m3", "e5m2", "e2m1", "e3m0"])
@pytest.mark.parametrize("layout", ["column", "full", "varying", "expanded"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_cohort_amax_encode_is_its_twin_and_p_single_launches(dev, p, rows, fmt, layout,
                                                              stochastic):
    """Codes bitwise the twin's, the plain encodes' and the P single
    launches', row maxima ``torch.amax``'s, one launch a call, two calls
    equal; the alphas a stack or one slice expanded over P."""
    f = {"e4m3": E4M3, "e5m2": E5M2, **FP4}[fmt]
    x3 = _randn((p, rows, 1024), 63 + rows, 0.2, dev)
    x3[:, -1, 517:] = 0.0
    a3 = _alpha_stack(x3, "column" if layout == "expanded" else layout)
    if layout == "expanded":
        a3 = a3[:1].expand(a3.shape)
    keys = qat_probe.key_rows(p, dev, 64) if stochastic else None
    name = "quant_pack_amax_tiles" if f.bits == 8 else "quant_pack_sub_amax_tiles"
    before = fp8_quant.LAUNCHES[name]
    codes, rowmax = fp8_quant.quant_pack_amax_many(x3, a3, keys, f)
    assert fp8_quant.LAUNCHES[name] == before + 1
    assert tuple(codes.shape) == (p, rows, 1024 * f.bits // 8)
    want_c, want_m = ref.quant_pack_amax_tiles_many(x3, a3, keys, f)
    assert torch.equal(codes, want_c) and torch.equal(rowmax, want_m)
    assert torch.equal(rowmax, torch.amax(x3.abs(), 2, keepdim=True))
    again = fp8_quant.quant_pack_amax_many(x3, a3, keys, f)
    assert torch.equal(again[0], codes) and torch.equal(again[1], rowmax)
    single = fp8_quant.quant_pack_amax_tiles if f.bits == 8 else \
        fp8_quant.quant_pack_sub_amax_tiles
    plain = fp8_quant.quant_pack_tiles if f.bits == 8 else fp8_quant.quant_pack_sub_tiles
    for i in range(p):
        k = None if keys is None else keys[i]
        c, m = single(x3[i], a3[i], k, f)
        assert torch.equal(c, codes[i]) and torch.equal(m, rowmax[i])
        assert torch.equal(plain(x3[i], a3[i], k, f), codes[i])


def test_cohort_decode_and_amax_wrappers_validate_inputs(dev):
    x3 = _randn((3, 4, 1024), 65, 0.2, dev)
    a3 = x3.abs().amax(dim=2, keepdim=True)
    keys = qat_probe.key_rows(3, dev, 66)
    c3 = fp8_quant.quant_pack_sub_many(x3, a3, keys)
    with pytest.raises(ValueError, match=r"\(P, R, 512\)"):
        fp8_quant.unpack_sub_many(c3[:, :, :256].contiguous(), a3)
    with pytest.raises(ValueError, match=r"\(P, R, 512\)"):
        fp8_quant.unpack_sub_many(c3, a3[:2])
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        fp8_quant.unpack_sub_many(c3, torch.ones((3, 4, 2), device=dev))
    with pytest.raises(TypeError, match="uint8"):
        fp8_quant.unpack_sub_many(c3.int(), a3)
    with pytest.raises(ValueError, match="contiguous"):
        fp8_quant.unpack_sub_many(c3.transpose(0, 1).contiguous().transpose(0, 1), a3)
    # codes are read a byte a thread: a view off a 16-byte boundary decodes the same
    off = torch.zeros(3 * 4 * 512 + 1, dtype=torch.uint8, device=dev)[1:].view(3, 4, 512)
    off.copy_(c3)
    assert torch.equal(fp8_quant.unpack_sub_many(off, a3), fp8_quant.unpack_sub_many(c3, a3))
    with pytest.raises(ValueError, match="16-byte aligned"):
        fp8_quant.unpack_sub_many(c3, _randn((3 * 4 * 1024 + 1,), 70, 1.0, dev)[1:].view(
            3, 4, 1024))
    with pytest.raises(ValueError, match="one byte each"):
        fp8_quant.unpack_sub_many(c3, a3, E4M3)
    with pytest.raises(TypeError, match="float32"):
        fp8_quant.quant_pack_amax_many(x3.double(), a3, keys)
    with pytest.raises(ValueError, match=r"\(3, 2\)"):
        fp8_quant.quant_pack_amax_many(x3, a3, keys[:2])
    with pytest.raises(ValueError, match=r"\(P, R, 1024\)"):
        fp8_quant.quant_pack_amax_many(x3, a3[:2])
    with pytest.raises(ValueError, match="expanded over P"):
        fp8_quant.quant_pack_amax_many(x3, torch.ones((3, 8, 1), device=dev)[:, :4])
    with pytest.raises(ValueError, match="16-byte aligned"):
        fp8_quant.quant_pack_amax_many(
            _randn((3 * 4 * 1024 + 1,), 67, 0.2, dev)[1:].view(3, 4, 1024), a3)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        fp8_quant.quant_pack_amax_many(x3, a3.cpu(), keys)


@pytest.mark.parametrize("up", ["fp4_e2m1", "fp4_e3m0_det", "delta:fp4_e2m1",
                                "rans:fp4_e2m1", "ef:fp4_e2m1_det", "ef:rans:fp4_e2m1_det"])
def test_cohort_uplink_on_the_card_is_one_decode_launch(dev, up):
    """A cohort's FP4 uplink decodes in one B8 launch, its messages the
    per-client uplink's bit for bit."""
    from test_torch_cohort_launch import ef_per_client, up_per_client

    from repro_torch.core import codec, wire
    from repro_torch.core.engine import WireLink
    from repro_torch.models import small

    params = small.init_lenet(0, device=dev)
    clients = [tree.tree_map(lambda v, s=s: v * s, params) for s in (1.01, 0.99, 1.02)]
    spec = wire.make_wire_spec(params)
    keys = qat_probe.key_rows(3, dev, 68)
    c = codec.get_codec(up)
    before = fp8_quant.LAUNCHES["unpack_sub_tiles"]
    if up.startswith("ef:"):
        e_sel = torch.zeros((3, spec.total), device=dev)
        msgs, _, _ = c.up_transit(list(clients), spec, keys, e_sel)
        launched = fp8_quant.LAUNCHES["unpack_sub_tiles"] - before
        want, _, _ = ef_per_client(c, clients, spec, keys, e_sel)
    else:
        msgs, _ = WireLink("fp4_e2m1", up).up(list(clients), spec, keys, ref=params)
        launched = fp8_quant.LAUNCHES["unpack_sub_tiles"] - before
        want, _, _ = up_per_client(c, clients, spec, keys, ref_model=params)
    assert launched == 1
    for m, w in zip(msgs, want):
        for (n, a), (_, b) in zip(tree.flatten(m), tree.flatten(w)):
            assert torch.equal(a, b), (up, n)


@pytest.mark.parametrize("up", ["e4m3", "fp4_e2m1"])
def test_scaled_uplink_on_the_card_is_one_amax_launch(dev, up):
    """A delayed-scaling uplink encodes its cohort in one amax launch (an
    FP4 one also decodes in one launch), its messages and ``(P, n_q)`` amax
    the per-client uplink's bit for bit."""
    from test_torch_cohort_decode import up_scaled_per_client

    from repro_torch.core import wire
    from repro_torch.core.engine import WireLink
    from repro_torch.models import small

    params = small.init_lenet(0, device=dev)
    clients = [tree.tree_map(lambda v, s=s: v * s, params) for s in (1.01, 0.99, 1.02)]
    spec = wire.make_wire_spec(params)
    keys = qat_probe.key_rows(3, dev, 69)
    link = WireLink(up, up, "delayed:4", "delayed:4")
    _, st = link.scales_init(params, spec)
    fp4 = up.startswith("fp4")
    amax_name = "quant_pack_sub_amax_tiles" if fp4 else "quant_pack_amax_tiles"
    dec_name = "unpack_sub_tiles" if fp4 else "unpack_tiles"
    before = dict(fp8_quant.LAUNCHES)
    msgs, amax = link.up_scaled(list(clients), spec, keys, st)
    assert fp8_quant.LAUNCHES[amax_name] == before[amax_name] + 1
    assert fp8_quant.LAUNCHES[dec_name] == before[dec_name] + (1 if fp4 else 3)
    want, want_amax = up_scaled_per_client(link.up_c, clients, spec, keys,
                                           link.up_p.effective(st))
    assert torch.equal(amax, want_amax)
    for m, w in zip(msgs, want):
        for (n, a), (_, b) in zip(tree.flatten(m), tree.flatten(w)):
            assert torch.equal(a, b), (up, n)


# --- the rANS pair (B12 decode, and the encode): integer-only, bitwise ------


def _rans_table(fmt, sigma, dev):
    from repro_torch.core import entropy

    return tuple(torch.from_numpy(a).to(dev) for a in entropy.byte_table(fmt, sigma))


def _rans_stream(kind, n, s2s_cpu, seed):
    g = torch.Generator().manual_seed(seed)
    if kind == "random":
        return torch.randint(0, 256, (n,), generator=g).to(torch.uint8)
    if kind == "peaked":
        return s2s_cpu[torch.randint(0, 4096, (n,), generator=g)].to(torch.uint8)
    return torch.full((n,), 255, dtype=torch.uint8)     # the table's least likely end


@pytest.mark.parametrize("n", [1, 15, 16, 17, 4416, 8832, 68325])
@pytest.mark.parametrize("kind", ["random", "peaked", "improbable", "batched", "corrupted",
                                  "clipped"])
@pytest.mark.parametrize("fmt,sigma", [(E4M3, 0.28), (FP4_E2M1, 0.14)])
def test_rans_pair_bitwise_against_twins(dev, n, kind, fmt, sigma):
    """One stream, or (``batched``) a cohort of five in one launch each way,
    bitwise against the twins; ``corrupted`` (every third byte column
    replaced) and ``clipped`` (lengths cut below, or run past the last
    column, so lanes read at ``clip(rpos, 0, cols - 1)``) decode as the twin
    does."""
    from repro_torch.kernels import rans

    freq, cum, s2s = _rans_table(fmt, sigma, dev)
    if kind == "batched":
        kinds = ("random", "peaked", "improbable", "peaked", "random")
        syms = torch.stack([_rans_stream(k, n, s2s.cpu(), n + i)
                            for i, k in enumerate(kinds)]).to(dev)
        before = dict(fp8_quant.LAUNCHES)
        buf, state, lens = rans.rans_encode_many(syms, freq, cum)
        out = rans.rans_decode_many(buf, state, lens, n, freq, cum, s2s)
        for name in ("rans_encode", "rans_decode"):
            assert fp8_quant.LAUNCHES[name] == before[name] + 1, name
        for i in range(len(kinds)):
            for a, b in zip((buf[i], state[i], lens[i]), ref.rans_encode(syms[i], freq, cum)):
                assert torch.equal(a, b), i
        assert torch.equal(out, syms)
        return
    syms = _rans_stream("peaked" if kind in ("corrupted", "clipped") else kind, n, s2s.cpu(),
                        n).to(dev)
    buf, state, lens = rans.rans_encode(syms, freq, cum)
    tbuf, tstate, tlens = ref.rans_encode(syms, freq, cum)
    assert torch.equal(buf, tbuf) and torch.equal(state, tstate) and torch.equal(lens, tlens)
    if kind == "corrupted":
        g = torch.Generator().manual_seed(n)
        buf = buf.clone()
        buf[:, ::3] = torch.randint(0, 256, buf[:, ::3].shape, generator=g).to(torch.uint8).to(dev)
    elif kind == "clipped":
        step = torch.arange(16, dtype=torch.int32, device=dev)
        lens = torch.where(step % 2 == 0, torch.clamp(lens - step, min=0),
                           lens + buf.shape[1] // 2 + step)
    out = dispatch.rans_decode(buf, state, lens, n, freq, cum, s2s)
    assert torch.equal(out, ref.rans_decode(buf, state, lens, n, freq, cum, s2s))
    if kind not in ("corrupted", "clipped"):
        assert torch.equal(out, syms)


def test_rans_large_stream_roundtrips(dev):
    """8191 x 1024 symbols (524k rows a lane): the step-by-step twin is too
    slow on the card here, so the pair is held to decode(encode(s)) == s."""
    from repro_torch.kernels import rans

    freq, cum, s2s = _rans_table(E4M3, 0.28, dev)
    syms = _rans_stream("peaked", 8191 * 1024, s2s.cpu(), 3).to(dev)
    buf, state, lens = rans.rans_encode(syms, freq, cum)
    assert int(lens.sum()) < syms.numel()
    assert torch.equal(rans.rans_decode(buf, state, lens, syms.numel(), freq, cum, s2s), syms)


def test_rans_wrappers_count_and_validate(dev):
    from repro_torch.kernels import rans

    freq, cum, s2s = _rans_table(E4M3, 0.28, dev)
    syms = torch.arange(100, dtype=torch.uint8, device=dev)
    before = dict(fp8_quant.LAUNCHES)
    buf, state, lens = rans.rans_encode(syms, freq, cum)
    rans.rans_decode(buf, state, lens, 100, freq, cum, s2s)
    for name in ("rans_encode", "rans_decode"):
        assert fp8_quant.LAUNCHES[name] == before[name] + 1, name
    with pytest.raises(TypeError, match="uint8"):
        rans.rans_encode(syms.int(), freq, cum)
    with pytest.raises(TypeError, match="int32"):
        rans.rans_encode(syms, freq.long(), cum)
    with pytest.raises(ValueError, match=r"\(256,\)"):
        rans.rans_encode(syms, freq[:255].contiguous(), cum)
    with pytest.raises(ValueError, match="16"):
        rans.rans_decode(buf[:, :3].contiguous(), state, lens, 100, freq, cum, s2s)
    with pytest.raises(ValueError, match="CPU or all on CUDA"):
        rans.rans_decode(buf, state.cpu(), lens, 100, freq, cum, s2s)


def test_pareto_round_on_the_card_runs_the_rans_pair(dev):
    """An ef:rans uplink under a rans downlink on the card: each rANS kernel
    launches once a leg (the downlink's payload, then the cohort's two uplinks
    together), the measured bytes stay under the bound, and exactly the
    cohort's residual rows move."""
    from repro_torch import optim
    from repro_torch.core.engine import FedConfig
    from repro_torch.core.fedsim import FedSim
    from repro_torch.core.qat import QATConfig
    from repro_torch.data import partition_iid, synthetic_classification
    from repro_torch.models import small

    x, y = synthetic_classification(0, 200, d=32, n_classes=10)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    cfg = FedConfig(n_clients=4, participation=0.5, local_steps=2, batch_size=8,
                    qat=QATConfig(), down_codec="rans:fp4_e2m1",
                    up_codec="ef:rans:fp4_e2m1_det")
    p = small.init_mlp(0, device=dev)
    sim = FedSim(p, small.make_loss(small.apply_mlp), small.apply_mlp, optim.sgd(0.05), cfg,
                 cx, cy, nk, device=dev)
    draw = sim.engine.draw(torch.Generator().manual_seed(0), sim.nk.cpu(), cx.shape[1])
    fp8_quant.reset_launches()
    h = sim.run(1, draws=[draw], eval_data=(x[:64], y[:64]), eval_every=1)
    torch.cuda.synchronize()
    for name in ("rans_encode", "rans_decode"):
        assert fp8_quant.LAUNCHES[name] == 2, name
    assert 0 < h.cumulative_bytes[0] < sim.bytes_per_round
    moved = torch.nonzero(sim.state.clients.resid.abs().sum(1) > 0).reshape(-1).cpu()
    assert sorted(moved.tolist()) == sorted(draw.cohort.tolist())


QAT_MATMUL = ("qat_matmul", "qat_matmul_dx", "qat_matmul_dw")


def _matmul_case(m, k, n, seed, dev):
    x = _randn((m, k), seed, 1.5, dev)
    w = _randn((k, n), seed + 1, 1.0 / np.sqrt(k), dev)
    beta = torch.tensor(2.5, device=dev)
    alpha = w.abs().max().reshape(1, 1)           # max|w| sits on the clip
    out = ref.qat_matmul(x, w, beta, alpha)
    g = _randn((m, n), seed + 2, 1.0, dev).abs() * torch.sign(out)
    return x, w, beta, alpha, g


QAT_SHAPES = [(77, 130, 200), (1, 1, 1), (64, 16, 64), (256, 2048, 256), (32, 2048, 1000),
              (32, 2048, 32000), (128, 2048, 1000), (13, 64, 40), (45, 203, 331),
              (1024, 2048, 256), (1100, 300, 520)]


def _bar(kernel_out, twin_out, ref64, mag, label, masked=False):
    e_k = ref.product_error(kernel_out, ref64, mag)
    e_t = ref.product_error(twin_out, ref64, mag)
    assert ref.within_bar(e_k, e_t), f"{label}: error {e_k:.3g}, twin's {e_t:.3g}"
    if masked:   # nonzero only where the masked f64 product is
        assert ref.stray_nonzeros(kernel_out, ref64) == 0, f"{label} mask"


@pytest.mark.parametrize("shape", QAT_SHAPES)
def test_qat_matmul_kernels_bitwise_against_twins(dev, shape):
    """B10, dx and dw at the bar against the f64 product (a tensor-core sum
    cannot equal an ascending f32 loop), dx's and dw's masked elements zero
    (nonzero only where the masked f64 product is); every
    clip cotangent within 1e-5 of the twin's. (45, 203, 331) is ragged on
    every axis (odd N: dw's scalar epilogue); (1024, 2048, 256) and (256,
    2048, 256) are wk / wv's tile-starved (K, N) at the trainer's and the
    federated cell's M; (1100, 300, 520) takes dw past M = 1024."""
    from repro_torch.kernels import fp8_matmul
    x, w, beta, alpha, g = _matmul_case(*shape, 21, dev)
    _bar(fp8_matmul.qat_matmul(x, w, beta, alpha), ref.qat_matmul(x, w, beta, alpha),
         *ref.qat_matmul_f64(x, w, beta, alpha), "qat_matmul")
    got, gc = fp8_matmul.qat_matmul_dx(g, x, w, beta, alpha)
    want, wc = ref.qat_matmul_dx(g, x, w, beta, alpha)
    _bar(got, want, *ref.qat_matmul_dx_f64(g, x, w, beta, alpha), "qat_matmul_dx", True)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-5, err_msg="qat_matmul_dx")
    got, gc = fp8_matmul.qat_matmul_dw(g, x, w, beta, alpha)
    want, wc = ref.qat_matmul_dw(g, x, w, beta, alpha)
    _bar(got, want, *ref.qat_matmul_dw_f64(g, x, w, beta, alpha), "qat_matmul_dw", True)
    np.testing.assert_allclose(float(gc), float(wc), rtol=1e-5, err_msg="qat_matmul_dw")


@pytest.mark.parametrize("shape", [(77, 130, 200), (32, 2048, 32000), (256, 2048, 5632)])
def test_qat_matmul_kernels_are_deterministic(dev, shape):
    """Two calls on the same inputs are bitwise equal, the split reduction
    included (no atomics; shares summed in a fixed order)."""
    from repro_torch.kernels import fp8_matmul
    x, w, beta, alpha, g = _matmul_case(*shape, 23, dev)
    assert torch.equal(fp8_matmul.qat_matmul(x, w, beta, alpha),
                       fp8_matmul.qat_matmul(x, w, beta, alpha))
    for name in ("qat_matmul_dx", "qat_matmul_dw"):
        a, ac = getattr(fp8_matmul, name)(g, x, w, beta, alpha)
        b, bc = getattr(fp8_matmul, name)(g, x, w, beta, alpha)
        assert torch.equal(a, b) and torch.equal(ac, bc), name


def _exponent_steps(alpha, fmt, dev, spread=40):
    """Values within ``spread`` f32 ULP of every point where quant_det's
    exponent p = floor(log2|x| + b) steps up (found by bisection with the
    twin's own arithmetic), up to alpha, both signs: where the kernels'
    exponent tables could part from the twin."""
    a = alpha.reshape(())
    b = ref._bias(a, fmt)
    ks = torch.arange(2, 2 ** fmt.exp, device=dev, dtype=torch.float32)
    lo = torch.zeros(ks.shape, dtype=torch.int32, device=dev)
    hi = torch.full(ks.shape, int(a.view(torch.int32)), dtype=torch.int32, device=dev)
    p = lambda bits: torch.floor(torch.log2(bits.view(torch.float32)) + b)
    while bool((hi - lo > 1).any()):
        mid = (lo + hi) // 2
        up = p(mid) >= ks
        hi, lo = torch.where(up, mid, hi), torch.where(up, lo, mid)
    bits = (hi[:, None] + torch.arange(-spread, spread, device=dev, dtype=torch.int32)).reshape(-1)
    vals = bits.clamp(1, int(a.view(torch.int32))).view(torch.float32)
    return torch.cat([vals, -vals])


@pytest.mark.parametrize("fmt", [E4M3, E5M2])
@pytest.mark.parametrize("alpha", [0.0731, 1.0, 2.5, 6.4, 1e-3, 37.0])
def test_qat_matmul_codes_at_the_exponent_steps(dev, fmt, alpha):
    """The frames the tensor-core kernels stage carry quant_det's codes at
    every exponent step: dx with g the identity returns w's grid values,
    B10 with w the identity x's, each within 2^-20 of the twin's value
    (a wrong code is off by 1/16 or more). dw's epilogue at w's clip sees
    the same values, one every 1/8 binade below alpha, and +-alpha, one ULP
    past it and beyond: x the identity at beta 1, so gw is Q(1) g masked at
    alpha; its mask exact, gw within 2^-20 of the twin's, and g_alpha within
    1e-5, with g signed like each element's route term and scaled by 1 / s,
    so that no term of the sum cancels or vanishes."""
    from repro_torch.kernels import fp8_matmul
    a = torch.tensor(alpha, device=dev)
    vals = _exponent_steps(a, fmt, dev)
    n = 64
    k = -(-vals.numel() // n)
    w = torch.zeros(k * n, device=dev)
    w[:vals.numel()] = vals
    w = w.reshape(k, n)
    eye = torch.eye(n, device=dev)
    one = torch.tensor(1.0, device=dev)
    gx, _ = fp8_matmul.qat_matmul_dx(eye, torch.zeros(n, k, device=dev), w, one, a, fmt)
    want = ref.quant_det(w, a, fmt).t()
    assert float(((gx - want).abs() / want.abs().clamp_min(1e-30)).max()) <= 2.0 ** -20
    out = fp8_matmul.qat_matmul(w, eye, a, one, fmt)
    want = ref.quant_det(w, a, fmt) * ref.quant_det(eye, one, fmt)[0, 0]
    assert float(((out - want).abs() / want.abs().clamp_min(1e-30)).max()) <= 2.0 ** -20

    edge = torch.stack([a, torch.nextafter(a, a * 2), a * 1.25, a * 3])
    spread = a * torch.exp2(-torch.arange(1, 8 * 2 ** fmt.exp, device=dev) / 8.0 - 1 / 64)
    wd = torch.cat([vals, edge, -edge, spread, -spread])
    k2 = -(-wd.numel() // n)
    w2 = torch.zeros(k2 * n, device=dev)
    w2[:wd.numel()] = wd
    w2 = w2.reshape(k2, n)
    _, route = ref._ste(w2, a, torch.ones_like(w2), fmt)
    _, s = ref._scale_p(ref._clip(w2, a), ref._bias(a, fmt), fmt)
    g2 = torch.where(route < 0, -1.0, 1.0) / s
    x2 = torch.eye(k2, device=dev)
    gw, ga = fp8_matmul.qat_matmul_dw(g2, x2, w2, one, a, fmt)
    want, wa = ref.qat_matmul_dw(g2, x2, w2, one, a, fmt)
    assert torch.equal(gw == 0, w2.abs() > a)
    assert float(((gw - want).abs() / want.abs().clamp_min(1e-30)).max()) <= 2.0 ** -20
    np.testing.assert_allclose(float(ga), float(wa), rtol=1e-5)


def test_qat_matmul_dispatch_launches_the_kernels_never_the_twins(dev, monkeypatch):
    from repro_torch.kernels import fp8_matmul
    x, w, beta, alpha, g = _matmul_case(40, 70, 90, 31, dev)
    for name in QAT_MATMUL:
        monkeypatch.setattr(ref, name, lambda *a, _n=name, **k: pytest.fail(f"twin {_n} ran"))
    x.requires_grad_()
    w.requires_grad_()
    b = beta.clone().requires_grad_()
    a = alpha.clone().requires_grad_()
    before = dict(fp8_quant.LAUNCHES)
    out = dispatch.qat_matmul(x, w, b, a)
    out.backward(g)
    torch.cuda.synchronize()
    for name in QAT_MATMUL:
        assert fp8_quant.LAUNCHES[name] == before[name] + 1, name
    assert b.grad.shape == () and a.grad.shape == (1, 1)
    monkeypatch.undo()
    want, _ = ref.qat_matmul_dx(g, x.detach(), w.detach(), beta, alpha)
    _bar(x.grad, want, *ref.qat_matmul_dx_f64(g, x.detach(), w.detach(), beta, alpha), "x.grad",
         True)
    with pytest.raises(ValueError, match="contiguous"):
        fp8_matmul.qat_matmul(x.detach().t().contiguous().t(), w.detach(), beta, alpha)
    with pytest.raises(ValueError, match="one value"):
        fp8_matmul.qat_matmul(x.detach(), w.detach(), torch.ones(2, device=dev), alpha)


def test_tf32_is_off_after_an_entry_point_resolves_the_card(dev):
    from repro_torch import convert
    from repro_torch.device import resolve_device
    from repro_torch.models import small

    entry_points = (lambda: resolve_device("cuda"),
                    lambda: small.init_mlp(0, device="cuda"),
                    lambda: convert.from_jax_params({"w": np.zeros((2, 2), np.float32)}))
    for enter in entry_points:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        enter()
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32


def test_lm_step_on_the_card_runs_only_the_kernels(dev):
    """A reduced TinyLlama loss and backward on the card: every projection
    launches B10 once and each B11 kernel once (3 layers x 7 + 2 CE chunks)."""
    from repro_torch import configs, tree
    from repro_torch.core.qat import QATConfig
    from repro_torch.models import registry

    cfg = configs.reduced(configs.get("tinyllama_1_1b"))
    model = registry.get_model(cfg)
    p = model.init(0, device=dev)
    toks = torch.randint(0, cfg.vocab, (4, 65), generator=torch.Generator().manual_seed(0))
    toks = toks.to(dev)
    leaves = [t.requires_grad_() for t in tree.leaves(p)]
    names = [n for n, _ in tree.flatten(p)]
    before = dict(fp8_quant.LAUNCHES)
    loss = model.train_loss(tree.unflatten(names, leaves),
                            {"tokens": toks[:, :-1], "labels": toks[:, 1:]}, QATConfig())
    loss.backward()
    torch.cuda.synchronize()
    for name in QAT_MATMUL:
        assert fp8_quant.LAUNCHES[name] == before[name] + 3 * 7 + 2, name
    assert bool(torch.isfinite(loss))


# ---------------------------------------------------------------------------
# the one-device trainer's kernels: bf16 B1/B2, B7 on the plane, B9
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 16, 64), (8, 128, 2048), (1024, 5632), (7, 33),
                                   (8, 128, 5632), (8, 16, 2048), (1,), (7,), (8,), (9,),
                                   (4097,), (2 ** 21 + 3,)])
def test_bf16_quant_det_pair_bitwise_against_twins(dev, shape):
    x = _randn(shape, 21, 1.5, dev).to(torch.bfloat16)
    g = (_randn(shape, 22, 1.0, dev).abs() * torch.sign(x.float())).to(torch.bfloat16)
    for a in (torch.tensor(4.0, device=dev), torch.tensor(2.5, device=dev)):
        out = fp8_quant.quant_det(x, a)
        assert out.dtype == torch.bfloat16 and torch.equal(out, ref.quant_det(x, a))
        gx, ga = fp8_quant.quant_det_bwd(x, a, g)
        rgx, rga = ref.quant_det_bwd(x, a, g)
        assert gx.dtype == torch.bfloat16 and ga.dtype == torch.float32
        assert torch.equal(gx, rgx)
        np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)
        gx2, ga2 = fp8_quant.quant_det_bwd(x, a, g)
        assert torch.equal(gx2, gx) and torch.equal(ga2, ga)


def _plane(seg_rows, seed, dev):
    """A ragged plane of segments (a stacked leaf's layers, then single
    leaves), each with its own clip and a zero-padded tail."""
    rows = sum(seg_rows)
    x = _randn((rows, 1024), seed, 0.2, dev)
    col = torch.empty((rows, 1), device=dev)
    r0 = 0
    for i, n in enumerate(seg_rows):
        col[r0:r0 + n] = x[r0:r0 + n].abs().max() * (0.6 + 0.05 * (i % 5))
        x[r0 + n - 1, 700:] = 0.0
        r0 += n
    x[0, 3] = col[0, 0]                    # one element on its clip
    g = _randn((rows, 1024), seed + 1, 1.0, dev).abs() * torch.sign(x)
    return x.contiguous(), col, g.contiguous()


@pytest.mark.parametrize("seg_rows", [(1,), (3, 3, 3, 1, 7), (4096, 512, 512, 4096, 11264),
                                      (2000,) * 4 + (191,)])
def test_quant_det_tiles_pair_bitwise_against_twins(dev, seg_rows):
    x, col, g = _plane(seg_rows, 31, dev)
    before = dict(fp8_quant.LAUNCHES)
    assert torch.equal(fp8_quant.quant_det_tiles(x, col), ref.quant_det_tiles(x, col))
    gx, ga = fp8_quant.quant_det_tiles_bwd(x, col, g)
    rgx, rga = ref.quant_det_tiles_bwd(x, col, g)
    assert torch.equal(gx, rgx) and ga.shape == (x.shape[0], 1)
    np.testing.assert_allclose(ga.cpu().numpy(), rga.cpu().numpy(), rtol=1e-5, atol=1e-6)
    assert fp8_quant.LAUNCHES["quant_det_tiles"] == before["quant_det_tiles"] + 1
    assert fp8_quant.LAUNCHES["quant_det_tiles_bwd"] == before["quant_det_tiles_bwd"] + 1
    # a plane element is a per-tensor element at the same (x, a)
    assert torch.equal(fp8_quant.quant_det_tiles(x, col)[:1],
                       fp8_quant.quant_det(x[:1].contiguous(), col[0, 0].contiguous()))


@pytest.mark.parametrize("shape", [(1, 1024), (135, 1024), (8191, 1024)])
@pytest.mark.parametrize("alpha_layout", ["column", "full"])
@pytest.mark.parametrize("stochastic", [False, True])
def test_fake_quant_amax_bitwise_against_b5_and_amax(dev, shape, alpha_layout, stochastic):
    x = _randn(shape, 41, 0.2, dev)
    x[-1, 517:] = 0.0                         # an odd leaf's tail: the row max is the head's
    a2 = x.abs().amax(dim=1, keepdim=True) * 0.9
    if alpha_layout == "full":
        a2 = a2.expand(shape).contiguous()
        a2[:, ::7] *= 0.75                    # runs of equal alphas broken inside a float4
    k = _key(dev) if stochastic else None
    before = fp8_quant.LAUNCHES["fake_quant_amax_tiles"]
    q, mx = fp8_quant.fake_quant_amax_tiles(x, a2, k)
    assert fp8_quant.LAUNCHES["fake_quant_amax_tiles"] == before + 1
    assert torch.equal(q, fp8_quant.fake_quant_tiles(x, a2, k))
    rq, rmx = ref.fake_quant_amax_tiles(x, a2, k)
    assert torch.equal(q, rq) and torch.equal(mx, rmx)
    assert torch.equal(mx, torch.amax(x.abs(), 1, keepdim=True))
    q2, mx2 = fp8_quant.fake_quant_amax_tiles(x, a2, k)
    assert torch.equal(q2, q) and torch.equal(mx2, mx)


def test_fake_quant_amax_rejects_misaligned_operands(dev):
    """B9 loads x and an (R, 1024) alpha in 16-byte vectors: a view off a
    16-byte boundary is refused, as the amax encodes refuse it; the (R, 1)
    column is read a float a row and may lie anywhere."""
    x = _randn((4, 1024), 42, 0.2, dev)
    col = x.abs().amax(dim=1, keepdim=True)
    off = _randn((4 * 1024 + 1,), 43, 0.2, dev)[1:].view(4, 1024)
    with pytest.raises(ValueError, match="x2: must be 16-byte aligned"):
        fp8_quant.fake_quant_amax_tiles(off, col)
    a_off = torch.empty(4 * 1024 + 1, device=dev)[1:].view(4, 1024)
    a_off.copy_(col.expand(4, 1024))
    with pytest.raises(ValueError, match="alpha: must be 16-byte aligned"):
        fp8_quant.fake_quant_amax_tiles(x, a_off)
    q, mx = fp8_quant.fake_quant_amax_tiles(x, a_off.contiguous().clone())
    assert torch.equal(q, ref.fake_quant_amax_tiles(x, col)[0])
    col_off = torch.zeros(5, 1, device=dev)[1:]
    col_off.copy_(col)
    assert col_off.data_ptr() % 16
    q, mx = fp8_quant.fake_quant_amax_tiles(x, col_off)
    rq, rmx = ref.fake_quant_amax_tiles(x, col)
    assert torch.equal(q, rq) and torch.equal(mx, rmx)


def test_trainer_wrappers_validate_inputs(dev):
    x = _randn((4, 1024), 5, 0.2, dev)
    col = x.abs().amax(dim=1, keepdim=True)
    with pytest.raises(TypeError, match="bfloat16"):
        fp8_quant.quant_det_bwd(x.to(torch.bfloat16), col[0, 0].contiguous(), x)
    with pytest.raises(ValueError, match="aligned"):
        fp8_quant.quant_det_tiles(x.view(-1)[1:1025].reshape(1, 1024), col[:1])
    with pytest.raises(ValueError, match=r"\(R, 1024\)"):
        fp8_quant.quant_det_tiles(x[:, :512].contiguous(), col)
    with pytest.raises(ValueError, match="alpha column"):
        fp8_quant.quant_det_tiles_bwd(x, col[:3], x)


def _reduced_lm(dev):
    from repro_torch import configs
    from repro_torch.models import registry

    cfg = configs.reduced(configs.get("tinyllama_1_1b"))
    return cfg, registry.get_model(cfg), registry.get_model(cfg).init(0, device=dev)


def test_plane_clip_gradients_are_bitwise_repeatable(dev):
    """Two backward passes of ``plane.quantize_det`` on the card give the
    same clip gradients to the bit: the per-row sums are a fixed tree and
    the per-segment sums a fixed-order ``torch.sum`` (no atomics)."""
    from repro_torch import tree
    from repro_torch.core import plane

    _, _, p = _reduced_lm(dev)
    names = [n for n, _ in tree.flatten(p)]
    spec = plane.make_plane_spec(p)
    grads = []
    for _ in range(2):
        leaves = [t.detach().clone().requires_grad_() for t in tree.leaves(p)]
        q = dict(tree.flatten(plane.quantize_det(tree.unflatten(names, leaves), spec=spec,
                                                 out_dtype=torch.bfloat16)))
        loss = sum((q[n].float() * torch.sign(q[n].float())).sum() for n in spec.q_names)
        loss.backward()
        grads.append({n: t.grad.clone() for n, t in zip(names, leaves) if t.grad is not None})
    assert grads[0].keys() == grads[1].keys() and any(n.endswith("_qa") for n in grads[0])
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


def test_train_step_launches_the_plane_pair_once_a_step(dev):
    """Reduced TinyLlama on the card, opt_level 1, two microbatches: one B7
    forward and one B7 backward a step, B1/B2 (bf16) at every activation
    site of both microbatches, no B10/B11; opt_level 0 the reverse."""
    from repro_torch.core.qat import QATConfig
    from repro_torch.launch import steps

    cfg, model, p = _reduced_lm(dev)
    toks = torch.randint(0, cfg.vocab, (4, 65), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    sites = 7 * cfg.n_layers + cfg.ce_chunks
    for opt_level in (1, 0):
        opt = steps.make_optimizer(p, lr=1e-3)
        step = steps.make_train_step(model, opt, QATConfig(), accum=2, opt_level=opt_level)
        before = dict(fp8_quant.LAUNCHES)
        _, _, m = step(p, opt.init(p), batch, 0)
        torch.cuda.synchronize()
        d = {k: fp8_quant.LAUNCHES[k] - before[k] for k in before}
        assert bool(torch.isfinite(m["loss"]))
        if opt_level == 1:
            assert d["quant_det_tiles"] == d["quant_det_tiles_bwd"] == 1
            assert d["quant_det"] == d["quant_det_bwd"] == 2 * sites
            assert all(d[k] == 0 for k in QAT_MATMUL)
        else:
            assert d["quant_det_tiles"] == d["quant_det_tiles_bwd"] == 0
            assert all(d[k] == 2 * sites for k in QAT_MATMUL)
