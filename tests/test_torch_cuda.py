"""The hand-written CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU (sm_90a) and ``nvcc``; without a card
they skip. They import neither ``jax`` nor the reference package, so they
run on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerance: bitwise, except the scalar clip cotangent at relative 1e-5 (the
kernel reduces per-block partial sums in a fixed order, the twin with
``torch.sum``; the cotangent is drawn with the sign of x, so the sum does
not cancel and a relative error measures the kernel).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import dispatch, fp8_quant, ref

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


@pytest.mark.parametrize("shape", [
    (32, 32, 32, 3), (32, 16, 16, 6), (32, 1024), (32, 120), (32, 84),
    (5, 5, 3, 6), (5, 5, 6, 16), (1024, 120), (120, 84), (84, 10),
    (135, 1024), (8191, 1024)])
def test_quant_det_pair_bitwise_against_twins(dev, shape):
    x = _randn(shape, 1, 0.2, dev)
    g = _randn(shape, 2, 1.0, dev).abs() * torch.sign(x)  # g_alpha terms do not cancel
    a = x.abs().max() * 0.8
    assert torch.equal(fp8_quant.quant_det(x, a), ref.quant_det(x, a))
    gx, ga = fp8_quant.quant_det_bwd(x, a, g)
    rgx, rga = ref.quant_det_bwd(x, a, g)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)


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


def _bits(shape, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 2 ** 32, shape, generator=g, dtype=torch.int64).to(
        torch.int32).view(torch.uint32).to(dev)


# every MLP and LeNet QAT weight shape, and a multi-block ragged shape
RAND_SHAPES = [(32, 64), (64, 64), (64, 10), (5, 5, 3, 6), (5, 5, 6, 16),
               (1024, 120), (120, 84), (84, 10), (8191, 1024)]


@pytest.mark.parametrize("shape", RAND_SHAPES)
def test_quant_rand_pair_bitwise_against_twins(dev, shape):
    x = _randn(shape, 7, 0.2, dev)
    bits = _bits(shape, 8, dev)
    g = _randn(shape, 9, 1.0, dev).abs() * torch.sign(x)
    a = x.abs().max() * 0.8
    assert torch.equal(fp8_quant.quant_rand(x, a, bits), ref.quant_rand(x, a, bits))
    gx, ga = fp8_quant.quant_rand_bwd(x, a, bits, g)
    rgx, rga = ref.quant_rand_bwd(x, a, bits, g)
    assert torch.equal(gx, rgx)
    np.testing.assert_allclose(float(ga), float(rga), rtol=1e-5)


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
