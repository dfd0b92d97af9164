"""Stochastic QAT's counter route: a weight site's bits as a key.

``CounterQatBits`` hands each weight site a ``ref.CounterKey`` instead of a
u32 tensor; on the card the B6 kernels (``csrc/quant_rand.cu``) draw the
site's bits from it, ``fmix32(fmix32((u32)i ^ (k0 ^ mix)) ^ k1)``, and on the
CPU the twins materialize them. Held here, on the CPU: the hash against a
numpy u32 oracle, the key route bitwise the tensor route through
``dispatch.quantize_rand`` (out, gx, g_alpha), and whole rand-qat rounds
bitwise the same with keys and with materialized bits.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import optim, tree
from repro_torch.core.engine import CounterQatBits, FedConfig
from repro_torch.core.fedsim import FedSim
from repro_torch.core.fp8 import E4M3, E5M2
from repro_torch.core.qat import QATConfig
from repro_torch.data import partition_iid, synthetic_classification
from repro_torch.kernels import dispatch, ref
from repro_torch.models import small

MLP_WEIGHTS = ((32, 64), (64, 64), (64, 10), (64, 100))   # the rand-qat MLPs' weights


def _fmix32(h: np.ndarray) -> np.ndarray:
    """murmur3's finalizer in native u32 arithmetic (numpy wraps mod 2^32)."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def _oracle(idx: np.ndarray, k0: int, k1: int, site: int) -> np.ndarray:
    """The kernel's bits: the index cut to u32, the site's word in k0."""
    mix = np.uint32((site * 0x9E3779B9) & 0xFFFFFFFF)
    i = (idx & 0xFFFFFFFF).astype(np.uint32)
    with np.errstate(over="ignore"):
        return _fmix32(_fmix32(i ^ (np.uint32(k0) ^ mix)) ^ np.uint32(k1))


def _u32(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.int64)).to(torch.uint32)


_NEAR = np.concatenate([np.arange(0, 300), np.arange(2 ** 16 - 150, 2 ** 16 + 150),
                        np.arange(2 ** 32 - 300, 2 ** 32), np.arange(2 ** 32, 2 ** 32 + 40)])


@pytest.mark.parametrize("seed", range(6))
def test_counter_bits_match_a_numpy_u32_oracle(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2 ** 32, (8, 2), dtype=np.int64)
    keys[0] = (0, 0)
    keys[1] = (2 ** 32 - 1, 2 ** 32 - 1)
    idx = torch.from_numpy(_NEAR.astype(np.int64))
    for k0, k1 in keys:
        for site in (0, 1, 2, 3, 7, 1000, int(rng.integers(0, 2 ** 31))):
            mix = (site * ref.SITE_MIX) & 0xFFFFFFFF
            got = ref.as_u32(ref.counter_bits(idx, int(k0) ^ mix, int(k1)))
            want = _oracle(_NEAR, int(k0), int(k1), site)
            np.testing.assert_array_equal(got.to(torch.int64).numpy() & 0xFFFFFFFF,
                                          want.astype(np.int64))
            key = ref.CounterKey(_u32([k0, k1]), site)
            assert key.mix == mix
            head = key.bits((300,))
            np.testing.assert_array_equal(head.to(torch.int64).numpy() & 0xFFFFFFFF,
                                          want[:300].astype(np.int64))


def test_the_provider_hands_out_keys_of_todays_bits():
    rng = np.random.default_rng(7)
    keys = _u32(rng.integers(0, 2 ** 32, (3, 4, 2)))
    src = CounterQatBits(keys)
    for client, step, site, shape in ((0, 0, 1, (32, 64)), (2, 3, 3, (64, 100)),
                                      (1, 2, 2, (5, 5, 6, 16))):
        key = src.provider(client, step)(site, shape)
        assert isinstance(key, ref.CounterKey) and key.site == site
        assert torch.equal(key.key2, keys[client, step])
        k0, k1 = (int(v) for v in keys[client, step].to(torch.int64))
        want = _oracle(np.arange(int(np.prod(shape))), k0, k1, site).reshape(shape)
        np.testing.assert_array_equal(key.bits(shape).to(torch.int64).numpy() & 0xFFFFFFFF,
                                      want.astype(np.int64))


@pytest.mark.parametrize("fmt", [E4M3, E5M2], ids=["e4m3", "e5m2"])
@pytest.mark.parametrize("shape", MLP_WEIGHTS)
def test_key_route_is_bitwise_the_tensor_route(shape, fmt):
    rng = np.random.default_rng(sum(shape))
    w0 = rng.standard_normal(shape).astype(np.float32) * 0.3
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    key = ref.CounterKey(_u32(rng.integers(0, 2 ** 32, 2)), 2)
    outs = []
    for bits in (key, key.bits(shape)):
        w = torch.from_numpy(w0.copy()).requires_grad_()
        a = (w.detach().abs().max() * 0.8).requires_grad_()
        out = dispatch.quantize_rand(w, a, bits, fmt)
        gx, ga = torch.autograd.grad(out, (w, a), g)
        outs.append((out.detach(), gx, ga))
    for got, want in zip(*outs):
        assert torch.equal(got, want)
    # and the twins directly, with either form of the bits
    w, a = torch.from_numpy(w0), torch.tensor(float(np.abs(w0).max() * 0.8))
    assert torch.equal(ref.quant_rand(w, a, key, fmt), ref.quant_rand(w, a, key.bits(shape), fmt))
    for got, want in zip(ref.quant_rand_bwd(w, a, key, g, fmt),
                         ref.quant_rand_bwd(w, a, key.bits(shape), g, fmt)):
        assert torch.equal(got, want)


def test_stacked_alpha_takes_the_plain_chain_with_a_key():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 20, 8)).astype(np.float32) * 0.2)
    a = torch.tensor([[[0.3]], [[0.4]], [[0.5]]])
    key = ref.CounterKey(_u32([12345, 678]), 4)
    assert torch.equal(dispatch.quantize_rand(x, a, key),
                       dispatch.quantize_rand(x, a, key.bits(x.shape)))


@dataclasses.dataclass(frozen=True)
class _Materialized:
    """``CounterQatBits`` with each site's bits made as a u32 tensor."""

    src: CounterQatBits

    def provider(self, client, step):
        fn = self.src.provider(client, step)
        return lambda site, shape: fn(site, shape).bits(shape)

    def to(self, device):
        return _Materialized(self.src.to(device))


def test_rand_qat_rounds_are_bitwise_the_same_with_keys_and_with_bits():
    x, y = synthetic_classification(0, 400, d=32, n_classes=10, noise=1.0)
    cx, cy, nk = partition_iid(x, y, k=4, seed=0)
    cfg = FedConfig(n_clients=4, participation=0.5, local_steps=3, batch_size=8,
                    qat=QATConfig(mode="rand"))

    def run(materialize: bool):
        p = small.init_mlp(0, device="cpu")
        sim = FedSim(p, small.make_loss(small.apply_mlp), small.apply_mlp, optim.sgd(0.05),
                     cfg, cx, cy, nk, device="cpu")
        g = torch.Generator().manual_seed(5)
        draws = []
        for _ in range(2):
            d = sim.engine.draw(g, sim.nk.cpu(), sim.client_data.shape[1])
            assert isinstance(d.qat_bits, CounterQatBits)
            draws.append(dataclasses.replace(d, qat_bits=_Materialized(d.qat_bits))
                         if materialize else d)
        hist = sim.run(2, draws=draws, eval_data=(x, y), eval_every=1)
        return sim, hist

    (s1, h1), (s2, h2) = run(False), run(True)
    for (n, a), (_, b) in zip(tree.flatten(s1.params), tree.flatten(s2.params)):
        assert torch.equal(a, b), n
    assert h1.loss == h2.loss and h1.accuracy == h2.accuracy
    assert all(np.isfinite(h1.loss))
