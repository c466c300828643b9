"""The CUDA chain kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
test, so every pytest worker collects the same tests). Run on the GPU with
``python -m pytest tests/test_torch_kernels.py -m cuda``. chip_smoke.py
repeats these checks at the main path's shapes."""

import math

import numpy as np
import pytest
import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
from slam_decomposition_torch.transpile import kak
from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch

pytestmark = pytest.mark.cuda
LANES = [512, 509]  # 509: a partial last block (32 Adam lanes, 4 LM / polish lanes a block)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(k, dev, seed=0, L=512):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    g64 = torch.as_tensor(a.chain_gates).to(dev)
    T = torch.as_tensor(haar_sample(L, seed=seed)).to(dev)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(0, 2 * math.pi, (L, a.n_params)), dtype=torch.float32).to(dev)
    return g64, g64.to(torch.complex64), T, T.to(torch.complex64).contiguous(), x0


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
def test_adam_kernel_matches_plain(dev, k, L):
    _, g32, _, T32, x0 = _inputs(k, dev, L=L)
    sched = ck.adam_schedule(100, device=dev)[:25].contiguous()
    before = ck.adam_chain.launches
    got = ck.adam_chain(x0, T32, g32, sched)
    assert ck.adam_chain.launches == before + 1
    want = ck.adam_chain_ref(x0, T32, g32, sched)
    # f32 association order only; 25 steps (the JAX kernel test's bound)
    d = (got - want).abs().amax(1)
    assert (d <= 5e-5).float().mean().item() >= 0.99


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
def test_adam_kernel_with_cost(dev, k, L):
    """The instance that ends with one more chain evaluation: the same x as
    the default instance, and the f32 square cost of that x (atol 1e-5:
    f32 sums of 16 products in another order)."""
    _, g32, _, T32, x0 = _inputs(k, dev, seed=3, L=L)
    sched = ck.adam_schedule(100, device=dev)
    before = ck.adam_chain.launches
    x, cost = ck.adam_chain(x0, T32, g32, sched, with_cost=True)
    assert ck.adam_chain.launches == before + 1
    assert cost.shape == (L,) and cost.dtype == torch.float32
    assert torch.equal(x, ck.adam_chain(x0, T32, g32, sched))
    assert (cost - ck.square_cost(x, T32, g32)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
def test_lm_kernel_matches_plain(dev, k, L):
    _, g32, _, T32, x0 = _inputs(k, dev, seed=1, L=L)
    xa = ck.adam_chain(x0, T32, g32, ck.adam_schedule(100, device=dev))
    before = ck.lm_chain.launches
    _, f = ck.lm_chain(xa, T32, g32, 8)
    assert ck.lm_chain.launches == before + 1
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    assert torch.isclose(f, f_ref, rtol=1e-3, atol=1e-5).float().mean().item() >= 0.99


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
def test_polish_kernel_matches_plain(dev, k, L):
    g64, g32, T, T32, x0 = _inputs(k, dev, seed=2, L=L)
    xa = ck.adam_chain(x0, T32, g32, ck.adam_schedule(100, device=dev))
    xl, _ = ck.lm_chain(xa, T32, g32, 8)
    x64 = xl.double().contiguous()
    before = ck.polish_chain.launches
    xp, f = ck.polish_chain(x64, T, g64, 6)
    assert ck.polish_chain.launches == before + 1
    _, f_ref = ck.polish_chain_ref(x64, T, g64, 6)
    c, c_ref = certificate(f), certificate(f_ref)
    assert ((c <= 1e-10) == (c_ref <= 1e-10)).float().mean().item() >= 0.99
    ok = c <= 1e-10
    assert ok.any()
    assert (c - ck.square_cost(xp, T, g64))[ok].abs().max().item() <= 1e-13


def test_kernels_refuse_uninstantiated_depth(dev):
    g64, g32, T, T32, _ = _inputs(2, dev)
    g4 = torch.cat([g32, g32]).contiguous()  # k = 4
    x = torch.zeros((T32.shape[0], 30), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        ck.lm_chain(x, T32, g4, 1)


def test_batch_synth_on_the_card(dev):
    """The transpile path's batched synthesis on CUDA: one polish launch per
    k-class, every lane certified from the device solve, and the same step
    count per block as the CPU's plain path (tests/test_torch_transpile.py's
    mixed batch: 24 Haar targets and the degenerate zoo)."""
    zoo = np.stack(
        [
            np.eye(4, dtype=complex),
            np.kron(kak._rz(0.3), kak._rx(1.1)),
            kak.SQISWAP_M,
            kak.can_matrix(0.2, 0.2, 0.0),
            kak.can_matrix(np.pi / 4, 0.1, 0.1),
            kak.can_matrix(0.3, 0.15, 0.15),
            kak.can_matrix(np.pi / 4, np.pi / 4, np.pi / 4),
            kak.can_matrix(np.pi / 4, np.pi / 8, np.pi / 8),
        ]
    )
    U = np.concatenate([haar_sample(24, seed=11), zoo])
    stats = {}
    before = ck.polish_chain.launches
    res = sqiswap_decompose_batch(U, stats=stats, device=dev)
    assert ck.polish_chain.launches == before + 2
    assert stats["fallback"] == 0, stats
    assert stats["device"] == int((sqiswap_count_batch(U, device=dev) >= 2).sum())
    cpu = sqiswap_decompose_batch(U, device="cpu")
    assert [n for _, n in res] == [n for _, n in cpu]
    for (steps, _), u in zip(res, U):
        V = kak.steps_to_matrix(steps)
        assert 1.0 - abs(np.trace(V.conj().T @ u)) / 4.0 <= 1e-10
