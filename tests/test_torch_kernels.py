"""The CUDA chain kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device (decided inside the
test, so every pytest worker collects the same tests). Run on the GPU with
``python -m pytest tests/test_torch_kernels.py -m cuda``. chip_smoke.py
repeats these checks at the main path's shapes."""

import ctypes
import math

import numpy as np
import pytest
import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
from slam_decomposition_torch.tools.inputs import adam_ulp_spread
from slam_decomposition_torch.transpile import kak
from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch

pytestmark = pytest.mark.cuda
# every depth the kernels are instantiated for, then depths of the
# depth-generic programs (13..79: the first, the sixteenth-iSwap's busiest
# and deepest, 48, 64 and the last; 15, 20 and 21 end and start the LM
# program's slot buckets, csrc/lm_generic.cuh lm_gen_bucket)
KS = [*range(1, 13), 13, 15, 16, 20, 21, 24, 48, 64, 79]
# Adam's also at the edges of the generic Adam's layer buckets
# (csrc/adam_generic.cuh adam_gen_bucket: K <= 15, 31, 47, 63, 79)
ADAM_KS = sorted({*KS, 31, 32, 47, 63})
# 509: a partial last block (32 Adam lanes a block to K = 12, then the
# generic Adam's 2 to 24; 4 LM and polish lanes a block to K = 12, then the
# generic polish's 7 / 2 at K = 20, 21 / 24, 79)
LANES = [512, 509]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


def _inputs(k, dev, seed=0, L=512):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    g64 = torch.as_tensor(a.chain_gates).to(dev)
    rng = np.random.default_rng(seed + 100)  # another stream than x0's
    if k == 1:  # one sqiSwap reaches no Haar target: take targets of its own class
        T = chain_unitary(torch.as_tensor(rng.uniform(0, 2 * math.pi, (L, a.n_params))).to(dev), g64).contiguous()
    else:
        T = torch.as_tensor(haar_sample(L, seed=seed)).to(dev)
    rng = np.random.default_rng(seed)
    x0 = torch.as_tensor(rng.uniform(0, 2 * math.pi, (L, a.n_params)), dtype=torch.float32).to(dev)
    return g64, g64.to(torch.complex64), T, T.to(torch.complex64).contiguous(), x0


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", ADAM_KS)
def test_adam_kernel_matches_plain(dev, k, L):
    _, g32, _, T32, x0 = _inputs(k, dev, L=L)
    # f32 association order only: 25 steps and 5e-5 (the JAX kernel test's
    # bound). On deep chains Adam's normalised step turns rounding of a
    # near-zero gradient component into a full step, the plain version's
    # too: there (the depth-generic programs) 5 steps, a lane's bound the
    # plain result's own shift under a one-ulp move of the start where that
    # is larger (past ~25 steps at n >= 390 that shift no longer bounds
    # rounding: tools/adam_steps.py, PERF.md section 6)
    generic = k > max(ck.INSTANCE_KS)
    sched = ck.adam_schedule(100, device=dev)[:5 if generic else 25].contiguous()
    before = ck.adam_chain.launches
    got = ck.adam_chain(x0, T32, g32, sched)
    assert ck.adam_chain.launches == before + 1
    want = ck.adam_chain_ref(x0, T32, g32, sched)
    d = (got - want).abs().amax(1)
    bound = torch.clamp_min(adam_ulp_spread(x0, T32, g32, sched, want), 5e-5) if generic else 5e-5
    assert (d <= bound).float().mean().item() >= 0.99


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", ADAM_KS)
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
@pytest.mark.parametrize("k", KS)
def test_lm_kernel_matches_plain(dev, k, L):
    _, g32, _, T32, x0 = _inputs(k, dev, seed=1, L=L)
    xa = ck.adam_chain(x0, T32, g32, ck.adam_schedule(100, device=dev))
    before = ck.lm_chain.launches
    _, f = ck.lm_chain(xa, T32, g32, 8)
    assert ck.lm_chain.launches == before + 1
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    assert torch.isclose(f, f_ref, rtol=1e-3, atol=1e-5).float().mean().item() >= 0.99


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", KS)
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


@pytest.mark.parametrize("k", [2, 3, 12, 13])
def test_kernels_at_zero_iterations(dev, k):
    """At a zero count each kernel launches and leaves x bit for bit (the
    polish: its angles reduced mod 4 pi), with ||r||^2 of that x; the mesh's
    local solve (lm_iters=0) and polisher (adam_iters=0, lm32_iters=0) run
    on them (k = 13: the depth-generic programs)."""
    from slam_decomposition_torch.opt.gauss_newton import ChainSolver

    g64, g32, T, T32, x0 = _inputs(k, dev, seed=3, L=509)
    before = ck.launch_counts()
    assert torch.equal(ck.adam_chain(x0, T32, g32, ck.adam_schedule(0, device=dev)), x0)
    xl, fl = ck.lm_chain(x0, T32, g32, 0)
    assert torch.equal(xl, x0)
    _, fl_ref = ck.lm_chain_ref(x0, T32, g32, 0)
    assert torch.allclose(fl, fl_ref, rtol=1e-5, atol=1e-6)
    x64 = x0.double().contiguous() + 4 * math.pi
    xp, fp = ck.polish_chain(x64, T, g64, 0)
    xp_ref, fp_ref = ck.polish_chain_ref(x64, T, g64, 0)
    assert torch.allclose(xp, xp_ref, rtol=0, atol=1e-14)
    assert torch.allclose(fp, fp_ref, rtol=1e-12, atol=1e-14)
    assert ck.launch_counts() == {name: n + 1 for name, n in before.items()}
    # the solvers at zero counts, on the kernels
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    x0s = x0.double().view(-1, 1, a.n_params)[:64].expand(64, 2, a.n_params).contiguous()
    xs, c = ChainSolver(a.chain_gates, device=dev, lm_iters=0).solve(x0s, T[:64])
    assert torch.allclose(c, ck.square_cost(xs, T[:64], g64), rtol=0, atol=1e-13)
    xc, cc = ChainSolver(a.chain_gates, device=dev, adam_iters=0, lm32_iters=0).polish_cert(xs, T[:64], iters=0)
    assert torch.equal(xc, xs) and torch.equal(cc, c)


def test_generic_program_matches_the_k12_instance(dev):
    """At K = 12 the depth-generic programs' C entries (which the wrappers
    take from K = 13) against the depth-12 instances on the same lanes:
    Adam within f32 association, the LM's ||r||^2 within the LM tests'
    bound, the polish's verdicts equal."""
    k, L = 12, 509
    g64, g32, T, T32, x0 = _inputs(k, dev, seed=4, L=L)
    sched = ck.adam_schedule(100, device=dev)
    p, i = ck._p, ctypes.c_int
    xa = ck.adam_chain(x0, T32, g32, sched[:25].contiguous())
    xg = torch.empty_like(x0)
    ck._launch("slam_adam_chain_generic", p(x0), p(T32), p(g32), p(sched), i(25), i(k), i(L), p(xg), None)
    assert ((xg - xa).abs().amax(1) <= 5e-5).float().mean().item() >= 0.99
    xa = ck.adam_chain(x0, T32, g32, sched)
    xl, fl = ck.lm_chain(xa, T32, g32, 8)
    xo, fo = torch.empty_like(xa), torch.empty(L, device=dev)
    ck._launch("slam_lm_chain_generic", p(xa), p(T32), p(g32), i(8), i(k), i(L), p(xo), p(fo), None)
    assert torch.isclose(fo, fl, rtol=1e-3, atol=1e-5).float().mean().item() >= 0.99
    x64 = xl.double().contiguous()
    _, fp = ck.polish_chain(x64, T, g64, 6)
    xo, fo = torch.empty_like(x64), torch.empty(L, device=dev, dtype=torch.float64)
    ck._launch("slam_polish_chain_generic", p(x64), p(T), p(g64), i(6), i(k), i(L), p(xo), p(fo), None)
    assert torch.equal(certificate(fo) <= 1e-10, certificate(fp) <= 1e-10)


def test_kernels_refuse_uninstantiated_depth(dev):
    g64, g32, T, T32, _ = _inputs(2, dev)
    g80 = torch.cat([g32] * 40).contiguous()  # k = 80: 486 parameters, no kernel
    x = torch.zeros((T32.shape[0], 486), dtype=torch.float32, device=dev)
    with pytest.raises(ValueError):
        ck.lm_chain(x, T32, g80, 1)


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


def test_fit_substituted_1q_on_the_kernels(dev):
    """The SLAM pass's 1Q fit on the card: each structure group of winner
    applications is one launch of each chain kernel, and with every block
    fitted the circuit keeps its unitary."""
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.passes import pass_manager_slam

    c = library.qft(5)
    ck.reset_launch_counts()
    stats = []
    out, m = pass_manager_slam(c, duration_1q=0.25, fit_1q=True, device=dev, stats=stats)
    counts = ck.launch_counts()
    assert stats and all(v == len(stats) for v in counts.values()), (counts, stats)
    assert all(s["path"] == "kernels" for s in stats)
    if all(s["fitted"] == s["blocks"] for s in stats):
        U, V = c.to_matrix(), out.to_matrix()
        assert 1 - abs(np.trace(V.conj().T @ U)) / U.shape[0] <= 1e-9


def _pd_zero_inputs(dev, seed, L):
    """The chain of the parallel-drive fallback: three zero-drive
    sqiSwap-time pulses of the iSwap-strength coupler (expm entries near
    1e-17 count as nonzeros in the kernels' gate lists), Haar targets."""
    from slam_decomposition_torch.models import hamiltonians as ham

    zero = np.zeros(4)
    g = gates._const_gate("pd_sq_zero", 2, ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, zero, zero, t=0.5).numpy())
    a = build_ansatz([g] * 3)
    g64 = torch.as_tensor(a.chain_gates).to(dev)
    T = torch.as_tensor(haar_sample(L, seed=seed)).to(dev)
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * math.pi, (L, a.n_params)),
                         dtype=torch.float32).to(dev)
    return g64, g64.to(torch.complex64), T, T.to(torch.complex64).contiguous(), x0


@pytest.mark.parametrize("L", LANES)
def test_kernels_on_the_pd_fallback_chain(dev, L):
    """Adam, the LM and the polish against their plain versions on the
    fallback's K = 3 chain, with the limits of the sqiSwap chain's tests."""
    g64, g32, T, T32, x0 = _pd_zero_inputs(dev, 5, L)
    sched = ck.adam_schedule(100, device=dev)
    d = (ck.adam_chain(x0, T32, g32, sched[:25].contiguous())
         - ck.adam_chain_ref(x0, T32, g32, sched[:25].contiguous())).abs().amax(1)
    assert (d <= 5e-5).float().mean().item() >= 0.99
    xa = ck.adam_chain(x0, T32, g32, sched)
    xl, f = ck.lm_chain(xa, T32, g32, 8)
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    assert torch.isclose(f, f_ref, rtol=1e-3, atol=1e-5).float().mean().item() >= 0.99
    x64 = xl.double().contiguous()
    xp, fp = ck.polish_chain(x64, T, g64, 6)
    _, fp_ref = ck.polish_chain_ref(x64, T, g64, 6)
    c, c_ref = certificate(fp), certificate(fp_ref)
    assert ((c <= 1e-10) == (c_ref <= 1e-10)).float().mean().item() >= 0.99
    ok = c <= 1e-10
    assert ok.any()
    assert (c - ck.square_cost(xp, T, g64))[ok].abs().max().item() <= 1e-13


def test_fit_substituted_pd_fallback_on_the_kernels(dev):
    """cx-swap-cx through the parallel-drive pass on the card: the SWAP
    block lands in the exact 3-segment fallback, one launch of each chain
    kernel, and the circuit keeps its unitary within 1e-9."""
    from slam_decomposition_torch.transpile.ir import Circuit
    from slam_decomposition_torch.transpile.passes import pass_manager_optimized_sqiswap

    c = Circuit(3)
    c.cx(0, 1)
    c.swap(1, 2)
    c.cx(0, 1)
    ck.reset_launch_counts()
    stats = []
    out, _ = pass_manager_optimized_sqiswap(c, duration_1q=0.25, fit_1q=True, device=dev, stats=stats)
    assert ck.launch_counts() == {"adam_chain": 1, "lm_chain": 1, "polish_chain": 1}
    assert [s["stage"] for s in stats][-1] == "fallback" and stats[-1]["path"] == "kernels"
    U, V = c.to_matrix(), out.to_matrix()
    assert 1 - abs(np.trace(V.conj().T @ U)) / U.shape[0] <= 1e-9
