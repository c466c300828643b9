"""The CUDA kernels' lane arithmetic, compiled for the host, against the
plain PyTorch versions.

The kernels' per-lane team programs (csrc/adam_team.cuh, csrc/lm_team.cuh,
their depth-K instances, and csrc/adam_generic.cuh, csrc/lm_generic.cuh, the
depth-generic programs in which K is a runtime argument) compile as host
code too; csrc/host_lanes.cpp runs them with a host C++ compiler. This
checks the hand-derived gradient and Jacobian (including the phase-factor
derivative), the LM / CG schedule and the polish's f64 residual on the CPU.
The teams run block by block as the kernels cut the lanes; L = 37 leaves
the last block partly filled (for the generic programs wherever their rule
picks more than one lane a block at the depths below: Adam's blocks of
one warp, 2 lanes, the polish's 7 at K = 21 and 2 at 24). The launch glue
and the device build are covered on the card (test_torch_kernels.py,
chip_smoke.py)."""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slam_decomposition_torch.coverage.coverage import load_coverage, monodromy_ks_batch, monodromy_ks_of_reps
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.ops._build import CSRC
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.tools.inputs import adam_ulp_spread, fresh_iterations
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

KS = list(range(1, 13))  # every depth the kernels are instantiated for
LANES = [48, 37]  # 37: a partial last block (32 Adam lanes, 4 LM / polish lanes a block)
# depths of the depth-generic programs held to the plain versions: the first
# (13), the sixteenth-iSwap's busiest (16) and deepest (24), and the last
# (48: n = 294)
GENERIC_KS = [13, 16, 24, 48]
# the generic Adam program's layer buckets (csrc/adam_generic.cuh
# adam_gen_bucket: 1..5 layers a thread) start at K = 13 (from 1), 16, 32, 48
# and 64: the Adam test also takes each bucket's last depth and the first of
# the last three (K = 15, 31, 32, 47, 63, 64, 79)
ADAM_GENERIC_KS = sorted([*GENERIC_KS, 15, 31, 32, 47, 63, 64, 79])
ADAM_BUCKETS = {13: 1, 15: 1, 16: 2, 31: 2, 32: 3, 47: 3, 48: 4, 63: 4, 64: 5, 79: 5}
ADAM_CAPS = {1: 40, 2: 32, 3: 32, 4: 24, 5: 24}  # adam_gen_lanes_cap: lanes an SM a bucket's registers hold
# the generic LM program's slot buckets (csrc/lm_generic.cuh lm_gen_bucket:
# 3, 4, 8, 16 slots a thread) start at K = 13 (from 1), 16, 21 and 42: the
# LM and polish tests also take the first bucket's last depth and the third
# bucket's first (K = 15, 21)
LM_GENERIC_KS = sorted([*GENERIC_KS, 15, 21])
# the block shapes also at the second bucket's last depth (20), the
# fourth's first (42), at 64 and at the last depth (kMaxK = 79): their
# lanes against the plain versions take ~70 s here and are held on the
# card (tests/test_torch_kernels.py, marked cuda; chip_smoke.py at 79)
SHAPE_KS = sorted({*LM_GENERIC_KS, *ADAM_GENERIC_KS, 20, 42, 64, ck.KERNEL_KS[-1]})
LM_BUCKETS = {13: 3, 15: 3, 16: 4, 20: 4, 21: 8, 41: 8, 42: 16, 79: 16}
GENERIC_L = 37
ADAM_ATOL = 5e-5  # f32 association order only; 25 steps (the JAX kernel test's bound)


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build csrc/host_lanes.cpp")
    out = tmp_path_factory.mktemp("lanes") / "liblanes.so"
    subprocess.run(
        [cxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", "-shared", "-fPIC",
         "-I", str(CSRC), "-o", str(out), str(CSRC / "host_lanes.cpp")],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I = ctypes.c_void_p, ctypes.c_int
    for name in ("adam_host", "adam_host_generic"):
        getattr(lib, name).argtypes = [P, P, P, P, I, I, I, P, P]
    for name in ("lm_host", "polish_host", "lm_host_generic", "polish_host_generic"):
        getattr(lib, name).argtypes = [P, P, P, I, I, I, P, P, P]  # the last: the count of J builds (may be null)
    for name in ("adam_host", "lm_host", "polish_host", "adam_host_generic", "lm_host_generic", "polish_host_generic"):
        getattr(lib, name).restype = None
    lib.generic_shape.argtypes = [I, I, ctypes.POINTER(I), ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
                                  ctypes.POINTER(I)]
    lib.generic_shape.restype = None
    lib.gamma_eigenphases_host.argtypes = [P, P, I]
    lib.gamma_eigenphases_host.restype = None
    return lib


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _inputs(k, seed, L):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    g64 = torch.as_tensor(a.chain_gates)
    rng = np.random.default_rng(seed + 100)  # another stream than x0's
    if k == 1:  # one sqiSwap reaches no Haar target: take targets of its own class
        T = chain_unitary(torch.as_tensor(rng.uniform(0, 2 * np.pi, (L, a.n_params))), g64).contiguous()
    else:
        T = torch.as_tensor(haar_sample(L, seed=seed))
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * np.pi, (L, a.n_params)), dtype=torch.float32)
    return g64, g64.to(torch.complex64), T, T.to(torch.complex64).contiguous(), x0


def _adam(lib, x0, T32, g32, sched, k, with_cost=False, generic=False):
    out = torch.empty_like(x0)
    cost = torch.empty(x0.shape[0], dtype=torch.float32) if with_cost else None
    fn = lib.adam_host_generic if generic else lib.adam_host
    fn(_p(x0), _p(T32), _p(g32), _p(sched), sched.shape[0], k, x0.shape[0], _p(out), _p(cost) if with_cost else None)
    return (out, cost) if with_cost else out


def _lm(lib, x, T32, g32, iters, k, generic=False, rebuilds=None):
    xl, f = torch.empty_like(x), torch.empty(x.shape[0], dtype=torch.float32)
    (lib.lm_host_generic if generic else lib.lm_host)(_p(x), _p(T32), _p(g32), iters, k, x.shape[0], _p(xl), _p(f),
                                                       None if rebuilds is None else _p(rebuilds))
    return xl, f


def _polish(lib, x64, T, g64, iters, k, generic=False, rebuilds=None):
    xp = torch.empty_like(x64)
    f = torch.empty(x64.shape[0], dtype=torch.float64)
    (lib.polish_host_generic if generic else lib.polish_host)(_p(x64), _p(T), _p(g64), iters, k, x64.shape[0],
                                                               _p(xp), _p(f), None if rebuilds is None else _p(rebuilds))
    return xp, f


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", KS)
def test_adam_lane_matches_plain(lanes, k, L):
    _, g32, _, T32, x0 = _inputs(k, 3, L)
    sched = ck.adam_schedule(100)[:25].contiguous()
    got = _adam(lanes, x0, T32, g32, sched, k)
    # f32 association order only; 25 steps (the JAX kernel test's bound)
    np.testing.assert_allclose(got.numpy(), ck.adam_chain_ref(x0, T32, g32, sched).numpy(), atol=5e-5)


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", KS)
def test_lm_lane_matches_plain(lanes, k, L):
    _, g32, _, T32, x0 = _inputs(k, 5, L)
    xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k)
    xl = torch.empty_like(xa)
    f = torch.empty(L, dtype=torch.float32)
    lanes.lm_host(_p(xa), _p(T32), _p(g32), 8, k, L, _p(xl), _p(f), None)
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    # accept/reject at the f32 floor may differ: rtol 1e-3 / atol 1e-5 on
    # >= 99% of lanes (all of them here)
    assert np.isclose(f.numpy(), f_ref.numpy(), rtol=1e-3, atol=1e-5).mean() >= 0.99


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", KS)
def test_polish_lane_matches_plain(lanes, k, L):
    g64, g32, T, T32, x0 = _inputs(k, 7, L)
    xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k)
    xl, _ = ck.lm_chain_ref(xa, T32, g32, 8)
    x64 = xl.double().contiguous()
    xp, f = _polish(lanes, x64, T, g64, 6, k)
    _, f_ref = ck.polish_chain_ref(x64, T, g64, 6)
    c, c_ref = certificate(f), certificate(f_ref)
    assert ((c <= 1e-10) == (c_ref <= 1e-10)).all() and (c <= 1e-10).any()
    # the f64 certificate is the true f64 cost of the returned x
    ok = c <= 1e-10
    np.testing.assert_allclose(c[ok].numpy(), ck.square_cost(xp, T, g64)[ok].numpy(), atol=1e-13)


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", KS)
def test_adam_lane_cost_is_the_square_cost_of_its_x(lanes, k, L):
    _, g32, _, T32, x0 = _inputs(k, 11, L)
    sched = ck.adam_schedule(100)[:25].contiguous()
    x, cost = _adam(lanes, x0, T32, g32, sched, k, with_cost=True)
    # the instance with the cost takes the same steps as the one without
    assert torch.equal(x, _adam(lanes, x0, T32, g32, sched, k))
    # one f32 chain and trace against the plain f32 ones
    np.testing.assert_allclose(cost.numpy(), ck.square_cost(x, T32, g32).numpy(), atol=2e-6)
    _, cost_ref = ck.adam_chain_ref(x0, T32, g32, sched, with_cost=True)
    np.testing.assert_allclose(cost.numpy(), cost_ref.numpy(), atol=1e-4)


@pytest.mark.parametrize("k", KS)
def test_polish_team_is_the_lm_team_with_a_double_residual(lanes, k):
    """One program serves both kernels: from the same f32-representable x
    and target, two iterations of the polish (residual in f64) and of the
    ranking pass (residual in f32) take the same steps, so their ||r||^2
    agree to f32 accuracy."""
    L = 48
    _, g32, _, T32, x0 = _inputs(k, 13, L)
    xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k)
    xl, f32 = torch.empty_like(xa), torch.empty(L, dtype=torch.float32)
    lanes.lm_host(_p(xa), _p(T32), _p(g32), 2, k, L, _p(xl), _p(f32), None)
    _, f64 = _polish(lanes, xa.double(), T32.to(torch.complex128), g32.to(torch.complex128), 2, k)
    assert np.isclose(f32.numpy(), f64.numpy(), rtol=1e-3, atol=1e-5).mean() >= 0.99


@pytest.mark.parametrize("k", KS)
def test_polish_lane_residual_is_f64(lanes, k):
    """At a polished x (||r||^2 ~ 1e-25) a target moved by 1e-9 raises
    ||r||^2 to ~1e-17: the f64 residual sees it and agrees with the plain
    f64 one; a residual in f32 (floor ~1e-13) could not."""
    L = 37
    g64, g32, T, T32, x0 = _inputs(k, 7, L)
    xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k)
    xl, _ = ck.lm_chain_ref(xa, T32, g32, 8)
    xp, f = _polish(lanes, xl.double().contiguous(), T, g64, 6, k)
    ok = f < 1e-20
    assert ok.any()
    rng = np.random.default_rng(k)
    T2 = (T + 1e-9 * torch.as_tensor(rng.normal(size=(L, 4, 4)) + 1j * rng.normal(size=(L, 4, 4)))).contiguous()
    _, f2 = _polish(lanes, xp, T2, g64, 0, k)  # no iteration: ||r||^2 at xp
    r2 = ck.phase_residual(ck.reduce_angles(xp), T2, g64)
    np.testing.assert_allclose(f2[ok].numpy(), (r2 * r2).sum(-1)[ok].numpy(), rtol=1e-6)
    assert (f2[ok] > 100 * f[ok]).all() and (f2[ok] < 1e-15).all()


@pytest.mark.parametrize("k", [2, 3, 13])
def test_lane_rebuild_counts_follow_the_accepted_steps(lanes, k):
    """The LM and polish programs count their J builds (the counter the
    kernels take): 1 + the accepted steps before the last iteration, summed
    over the lanes, read from runs at 0..iters-1 iterations
    (tools/inputs.fresh_iterations' method); K = 13 is the generic program."""
    generic, L = k > 12, 9  # 9: a partial last block
    g64, g32, T, T32, x0 = _inputs(k, 17, L)
    for run, x, t, g, iters in ((_lm, x0, T32, g32, 8), (_polish, x0.double(), T, g64, 6)):
        acc = torch.zeros(1, dtype=torch.int64)
        counted = run(lanes, x, t, g, iters, k, generic, acc)
        fresh = fresh_iterations(lambda *a: run(lanes, *a, k, generic), x, t, g, iters)
        assert acc.item() == round(fresh * L) and acc.item() >= L
        assert all(torch.equal(a, b) for a, b in zip(counted, run(lanes, x, t, g, iters, k, generic)))


# ---------------------------------------------------------------- depth-generic programs


@pytest.fixture(scope="module")
def generic_runs(lanes):
    """Per depth, the host build's generic Adam (100 steps) and f32 LM (8
    iterations) on GENERIC_L lanes, shared by the LM and polish tests."""
    runs = {}

    def get(k):
        if k not in runs:
            g64, g32, T, T32, x0 = _inputs(k, 5, GENERIC_L)
            xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k, generic=True)
            runs[k] = (g64, g32, T, T32, xa, *_lm(lanes, xa, T32, g32, 8, k, generic=True))
        return runs[k]

    return get


def _shape(lib, kernel, k):
    """(lanes a block, lane workspace bytes, gate list bytes in the block,
    register cap on lanes an SM) of a generic program at depth k."""
    la, lb, gb, cap = ctypes.c_int(), ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    lib.generic_shape(kernel, k, ctypes.byref(la), ctypes.byref(lb), ctypes.byref(gb), ctypes.byref(cap))
    return la.value, lb.value, gb.value, cap.value


SM_BYTES, RESERVED, BLOCK_MAX = 228 * 1024, 1024, 227 * 1024


def _lanes_an_sm(n, ws, cap):
    """Lanes an SM of blocks of n lanes of ws bytes, registers holding cap."""
    return n * min(SM_BYTES // (n * ws + RESERVED), cap // n)


@pytest.mark.parametrize("k", SHAPE_KS)
def test_generic_shape_fits_a_block(lanes, k):
    """The lanes a block of each generic program at depth k. None holds gate
    lists in the block (Adam reads the gates, the LM and the polish their
    lists, from device memory). Each takes the fewest lanes a block that put
    the most lanes on an SM (228 KB, 1 KB reserved a block, 227 KB at most a
    block) within its slot bucket's register cap: it is the smallest
    maximiser over every block that fits, in whole warps (Adam's team is
    half a warp: 2 lanes; an LM or polish lane is a warp)."""
    kb = BLOCK_MAX
    for kernel, unit in ((0, 2), (1, 1), (2, 1)):
        n, ws, gates_b, cap = _shape(lanes, kernel, k)
        assert gates_b == 0 and ws % 16 == 0 and unit <= n <= cap and n % unit == 0 and n * ws <= kb
        sizes = [m for m in range(unit, cap + 1, unit) if m * ws <= kb]
        best = max(_lanes_an_sm(m, ws, cap) for m in sizes)
        assert _lanes_an_sm(n, ws, cap) == best
        assert all(_lanes_an_sm(m, ws, cap) < best for m in sizes if m < n)
    if k in ADAM_BUCKETS:  # the bucket's cap
        assert _shape(lanes, 0, k)[3] == ADAM_CAPS[ADAM_BUCKETS[k]]
    if k in LM_BUCKETS:  # the bucket's cap: 8 lanes an SM for 3, 4, 8 slots, 4 for 16
        assert all(_shape(lanes, kernel, k)[3] == {3: 8, 4: 8, 8: 8, 16: 4}[LM_BUCKETS[k]] for kernel in (1, 2))
    if k == 48:  # n = 294: Adam one block of 24 lanes an SM (its cap; one-warp blocks would hold 22); the LM and
        # polish 1 lane a block (3 lanes an SM)
        assert [_shape(lanes, kernel, k)[0] for kernel in range(3)] == [24, 1, 1]
        assert _lanes_an_sm(*_shape(lanes, 0, k)[:2], _shape(lanes, 0, k)[3]) == 24
    if k == 13:  # Adam 40 lanes an SM in one-warp blocks (its registers' cap, below the 66 shared memory holds);
        # the LM and polish one-lane blocks, 8 an SM (their registers' cap, below the 12 / 10 of shared memory)
        assert [_shape(lanes, kernel, k)[0] for kernel in range(3)] == [2, 1, 1]
        assert [_lanes_an_sm(*_shape(lanes, kernel, k)[:2], _shape(lanes, kernel, k)[3]) for kernel in range(3)] == [40, 8, 8]
    if k == 21:  # the polish's 7 lanes (32.2 KB each) fit an SM only as one block
        assert _shape(lanes, 2, k)[0] == 7
    if k == 79:  # Adam 14 lanes an SM (by shared memory); the polish's two lanes (113.4 KB each) fit only as one block
        assert _lanes_an_sm(*_shape(lanes, 0, k)[:2], _shape(lanes, 0, k)[3]) == 14
        assert _shape(lanes, 2, k)[0] == 2


def test_kernel_depths_end_where_a_block_stops_fitting(lanes):
    """The kernels cover depths 1..kMaxK (79), where the polish's one-lane
    block stopped fitting beside its gate lists. Those lists are in device
    memory now, and Adam reads its gates from there, so kMaxK stays 79 by
    choice (csrc/chain_common.cuh): at 79 one unit of each generic program
    fits in 227 KB (a warp of 2 Adam lanes, one LM or polish lane); Adam's
    unit would still fit at 602 and not at 603, the LM's and the polish's
    lanes to their last slot bucket's K = 84."""
    kmax, kb = ck.KERNEL_KS[-1], BLOCK_MAX

    def unit(kernel, k):  # one warp of Adam lanes or one LM / polish lane
        _, ws, gates_b, _ = _shape(lanes, kernel, k)
        return gates_b + (2 if kernel == 0 else 1) * ws

    assert ck.KERNEL_KS == tuple(range(1, kmax + 1)) and kmax == 79
    assert all(unit(kernel, kmax) <= kb for kernel in range(3))
    assert unit(0, 602) <= kb < unit(0, 603)
    assert unit(1, 84) <= kb and unit(2, 84) <= kb


@pytest.mark.parametrize("k", ADAM_GENERIC_KS)
def test_generic_adam_lane_matches_plain(lanes, k):
    _, g32, _, T32, x0 = _inputs(k, 3, GENERIC_L)
    # 25 steps; from n = 390 (K = 64) 5, as chip_smoke.py holds the generic
    # programs: past ~25 steps there the one-ulp spread no longer bounds what
    # rounding does (tools/adam_steps.py, PERF.md section 6; at K = 79 five
    # of these 37 lanes leave it after 25 steps in this program and in the
    # one it replaced alike)
    sched = ck.adam_schedule(100)[:25 if 6 * (k + 1) < 390 else 5].contiguous()
    got = _adam(lanes, x0, T32, g32, sched, k, generic=True)
    d = (got - ck.adam_chain_ref(x0, T32, g32, sched)).abs().amax(1)
    # f32 association order only: within ADAM_ATOL, or on a lane whose plain
    # result a one-ulp move of its start shifts further (from K ~ 30 Adam
    # amplifies f32 rounding past the bound on some lanes, in the plain
    # version as much as here), within that shift
    assert (d <= torch.clamp_min(adam_ulp_spread(x0, T32, g32, sched), ADAM_ATOL)).all(), d
    if k == 13:  # the program with the final cost: the same steps, then the f32 cost of its x
        x, cost = _adam(lanes, x0, T32, g32, sched, k, with_cost=True, generic=True)
        assert torch.equal(x, got)
        np.testing.assert_allclose(cost.numpy(), ck.square_cost(x, T32, g32).numpy(), atol=2e-6)


@pytest.mark.parametrize("k", LM_GENERIC_KS)
def test_generic_lm_lane_matches_plain(generic_runs, k):
    _, g32, _, T32, xa, _, f = generic_runs(k)
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    # accept/reject at the f32 floor may differ: rtol 1e-3 / atol 1e-5 on
    # >= 99% of lanes (all of them here)
    assert np.isclose(f.numpy(), f_ref.numpy(), rtol=1e-3, atol=1e-5).mean() >= 0.99


@pytest.mark.parametrize("k", LM_GENERIC_KS)
def test_generic_polish_lane_matches_plain(lanes, generic_runs, k):
    g64, _, T, _, _, xl, _ = generic_runs(k)
    x64 = xl.double().contiguous()
    xp, f = _polish(lanes, x64, T, g64, 6, k, generic=True)
    _, f_ref = ck.polish_chain_ref(x64, T, g64, 6)
    c, c_ref = certificate(f), certificate(f_ref)
    assert ((c <= 1e-10) == (c_ref <= 1e-10)).all() and (c <= 1e-10).any()
    ok = c <= 1e-10
    np.testing.assert_allclose(c[ok].numpy(), ck.square_cost(xp, T, g64)[ok].numpy(), atol=1e-13)


def _accepted(run, iters):
    """(L, iters) bool: which of the first iters LM iterations each lane
    accepted, from runs of 0..iters iterations (each runs the same first
    ones): step i was accepted iff ||r||^2 fell."""
    f = torch.stack([run(i)[1].double() for i in range(iters + 1)], dim=1)
    return f[:, 1:] < f[:, :-1]


def test_generic_program_matches_the_k12_instance(lanes):
    """At K = 12, where both exist, the depth-generic programs against the
    depth-12 instances on the same lanes: Adam's x within f32 association,
    and the LM and the polish accepting and rejecting the same steps on
    every lane, with ||r||^2 within f32 rounding."""
    k = 12
    g64, g32, T, T32, x0 = _inputs(k, 17, GENERIC_L)
    sched = ck.adam_schedule(100)[:25].contiguous()
    np.testing.assert_allclose(_adam(lanes, x0, T32, g32, sched, k, generic=True).numpy(),
                               _adam(lanes, x0, T32, g32, sched, k).numpy(), atol=ADAM_ATOL)
    xa = _adam(lanes, x0, T32, g32, ck.adam_schedule(100), k)
    acc = [_accepted(lambda i, g=g: _lm(lanes, xa, T32, g32, i, k, generic=g), 8) for g in (True, False)]
    assert torch.equal(*acc) and acc[0].any()
    fl = [_lm(lanes, xa, T32, g32, 8, k, generic=g)[1] for g in (True, False)]
    np.testing.assert_allclose(fl[0].numpy(), fl[1].numpy(), rtol=1e-3, atol=1e-5)
    x64 = _lm(lanes, xa, T32, g32, 8, k)[0].double().contiguous()
    acc = [_accepted(lambda i, g=g: _polish(lanes, x64, T, g64, i, k, generic=g), 6) for g in (True, False)]
    assert torch.equal(*acc)
    fp = [_polish(lanes, x64, T, g64, 6, k, generic=g)[1] for g in (True, False)]
    assert torch.equal(certificate(fp[0]) <= 1e-10, certificate(fp[1]) <= 1e-10)
    np.testing.assert_allclose(fp[0].numpy(), fp[1].numpy(), rtol=1e-6, atol=1e-28)


# ---------------------------------------------------------------- magic-basis eigenphases


def _local(n, seed):
    """n random local gates a (x) b, a and b in SU(2)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((2, n, 2, 2)) + 1j * rng.standard_normal((2, n, 2, 2))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=-2, axis2=-1)
    q = q * (d / np.abs(d))[..., None, :]
    q = q / np.sqrt(np.linalg.det(q))[..., None, None]
    return np.einsum("nij,nkl->nikjl", q[0], q[1]).reshape(n, 4, 4)


def _dressed(G, seed, n=64):
    return _local(n, seed) @ G @ _local(n, seed + 1)


# Haar targets, and gates whose spectra of m are degenerate (the identity,
# CNOT, SWAP, iSwap, B, sqrt(iSwap), the sixteenth-iSwap gate) or whose
# det lies on the SU(4) branch cut to rounding (CNOT and SWAP, dressed CNOT)
GAMMA_TARGETS = {
    "haar": lambda: haar_sample(4096, seed=29),
    "identity": lambda: np.eye(4),
    "cnot": lambda: gates.CNOT.to_numpy(),
    "iswap": lambda: gates.ISWAP.to_numpy(),
    "swap": lambda: gates.SWAP.to_numpy(),
    "b": lambda: gates.berkeley().to_numpy(),
    "sqiswap": lambda: gates.SQISWAP.to_numpy(),
    "sixteenth_iswap": lambda: gates.conversion_gain_gate(0, 0, 0, math.pi / 32, 1).to_numpy(),
    "local_identity": lambda: _dressed(np.eye(4), 31),
    "local_cnot": lambda: _dressed(gates.CNOT.to_numpy(), 33),
}
# the benchmark configurations' coverage gates (benchmark/configs/*.json)
COVERAGE_GATES = {
    "sqiswap": lambda: gates.cg_sqiswap(),
    "sixteenth_iswap": lambda: gates.conversion_gain_gate(0, 0, 0, math.pi / 32, 1),
}


def _gamma_targets(name):
    return torch.as_tensor(np.asarray(GAMMA_TARGETS[name](), dtype=complex).reshape(-1, 4, 4))


def _lane_phases(lib, U):
    out = torch.empty(U.shape[0], 4, dtype=torch.float64)
    lib.gamma_eigenphases_host(_p(U.contiguous()), _p(out), U.shape[0])
    return out


def _wrap(d):
    """d mod 2 pi into [-pi, pi)."""
    return torch.remainder(d + math.pi, 2 * math.pi) - math.pi


@pytest.mark.parametrize("name", sorted(GAMMA_TARGETS))
def test_gamma_eigenphases_lane_matches_plain(lanes, name):
    """The kernel's body against the plain chain: each phase mod 2 pi within
    1e-12. Where det U lies on the negative real axis to rounding, the
    principal branch of det^(-1/4) is decided by the sign of a rounding-level
    imaginary part, which other sums' orders may flip: the other branch
    multiplies U_s by i and m by -1, every phase moves by pi and the two
    monodromy representatives trade places. Only there are all four phases
    allowed to differ by pi together."""
    U = _gamma_targets(name)
    got, want = _lane_phases(lanes, U), weyl.gamma_eigenphases(U)
    err = _wrap(got - want).abs().amax(-1)
    det = weyl.det4(U)
    cut = (det.real < 0) & (det.imag.abs() <= 1e-12)
    err = torch.where(cut, torch.minimum(err, _wrap(got - want + math.pi).abs().amax(-1)), err)
    assert err.max().item() <= 1e-12


@pytest.mark.parametrize("config", sorted(COVERAGE_GATES))
def test_gamma_lane_phases_give_the_plain_ks(lanes, config):
    """Every target of the cases above gets, from the body's phases, the k
    that monodromy_ks_batch gives with the plain chain, exactly."""
    cov = load_coverage(COVERAGE_GATES[config]())
    U = torch.cat([_gamma_targets(name) for name in sorted(GAMMA_TARGETS)])
    reps = weyl._phases_to_reps(_lane_phases(lanes, U))
    np.testing.assert_array_equal(monodromy_ks_of_reps(cov, reps.numpy(), device="cpu"),
                                  monodromy_ks_batch(cov, U, device="cpu"))
