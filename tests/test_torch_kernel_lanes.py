"""The CUDA kernels' lane arithmetic, compiled for the host, against the
plain PyTorch versions.

The kernels' per-lane team programs (csrc/adam_team.cuh, csrc/lm_team.cuh,
their depth-K instances, and csrc/adam_generic.cuh, csrc/lm_generic.cuh, the
depth-generic programs in which K is a runtime argument) compile as host
code too; csrc/host_lanes.cpp runs them with a host C++ compiler. This
checks the hand-derived gradient and Jacobian (including the phase-factor
derivative), the LM / CG schedule and the polish's f64 residual on the CPU.
The teams run block by block as the kernels cut the lanes; L = 37 leaves
the last block partly filled (for the generic programs at every lanes-a-
block their rule picks at the depths below). The launch glue and the device
build are covered on the card (test_torch_kernels.py, chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops._build import CSRC
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.tools.inputs import adam_ulp_spread

KS = list(range(1, 13))  # every depth the kernels are instantiated for
LANES = [48, 37]  # 37: a partial last block (32 Adam lanes, 4 LM / polish lanes a block)
# depths of the depth-generic programs held to the plain versions: the first
# (13), the sixteenth-iSwap's busiest (16) and deepest (24), and the last
# (48: n = 294, 8 Adam / 3 LM / 2 polish lanes a block)
GENERIC_KS = [13, 16, 24, 48]
# the block shapes also at 64 and the last depth (kMaxK = 79): their lanes
# against the plain versions take ~70 s here and are held on the card
# (tests/test_torch_kernels.py, marked cuda; chip_smoke.py at 79)
SHAPE_KS = [*GENERIC_KS, 64, ck.KERNEL_KS[-1]]
GENERIC_L = 37
ADAM_ATOL = 5e-5  # f32 association order only; 25 steps (the JAX kernel test's bound)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: the plain
    versions here run many small ops, where extra threads only add
    synchronisation (and contend with the other test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        getattr(lib, name).argtypes = [P, P, P, I, I, I, P, P]
    for name in ("adam_host", "lm_host", "polish_host", "adam_host_generic", "lm_host_generic", "polish_host_generic"):
        getattr(lib, name).restype = None
    lib.generic_shape.argtypes = [I, I, ctypes.POINTER(I), ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.generic_shape.restype = None
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


def _lm(lib, x, T32, g32, iters, k, generic=False):
    xl, f = torch.empty_like(x), torch.empty(x.shape[0], dtype=torch.float32)
    (lib.lm_host_generic if generic else lib.lm_host)(_p(x), _p(T32), _p(g32), iters, k, x.shape[0], _p(xl), _p(f))
    return xl, f


def _polish(lib, x64, T, g64, iters, k, generic=False):
    xp = torch.empty_like(x64)
    f = torch.empty(x64.shape[0], dtype=torch.float64)
    (lib.polish_host_generic if generic else lib.polish_host)(_p(x64), _p(T), _p(g64), iters, k, x64.shape[0],
                                                               _p(xp), _p(f))
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
    lanes.lm_host(_p(xa), _p(T32), _p(g32), 8, k, L, _p(xl), _p(f))
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
    lanes.lm_host(_p(xa), _p(T32), _p(g32), 2, k, L, _p(xl), _p(f32))
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


@pytest.mark.parametrize("k", SHAPE_KS)
def test_generic_shape_fits_a_block(lanes, k):
    """The lanes a block of each generic program at depth k: gate lists and
    workspaces within the 227 KB a block may use, at most the instances'
    lanes a block (32 Adam, 4 LM / polish), Adam in whole warps of 8 teams,
    and one more unit would not fit."""
    cap, kb = (32, 4, 4), 227 * 1024
    for kernel, unit in ((0, 8), (1, 1), (2, 1)):
        la, lb, gb = ctypes.c_int(), ctypes.c_long(), ctypes.c_long()
        lanes.generic_shape(kernel, k, ctypes.byref(la), ctypes.byref(lb), ctypes.byref(gb))
        n, ws, gates_b = la.value, lb.value, gb.value
        assert n % unit == 0 and unit <= n <= cap[kernel] and ws % 16 == 0 and gates_b % 16 == 0
        assert gates_b + n * ws <= kb
        assert n == cap[kernel] or gates_b + (n + unit) * ws > kb
    if k == 48:  # n = 294: 8 Adam, 3 LM and 2 polish lanes a block
        got = []
        for kernel in range(3):
            la, lb, gb = ctypes.c_int(), ctypes.c_long(), ctypes.c_long()
            lanes.generic_shape(kernel, k, ctypes.byref(la), ctypes.byref(lb), ctypes.byref(gb))
            got.append(la.value)
        assert got == [8, 3, 2]


def test_kernel_depths_end_where_a_block_stops_fitting(lanes):
    """The kernels cover depths 1..kMaxK (79): there one unit of each generic
    program (a warp of 8 Adam lanes, one LM or polish lane) fits beside its
    gate lists in 227 KB; at kMaxK + 1 the polish's does not."""
    kmax, kb = ck.KERNEL_KS[-1], 227 * 1024

    def block(kernel, k):
        la, lb, gb = ctypes.c_int(), ctypes.c_long(), ctypes.c_long()
        lanes.generic_shape(kernel, k, ctypes.byref(la), ctypes.byref(lb), ctypes.byref(gb))
        return gb.value + la.value * lb.value

    assert ck.KERNEL_KS == tuple(range(1, kmax + 1)) and kmax == 79
    assert all(block(kernel, kmax) <= kb for kernel in range(3))
    assert block(2, kmax + 1) > kb


@pytest.mark.parametrize("k", GENERIC_KS)
def test_generic_adam_lane_matches_plain(lanes, k):
    _, g32, _, T32, x0 = _inputs(k, 3, GENERIC_L)
    sched = ck.adam_schedule(100)[:25].contiguous()
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


@pytest.mark.parametrize("k", GENERIC_KS)
def test_generic_lm_lane_matches_plain(generic_runs, k):
    _, g32, _, T32, xa, _, f = generic_runs(k)
    _, f_ref = ck.lm_chain_ref(xa, T32, g32, 8)
    # accept/reject at the f32 floor may differ: rtol 1e-3 / atol 1e-5 on
    # >= 99% of lanes (all of them here)
    assert np.isclose(f.numpy(), f_ref.numpy(), rtol=1e-3, atol=1e-5).mean() >= 0.99


@pytest.mark.parametrize("k", GENERIC_KS)
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
