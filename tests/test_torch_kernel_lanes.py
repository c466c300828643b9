"""The CUDA kernels' lane arithmetic, compiled for the host, against the
plain PyTorch versions.

The kernels' per-lane team programs (csrc/adam_team.cuh, csrc/lm_team.cuh)
compile as host code too; csrc/host_lanes.cpp runs them with a host C++
compiler. This checks the hand-derived gradient and Jacobian (including the
phase-factor derivative), the LM / CG schedule and the polish's f64
residual on the CPU. The teams run block by block as the kernels cut the
lanes; L = 37 leaves the last block partly filled. The launch glue and the device build are
covered on the card (test_torch_kernels.py, chip_smoke.py)."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops._build import CSRC
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample

LANES = [48, 37]  # 37: a partial last block (32 Adam lanes, 4 LM / polish lanes a block)


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
    lib.adam_host.argtypes = [P, P, P, P, I, I, I, P, P]
    lib.lm_host.argtypes = [P, P, P, I, I, I, P, P]
    lib.polish_host.argtypes = [P, P, P, I, I, I, P, P]
    for f in (lib.adam_host, lib.lm_host, lib.polish_host):
        f.restype = None
    return lib


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _inputs(k, seed, L):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    g64 = torch.as_tensor(a.chain_gates)
    T = torch.as_tensor(haar_sample(L, seed=seed))
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * np.pi, (L, a.n_params)), dtype=torch.float32)
    return g64, g64.to(torch.complex64), T, T.to(torch.complex64).contiguous(), x0


def _adam(lib, x0, T32, g32, sched, k, with_cost=False):
    out = torch.empty_like(x0)
    cost = torch.empty(x0.shape[0], dtype=torch.float32) if with_cost else None
    lib.adam_host(_p(x0), _p(T32), _p(g32), _p(sched), sched.shape[0], k, x0.shape[0], _p(out),
                  _p(cost) if with_cost else None)
    return (out, cost) if with_cost else out


def _polish(lib, x64, T, g64, iters, k):
    xp = torch.empty_like(x64)
    f = torch.empty(x64.shape[0], dtype=torch.float64)
    lib.polish_host(_p(x64), _p(T), _p(g64), iters, k, x64.shape[0], _p(xp), _p(f))
    return xp, f


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
def test_adam_lane_matches_plain(lanes, k, L):
    _, g32, _, T32, x0 = _inputs(k, 3, L)
    sched = ck.adam_schedule(100)[:25].contiguous()
    got = _adam(lanes, x0, T32, g32, sched, k)
    # f32 association order only; 25 steps (the JAX kernel test's bound)
    np.testing.assert_allclose(got.numpy(), ck.adam_chain_ref(x0, T32, g32, sched).numpy(), atol=5e-5)


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("k", [2, 3])
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
@pytest.mark.parametrize("k", [2, 3])
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
@pytest.mark.parametrize("k", [2, 3])
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


@pytest.mark.parametrize("k", [2, 3])
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


@pytest.mark.parametrize("k", [2, 3])
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
