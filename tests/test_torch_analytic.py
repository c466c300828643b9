"""Parity of the port's batched analytic synthesis with the JAX package on
the same numpy inputs: Weyl coordinates (ops/weyl.c1c2c3), sqiSwap counts
(opt/samplers.sqiswap_count_batch), the analytic init (ops/kak_batch) and
the analytic solver (opt/gauss_newton.make_analytic_solver).

JAX stays on the CPU in f64 (tests/conftest.py); data crosses as numpy. The
JAX k=3 f64 init takes minutes to compile on the CPU, so the port's k=3
init is held against the JAX host routine and tests/test_kak_batch.py's
bounds instead."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import weyl as jweyl
from slam_decomposition_tpu.ops.kak_batch import make_analytic_init as jax_analytic_init
from slam_decomposition_tpu.opt import samplers as jsamplers
from slam_decomposition_tpu.transpile import kak as jkak
from slam_decomposition_tpu.transpile import library as jlibrary
from slam_decomposition_tpu.transpile.consolidate import consolidate_2q_blocks as jconsolidate

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import weyl as tweyl
from slam_decomposition_torch.ops.kak_batch import make_analytic_init
from slam_decomposition_torch.opt.gauss_newton import make_analytic_solver
from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

# the degenerate classes of tests/test_kak_batch.py:63-91
ZOO2 = np.stack(
    [
        np.eye(4, dtype=complex),  # identity class
        jkak.SQISWAP_M,  # the basis gate itself
        np.kron(jkak._rz(0.3), jkak._rx(1.1)),  # pure local
        jkak.can_matrix(0.2, 0.2, 0.0),  # z = 0 boundary branch
        jkak.can_matrix(np.pi / 4, 0.1, 0.1),  # x = pi/4 wall
        jkak.can_matrix(0.3, 0.15, 0.15),  # |z| = x - y double root
        jkak.can_matrix(0.3, 0.15, -0.15),  # negative-z mirror
        jkak.can_matrix(np.pi / 4, np.pi / 4, 0.0),  # iSwap class corner
    ]
)
ZOO3 = np.stack(
    [
        jkak.can_matrix(np.pi / 4, np.pi / 4, np.pi / 4),  # SWAP class
        jkak.can_matrix(0.5, 0.4, 0.3),
        jkak.can_matrix(np.pi / 4, np.pi / 8, np.pi / 8),  # B-gate class
    ]
)


def _trace_infidelity(V, U):
    """1 - |tr(V^dag U)| / 4 per lane."""
    return 1.0 - np.abs(np.einsum("bij,bij->b", V.conj(), U)) / 4.0


def _chain(x, k):
    g = torch.as_tensor(build_ansatz(cycle_gates([gates.SQISWAP], k)).chain_gates)
    return chain_unitary(torch.as_tensor(x), g).numpy()


def test_c1c2c3_matches_jax():
    U = np.concatenate([haar_sample(2048, seed=7), ZOO2, ZOO3])
    want = np.asarray(jax.jit(jweyl.c1c2c3)(jcplx.from_numpy(U)))
    got = tweyl.c1c2c3(torch.as_tensor(U)).numpy()
    # the same f64 joint Jacobi in another operation order: ~1e-15 apart
    np.testing.assert_allclose(got, want, atol=1e-10)


@pytest.mark.parametrize("batch", ["haar", "zoo", "qft16"])
def test_sqiswap_count_batch_matches_jax(batch):
    U = {
        "haar": lambda: haar_sample(2048, seed=7),
        "zoo": lambda: np.concatenate([ZOO2, ZOO3]),
        # exact gates on the region boundaries and the identity class
        "qft16": lambda: np.stack([b.unitary for b in jconsolidate(jlibrary.qft(16))]),
    }[batch]()
    got = sqiswap_count_batch(U, device="cpu")
    assert np.array_equal(got, jsamplers.sqiswap_count_batch(U))
    assert sqiswap_count_batch(U[0], device="cpu") == got[0]


def test_analytic_init_k2_matches_jax():
    H = haar_sample(64, seed=3)
    idx = np.where(jsamplers.sqiswap_count_batch(H) == 2)[0]
    assert len(idx) == 50
    U = np.concatenate([H[idx], ZOO2])
    x = make_analytic_init(2, device="cpu")(U).numpy()
    x_jax = np.array(jax_analytic_init(2, dtype=jnp.float64)(jnp.asarray(U.real), jnp.asarray(U.imag)))
    assert x.shape == x_jax.shape == (len(U), 18)
    V, V_jax = _chain(x, 2), _chain(x_jax, 2)
    # before any polish: f64 synthesis to rounding (the port reads <= 4.4e-16
    # here, as the JAX f64 init does)
    assert _trace_infidelity(V, U).max() <= 1e-12
    # both inits give the target up to phase, hence the same chain unitary
    assert _trace_infidelity(V, V_jax).max() <= 1e-12


def test_analytic_init_k3_against_host_routine():
    H = haar_sample(64, seed=3)
    U = np.concatenate([H[jsamplers.sqiswap_count_batch(H) == 3], ZOO3])
    # the host routine emits the port's count: 3, except the B class, which
    # sits on the 2-region boundary |z| = x - y (the 3-application init
    # still synthesizes it, as in tests/test_kak_batch.py)
    n_host = [jkak.sqiswap_decompose(u)[1] for u in U]
    assert n_host == list(sqiswap_count_batch(U, device="cpu")) == [3] * (len(U) - 1) + [2]
    x = make_analytic_init(3, device="cpu")(U).numpy()
    assert x.shape == (len(U), 24)
    V = _chain(x, 3)
    tr = np.abs(np.einsum("bij,bij->b", V.conj(), U))
    cost = 1.0 - (tr**2 + 4.0) / 20.0
    # tests/test_kak_batch.py's basin bounds for the (f32) JAX init
    assert (cost < 1e-4).all() and np.median(cost) < 1e-7, cost
    # the port's f64 readings on these 17 lanes: trace infidelity <= 4.4e-16,
    # square cost <= 6.7e-16
    assert _trace_infidelity(V, U).max() <= 1e-12


@pytest.mark.parametrize("k", [2, 3])
def test_analytic_solver_certifies_without_restarts(k):
    U = haar_sample(32, seed=5)
    idx = [i for i, u in enumerate(U) if (jkak._in_2region(jkak.kak_form(u).t) == (k == 2))]
    assert len(idx) >= 4
    solver = make_analytic_solver(k, device="cpu")
    x, cost = solver.solve(U[idx])
    assert x.shape == (len(idx), 6 * (k + 1)) and x.dtype == torch.float64
    assert cost.max().item() < 1e-10, cost
    # repolish keeps a certified iterate certified; init_only is the bare init
    x2, cost2 = solver.repolish(solver.init_only(U[idx]), U[idx])
    assert cost2.max().item() < 1e-10
    assert solver.n_params == 6 * (k + 1)


def test_analytic_init_refuses_other_depths():
    with pytest.raises(ValueError):
        make_analytic_init(4, device="cpu")
