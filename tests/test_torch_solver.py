"""The port's solver and main path against the JAX solver, on the CPU.

Both solvers get the same numpy x0 and targets. The certified sets are
compared at the 1e-10 bar: the two run the same algorithm in f32 for Adam
and the ranking LM, so a lane whose f32 trajectory diverges can land in a
different basin. The bound allows 1 of 16 such flips; 0 were measured at
these seeds."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import templates as jtemplates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt.gauss_newton import make_solver as jmake_solver
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.opt.gauss_newton import ChainSolver
from slam_decomposition_torch.pipeline import decompose_haar

B, R = 16, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [2, 3])
def test_solve_certifies_the_same_targets_as_jax(k):
    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], k))
    T = haar_sample(B, seed=100 + k)
    x0 = np.random.default_rng(k).uniform(0, 2 * np.pi, (B, R, ja.n_params))
    js = jax.jit(jmake_solver(ja.eval_fn, ja.n_params, chain_gates=ja.chain_gates, adam_backend="xla"))
    _, lj = js(jnp.asarray(x0), jcplx.from_numpy(T))
    solver = ChainSolver(ja.chain_gates, device="cpu")
    xt, lt = solver.solve(torch.as_tensor(x0), torch.as_tensor(T))
    lj, lt = np.asarray(lj), lt.numpy()
    flips = int(((lj <= 1e-10) != (lt <= 1e-10)).sum())
    assert flips <= 1, f"{flips} of {B} targets certified by only one solver"
    # certificates are true costs of the returned parameters
    np.testing.assert_allclose(lt, solver.certify(xt, torch.as_tensor(T)).numpy(), atol=1e-13)
    assert xt.shape == (B, ja.n_params) and xt.dtype == torch.float64
    # polishing an already certified x keeps it certified
    xp = solver.polish(xt, torch.as_tensor(T))
    assert (solver.certify(xp, torch.as_tensor(T)).numpy()[lt <= 1e-10] <= 1e-10).all()


def test_solve_polishes_the_restart_of_smallest_lm_residual(monkeypatch):
    """Every restart goes through Adam and the f32 LM; the polish gets, per
    target, the restart whose ||r||^2 after the LM is smallest."""
    from slam_decomposition_torch.ops import chain_kernels as ck

    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], 2))
    T = torch.as_tensor(haar_sample(4, seed=7))
    x0 = torch.as_tensor(np.random.default_rng(7).uniform(0, 2 * np.pi, (4, R, ja.n_params)))
    solver = ChainSolver(ja.chain_gates, device="cpu")
    seen = {}
    polish = ck.polish_chain

    def spy(x, tgt, gates, iters):
        seen["x"] = x
        return polish(x, tgt, gates, iters)

    monkeypatch.setattr(ck, "polish_chain", spy)
    solver.solve(x0, T)
    t32 = T.to(torch.complex64).repeat_interleave(R, dim=0).contiguous()
    xa = ck.adam_chain(x0.reshape(4 * R, -1).float().contiguous(), t32, solver.gates32, solver.sched)
    xl, fl = ck.lm_chain(xa, t32, solver.gates32)
    best = torch.argmin(fl.view(4, R), dim=1)
    assert torch.equal(seen["x"], xl.view(4, R, -1)[torch.arange(4), best].double())


def test_decompose_haar_certifies_every_target():
    r = decompose_haar(B=128, chunk=128, restarts=4, thresh=1e-10, seed=456, device="cpu")
    assert r.losses.shape == (128,) and np.isfinite(r.losses).all()
    assert r.n_certified == 128
    assert set(r.k_histogram()) <= {2, 3} and sum(r.k_histogram().values()) == 128
    assert set(r.times) == {"ranges", "solve", "rescue", "total"}


# ---------------------------------------------------------------- zero counts
# The JAX mesh builds a local solver with lm_iters=0 and a polisher with
# adam_iters=0, lm32_iters=0 (parallel/mesh.py:187-203); make_solver then
# skips the phase: x passes through, and at lm_iters=0 the result is the
# rank winner with its f64 cost (gauss_newton.py:536-560).


def _zero_inputs(k=2, B=6, R=3, seed=5):
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates

    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    T = torch.as_tensor(haar_sample(B, seed=seed))
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * np.pi, (B, R, a.n_params)))
    return a, x0, T


def test_zero_iterations_leave_x_unchanged_on_the_plain_versions():
    from slam_decomposition_torch.ops import chain_kernels as ck

    a, x0, T = _zero_inputs()
    g64 = torch.as_tensor(a.chain_gates)
    g32 = g64.to(torch.complex64)
    x32 = x0[:, 0].float().contiguous()
    T32 = T.to(torch.complex64)
    sched = ck.adam_schedule(0)
    assert sched.shape == (0, 3)
    assert torch.equal(ck.adam_chain(x32, T32, g32, sched), x32)
    xa, cost = ck.adam_chain(x32, T32, g32, sched, with_cost=True)
    assert torch.equal(xa, x32) and torch.equal(cost, ck.square_cost(x32, T32, g32))
    xl, fl = ck.lm_chain(x32, T32, g32, 0)
    r = ck.phase_residual(x32, T32, g32)
    assert torch.equal(xl, x32) and torch.equal(fl, (r * r).sum(-1))
    x64 = x0[:, 0].contiguous() + 4 * np.pi  # the polish reduces the angles mod 4 pi
    xp, fp = ck.polish_chain(x64, T, g64, 0)
    r64 = ck.phase_residual(ck.reduce_angles(x64), T, g64)
    assert torch.equal(xp, ck.reduce_angles(x64)) and torch.equal(fp, (r64 * r64).sum(-1))
    # polish_cert at 0 hands x back as it is, with the certificate of its residual
    solver = ChainSolver(a.chain_gates, device="cpu", lm_iters=0)
    xc, c = solver.polish_cert(x64, T)
    assert torch.equal(xc, x64)
    np.testing.assert_allclose(c.numpy(), solver.certify(x64, T).numpy(), atol=1e-14)


@pytest.mark.parametrize("zero", ["adam_iters", "lm32_iters", "lm_iters"])
def test_a_zero_count_skips_its_phase(zero):
    """Each zero count gives the solve without that phase: the other phases'
    plain versions composed by hand."""
    from slam_decomposition_torch.ops import chain_kernels as ck

    a, x0, T = _zero_inputs(k=3, seed=6)
    iters = {"adam_iters": 40, "lm32_iters": 4, "lm_iters": 4, zero: 0}
    solver = ChainSolver(a.chain_gates, device="cpu", **iters)
    xs, c = solver.solve(x0, T)
    B, R, n = x0.shape
    g64 = torch.as_tensor(a.chain_gates)
    g32 = g64.to(torch.complex64)
    t32 = T.to(torch.complex64).repeat_interleave(R, dim=0)
    xa = x0.reshape(B * R, n).float()
    if iters["adam_iters"]:
        xa = ck.adam_loop(lambda x: ck.square_cost(x, t32, g32), xa, ck.adam_schedule(iters["adam_iters"]))
    if iters["lm32_iters"]:
        xa, _ = ck.lm_chain_ref(xa, t32, g32, iters["lm32_iters"])
    r = ck.phase_residual(xa, t32, g32)
    best = torch.argmin((r * r).sum(-1).view(B, R), dim=1)
    xw = xa.view(B, R, n)[torch.arange(B), best].double()
    if iters["lm_iters"]:
        xw, _ = ck.polish_chain_ref(xw, T, g64, iters["lm_iters"])
    assert torch.equal(xs, xw)
    np.testing.assert_allclose(c.numpy(), ck.square_cost(xw, T, g64).numpy(), atol=1e-14)


def test_zero_counts_match_jax():
    """All three at 0: JAX returns the restart of least f32 cost at x0, cast
    to f64, with its f64 cost; so does the port, bit for bit in x."""
    a, x0, T = _zero_inputs(B=8, R=4, seed=8)
    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], 2))
    js = jax.jit(jmake_solver(ja.eval_fn, ja.n_params, adam_iters=0, lm32_iters=0, lm_iters=0,
                              chain_gates=ja.chain_gates, adam_backend="xla"))
    xj, lj = js(jnp.asarray(x0.numpy()), jcplx.from_numpy(T.numpy()))
    xt, lt = ChainSolver(a.chain_gates, device="cpu", adam_iters=0, lm32_iters=0, lm_iters=0).solve(x0, T)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-12)
