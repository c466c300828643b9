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
