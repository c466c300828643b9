"""The port's general solver and its routing on the CPU, against the JAX
package's XLA solver from the same numpy starts.

Adam and the ranking LM run in f32 in both packages, so a lane whose f32
trajectory diverges can land in another basin: comparisons of single lanes
allow one such flip per batch (none was seen at these seeds)."""


import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import hamiltonians as jham
from slam_decomposition_tpu.models import templates as jt
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt import costs as jcosts
from slam_decomposition_tpu.opt.gauss_newton import make_solver as jmake_solver

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.models.templates import build_ansatz, build_ansatz_v2, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt import costs
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.opt.gauss_newton import (
    ChainSolver,
    GeneralSolver,
    make_solver,
    makhlin_residual,
    takes_kernels,
)

THRESH = 1e-10
BOUNDS = (np.zeros(2), np.full(2, np.pi / 2))


def _jcg(q, dtype):
    return jham.conversion_gain_u(q[0], q[1], t=1.0, dtype=dtype)


def _tcg(q, dtype):
    return ham.conversion_gain_u(q[..., 0], q[..., 1], t=1.0, dtype=dtype)


# name -> (JAX ansatz, port ansatz, make_solver keywords by package, targets)
def _solver_case(name):
    reach = np.stack([g.to_numpy() for g in (jgates.CNOT, jgates.ISWAP, jgates.berkeley(), jgates.SQISWAP)])
    if name in ("phase", "makhlin"):
        ja = jt.build_ansatz(jt.cycle_gates([jgates.SQISWAP], 3))
        ta = build_ansatz(cycle_gates([gates.SQISWAP], 3))
        T = haar_sample(6, seed=41)
    else:
        ja = jt.build_ansatz_v2(_jcg, n_gate_params=2, k=1, gate_bounds=BOUNDS)
        ta = build_ansatz_v2(_tcg, n_gate_params=2, k=1, gate_bounds=BOUNDS)
        T = reach
    jkw, tkw = {}, {}
    if "makhlin" in name:
        it = dict(adam_iters=250, lm32_iters=16, lm_iters=10, residual="makhlin")  # the optimizer's counts
        jkw, tkw = dict(it, final_cost_fn=jcosts.square_reduced_cost), dict(it, final_cost_fn=costs.square_reduced_cost)
    if "bounds" in name:
        jkw.update(lower=jnp.asarray(ja.lower), upper=jnp.asarray(ja.upper))
        tkw.update(lower=ta.lower, upper=ta.upper)
    return ja, ta, jkw, tkw, T


@pytest.mark.parametrize("name", ["phase", "makhlin", "phase_bounds", "makhlin_bounds"])
def test_general_solver_matches_jax(name):
    """Both residuals, with and without bounds, from the same x0s: the cost
    of every lane that converges in the JAX package agrees to 1e-10 and, for
    the phase residual, the polished x is that of the same restart (1e-4
    after both polishes; another restart would differ at order 1), up to one
    flipped lane. The Makhlin residual vanishes on a whole class of x, and
    the restarts that reach it tie in the ranking at rounding level, so
    there the costs and the residual are compared, not x."""
    ja, ta, jkw, tkw, T = _solver_case(name)
    B, R = len(T), 3
    rng = np.random.default_rng(len(name))
    x0 = ja.lower + rng.uniform(size=(B, R, ja.n_params)) * (ja.upper - ja.lower)
    js = jax.jit(jmake_solver(ja.eval_fn, ja.n_params, adam_backend="xla", **jkw))
    xj, fj = (np.asarray(a) for a in js(jnp.asarray(x0), jcplx.from_numpy(T)))
    solver = make_solver(ta.eval_fn, ta.n_params, device="cpu", **tkw)
    assert isinstance(solver, GeneralSolver) and solver.path == "general"
    xt, ft = solver.solve(torch.as_tensor(x0), torch.as_tensor(T))
    xt, ft = xt.numpy(), ft.numpy()
    bar = 1e-9
    assert (fj <= bar).sum() >= B - 1, fj
    agree = np.abs(ft - fj) <= 1e-10
    if "makhlin" in name:
        r = makhlin_residual(ta.eval_fn, torch.as_tensor(xt), torch.as_tensor(T)).numpy()
        agree &= np.abs(r).max(axis=1) <= 1e-7
    else:
        agree &= np.abs(xt - xj).max(axis=1) <= 1e-4
    assert agree[fj <= bar].sum() >= (fj <= bar).sum() - 1, (fj, ft)
    if "bounds" in name:
        assert (xt >= ta.lower - 1e-15).all() and (xt <= ta.upper + 1e-15).all()
    # the returned cost is the cost of the returned x, and polish keeps it
    np.testing.assert_allclose(ft, solver.certify(torch.as_tensor(xt), torch.as_tensor(T)).numpy(), atol=1e-15)
    xp, fp = solver.polish_cert(torch.as_tensor(xt), torch.as_tensor(T))
    assert (fp.numpy()[ft <= bar] <= bar).all() and xp.shape == xt.shape


def test_solve_with_history_shapes_and_lm_trace():
    ta = build_ansatz(cycle_gates([gates.SQISWAP], 3))
    ja = jt.build_ansatz(jt.cycle_gates([jgates.SQISWAP], 3))
    T = haar_sample(3, seed=1)
    x0 = np.random.default_rng(1).uniform(0, 2 * np.pi, (3, 2, ta.n_params))
    solver = make_solver(ta.eval_fn, ta.n_params, chain_gates=ta.chain_gates, device="cpu")
    assert isinstance(solver, ChainSolver)  # its histories still come from the general path
    xs, fs, adam, lm = solver.with_history(torch.as_tensor(x0), torch.as_tensor(T))
    assert xs.shape == (3, ta.n_params) and fs.shape == (3,)
    assert adam.shape == (3, 2, 100) and adam.dtype == torch.float32 and lm.shape == (3, 6) and lm.dtype == torch.float64
    assert (lm.min(dim=1).values < 1e-12).all()  # the polish trace reaches certification depth
    assert (lm[:, 1:] <= lm[:, :-1]).all()  # accepted ||r||^2 never rises
    jx, jf, jadam, jlm = jax.jit(jmake_solver(ja.eval_fn, ja.n_params, adam_backend="xla").with_history)(
        jnp.asarray(x0), jcplx.from_numpy(T)
    )
    assert adam.shape == jadam.shape and lm.shape == jlm.shape
    # the first Adam losses are those of x0, before any f32 drift
    np.testing.assert_allclose(adam[:, :, 0].numpy(), np.asarray(jadam)[:, :, 0], atol=1e-6)
    np.testing.assert_allclose(fs.numpy(), np.asarray(jf), atol=1e-10)


def test_routing_by_rule():
    cg = {k: build_ansatz(cycle_gates([gates.SQISWAP], k)) for k in range(1, 81)}
    for k in range(1, 80):
        assert takes_kernels(cg[k].chain_gates)
        s = make_solver(cg[k].eval_fn, cg[k].n_params, chain_gates=cg[k].chain_gates, device="cpu")
        assert isinstance(s, ChainSolver) and s.path == "kernels" and s.k == k
    assert ck.KERNEL_KS == tuple(range(1, 80)) and ck.INSTANCE_KS == tuple(range(1, 13))
    # the kernels cover depths 1..79 (13..79 through the depth-generic
    # programs): depth 80 takes the general path, by rule
    assert not takes_kernels(cg[80].chain_gates)
    assert isinstance(make_solver(cg[80].eval_fn, 486, chain_gates=cg[80].chain_gates, device="cpu"), GeneralSolver)
    a = cg[2]
    for kw in (dict(residual="makhlin"), dict(final_cost_fn=costs.basic_cost), dict(lower=a.lower, upper=a.upper)):
        assert not takes_kernels(a.chain_gates, **{k: v for k, v in kw.items() if k != "upper"})
        assert isinstance(make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device="cpu", **kw), GeneralSolver)
    assert not takes_kernels(None)
    # a template without chain_gates (rz layers) cannot take the kernels
    v = build_ansatz(cycle_gates([gates.CNOT], 2), vz_only=True)
    assert isinstance(make_solver(v.eval_fn, v.n_params, chain_gates=v.chain_gates, device="cpu"), GeneralSolver)
    # without the chain's constants a chain takes the general path
    assert isinstance(make_solver(a.eval_fn, a.n_params, device="cpu"), GeneralSolver)


@pytest.mark.parametrize("k", [1, 4, 5, 7, 13, 80])
def test_every_depth_solves(k):
    """Depths 1, 4, 5, 7 and 13 (the first depth of the depth-generic
    kernels) take the kernel path (their plain versions here) and certify
    targets of their class; depth 80, one past the kernels' last, takes the
    general path (a routing check: a solve at n = 486 is not run here)."""
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    if k == 80:
        solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device="cpu")
        assert solver.path == "general" and isinstance(solver, GeneralSolver)
        return
    T = a.eval_fn(torch.as_tensor(np.random.default_rng(k).uniform(0, 2 * np.pi, (4, a.n_params)))) if k == 1 else torch.as_tensor(haar_sample(4, seed=k))
    x0 = torch.as_tensor(np.random.default_rng(10 + k).uniform(0, 2 * np.pi, (4, 4, a.n_params)))
    solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device="cpu")
    assert solver.path == "kernels"
    x, f = solver.solve(x0, T)
    assert (f <= THRESH).all(), f
    np.testing.assert_allclose(f.numpy(), costs.square_cost(a.eval_fn(x), T).numpy(), atol=1e-13)


def test_general_path_agrees_with_kernel_path_lane_by_lane():
    """The chain template forced through the general path against the kernel
    path (plain versions here) from the same x0s: both certify every target,
    each by the other's measure too. Where several restarts converge they tie
    at the f32 floor and the two rankings (||r||^2 after the LM kernel, the
    f32 square cost here) may pick different ones, so x is compared only
    where it is the same restart's."""
    a = build_ansatz(cycle_gates([gates.SQISWAP], 3))
    T = torch.as_tensor(haar_sample(8, seed=6))
    x0 = torch.as_tensor(np.random.default_rng(6).uniform(0, 2 * np.pi, (8, 4, a.n_params)))
    before = GeneralSolver.calls
    xk, fk = ChainSolver(a.chain_gates, device="cpu").solve(x0, T)
    assert GeneralSolver.calls == before
    xg, fg = GeneralSolver(a.eval_fn, a.n_params, device="cpu").solve(x0, T)
    assert GeneralSolver.calls == before + 1
    assert (fk <= THRESH).all() and (fg <= THRESH).all()
    kernel, general = ChainSolver(a.chain_gates, device="cpu"), GeneralSolver(a.eval_fn, a.n_params, device="cpu")
    assert (kernel.certify(xg, T) <= THRESH).all() and (general.certify(xk, T) <= THRESH).all()
    # the kernel path reduces its angles mod 4 pi before the polish
    d = ck.reduce_angles(xk - xg).abs().amax(dim=1)
    assert ((d <= 1e-6) | (d >= 1e-2)).all() and (d <= 1e-6).any(), d
