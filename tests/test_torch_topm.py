"""``make_solver(..., top_m=m)``: each target's m restarts of least cost
after Adam enter the f32 LM (JAX gauss_newton.py:240-249, 489-508).

The JAX side runs its XLA path (``adam_backend="xla"``), which ranks by
``adam_cost`` under vmap; the port's kernel path ranks by the Adam kernel's
cost output, whose plain version on the CPU is the square cost of the
Adam result. Both take the selection of ``lax.top_k(-cost, m)``: ascending
cost, the lower restart index first on ties."""

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

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt import gauss_newton as gn
from slam_decomposition_torch.opt.gauss_newton import keep_top_m, make_solver
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

R = 4


def _inputs(B, k=2, seed=8, R=R):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    T = torch.as_tensor(haar_sample(B, seed=seed))
    x0 = torch.as_tensor(np.random.default_rng(seed).uniform(0, 2 * np.pi, (B, R, a.n_params)))
    return a, x0, T


def _jax_solver(k=2, **kw):
    ja = jtemplates.build_ansatz(jtemplates.cycle_gates([jgates.SQISWAP], k))
    return jax.jit(jmake_solver(ja.eval_fn, ja.n_params, chain_gates=ja.chain_gates, adam_backend="xla", **kw))


def _kept(monkeypatch):
    """Records every selection the solvers make."""
    seen = []

    def spy(cost, m):
        keep = keep_top_m(cost, m)
        seen.append((cost.clone(), keep))
        return keep

    monkeypatch.setattr(gn, "keep_top_m", spy)
    return seen


# ---------------------------------------------------------------- against JAX


def test_zero_counts_with_top_m_match_jax():
    """At zero counts JAX keeps the two restarts of least f32 cost at x0 and
    returns the better one, cast to f64, with its f64 cost: x bit for bit."""
    a, x0, T = _inputs(B=8)
    xj, lj = _jax_solver(adam_iters=0, lm32_iters=0, lm_iters=0, top_m=2)(
        jnp.asarray(x0.numpy()), jcplx.from_numpy(T.numpy()))
    solver = make_solver(a.eval_fn, a.n_params, adam_iters=0, lm32_iters=0, lm_iters=0,
                         chain_gates=a.chain_gates, device="cpu", top_m=2)
    xt, lt = solver.solve(x0, T)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-12)


def test_top_m_solve_certifies_and_keeps_the_restarts_jax_keeps(monkeypatch):
    """Full counts, B = 16: at most one certification flip (the f32 Adam
    and LM may leave a lane in another basin, as in
    test_torch_solver.py), and the kept restarts equal JAX's on at least
    15 of 16 targets. JAX's kept restarts are read from its own Adam: its
    solver at lm32_iters = lm_iters = 0 on every (target, restart) lane
    alone returns each lane's Adam result and its cost."""
    B = 16
    a, x0, T = _inputs(B=B, seed=102)
    _, lj = _jax_solver(top_m=2)(jnp.asarray(x0.numpy()), jcplx.from_numpy(T.numpy()))
    seen = _kept(monkeypatch)
    solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device="cpu", top_m=2)
    xt, lt = solver.solve(x0, T)
    lj, lt_np = np.asarray(lj), lt.numpy()
    flips = int(((lj <= 1e-10) != (lt_np <= 1e-10)).sum())
    assert flips <= 1, f"{flips} of {B} targets certified by only one solver"
    np.testing.assert_allclose(lt_np, solver.certify(xt, T).numpy(), atol=1e-13)

    Tr = T.numpy().repeat(R, axis=0)
    _, fa = _jax_solver(lm32_iters=0, lm_iters=0)(
        jnp.asarray(x0.numpy().reshape(B * R, 1, -1)), jcplx.from_numpy(Tr))
    kept_jax = np.sort(np.argsort(np.asarray(fa).reshape(B, R), axis=1, kind="stable")[:, :2], axis=1)
    (_, keep), = seen
    same = int((np.sort(keep.numpy(), axis=1) == kept_jax).all(axis=1).sum())
    assert same >= B - 1, f"kept restarts equal JAX's on {same} of {B} targets"


def test_selection_is_lax_top_k_of_the_negated_cost():
    """Ties (many, from small integer costs) keep the lower index first."""
    cost = np.random.default_rng(3).integers(0, 4, (64, 6)).astype(np.float32)
    for m in (1, 2, 3, 6):
        _, want = jax.lax.top_k(-jnp.asarray(cost), m)
        np.testing.assert_array_equal(keep_top_m(torch.as_tensor(cost), m).numpy(), np.asarray(want))


# ---------------------------------------------------------------- the port alone


def test_duplicated_restarts_keep_the_lower_index(monkeypatch):
    """Every restart a copy of restart 0: the costs tie and the first m
    restarts are kept, in order."""
    a, x0, T = _inputs(B=3, k=2, seed=4)
    x0 = x0[:, :1].expand(-1, R, -1).contiguous()
    seen = _kept(monkeypatch)
    xs, fs = make_solver(a.eval_fn, a.n_params, adam_iters=10, lm32_iters=2, lm_iters=2,
                         chain_gates=a.chain_gates, device="cpu", top_m=3).rank(x0, T)
    (cost, keep), = seen
    assert (cost == cost[:, :1]).all()
    np.testing.assert_array_equal(keep.numpy(), np.tile(np.arange(3), (3, 1)))
    assert xs.shape == (3, 3, a.n_params) and fs.shape == (3, 3)


def test_top_m_of_r_is_bit_equal_to_none():
    """m = R reorders the lanes by cost; each lane's result does not depend
    on its position, so the solve is the same bit for bit."""
    a, x0, T = _inputs(B=6, k=3, seed=9)
    kw = dict(adam_iters=30, lm32_iters=4, lm_iters=3, chain_gates=a.chain_gates, device="cpu")
    x_none, l_none = make_solver(a.eval_fn, a.n_params, **kw).solve(x0, T)
    x_all, l_all = make_solver(a.eval_fn, a.n_params, top_m=R, **kw).solve(x0, T)
    assert torch.equal(x_none, x_all) and torch.equal(l_none, l_all)


def test_top_m_cuts_the_lm_lanes_and_uses_the_cost_instance(monkeypatch):
    a, x0, T = _inputs(B=5, seed=11)
    calls = []
    adam = ck.adam_chain

    def spy(*args, **kw):
        calls.append(kw.get("with_cost", False))
        return adam(*args, **kw)

    monkeypatch.setattr(ck, "adam_chain", spy)
    ck.reset_launch_counts()
    make_solver(a.eval_fn, a.n_params, adam_iters=10, lm32_iters=2, lm_iters=2, chain_gates=a.chain_gates,
                device="cpu", top_m=2).solve(x0, T)
    assert calls == [True]
    assert ck.lane_counts() == {"adam_chain": [5 * R], "lm_chain": [5 * 2], "polish_chain": [5]}
    ck.reset_launch_counts()
    make_solver(a.eval_fn, a.n_params, adam_iters=10, lm32_iters=2, lm_iters=2, chain_gates=a.chain_gates,
                device="cpu").solve(x0, T)
    assert calls == [True, False]
    assert ck.lane_counts() == {"adam_chain": [5 * R], "lm_chain": [5 * R], "polish_chain": [5]}


@pytest.mark.parametrize("top_m", [0, R + 1])
@pytest.mark.parametrize("chain", [True, False], ids=["kernels", "general"])
def test_top_m_outside_one_to_r_raises(top_m, chain):
    a, x0, T = _inputs(B=2, seed=1)
    solver = make_solver(a.eval_fn, a.n_params, adam_iters=2, lm32_iters=1, lm_iters=1, device="cpu", top_m=top_m,
                         chain_gates=a.chain_gates if chain else None)
    assert solver.path == ("kernels" if chain else "general")
    with pytest.raises(ValueError, match="top_m"):
        solver.solve(x0, T)


def test_general_solver_with_the_makhlin_residual_ranks_by_its_square(monkeypatch):
    """On the general path the ranking cost is ``adam_cost``: for the Makhlin
    residual the squared residual at Adam's result."""
    a, x0, T = _inputs(B=4, k=2, seed=12)
    seen = _kept(monkeypatch)
    solver = make_solver(a.eval_fn, a.n_params, adam_iters=8, lm32_iters=2, lm_iters=2, residual="makhlin",
                         device="cpu", top_m=2)
    assert solver.path == "general"
    xs, fs = solver.rank(x0, T)
    (cost, keep), = seen
    t32 = T.to(torch.complex64).repeat_interleave(R, dim=0)
    xa = solver._adam(x0.reshape(4 * R, -1).float(), t32)
    r = gn.makhlin_residual(a.eval_fn, xa, t32)
    torch.testing.assert_close(cost, (r * r).sum(-1).view(4, R), rtol=0, atol=0)
    assert xs.shape == (4, 2, a.n_params) and fs.shape == (4, 2)
    x, loss = solver.solve(x0, T)
    assert x.shape == (4, a.n_params) and loss.shape == (4,)
