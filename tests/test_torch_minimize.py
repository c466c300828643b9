"""The port's batched L-BFGS against the JAX package's per-lane one (vmapped),
lane by lane from the same numpy x0 on the same cost (CPU, f64).

Both compute the same recurrences, so every lane takes the same number of
iterations and ends with the same verdict; x agrees to 1e-8 except along
the cost's flat directions (the chain has gauge freedoms: rounding moves a
lane along them freely), which 2 of 24 lanes show at up to 4e-7."""

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
from slam_decomposition_tpu.opt.minimize import lbfgs as jlbfgs
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.models import gates as tgates
from slam_decomposition_torch.models import hamiltonians as tham
from slam_decomposition_torch.models import templates as tt
from slam_decomposition_torch.opt import costs as tcosts
from slam_decomposition_torch.opt.minimize import lbfgs

L = 24
KW = dict(f_tol=5e-11, g_tol=1e-14)


def _jax_lanes(ja, cost, x0, T, lower=None, upper=None, **kw):
    def one(x, t0, t1):
        return jlbfgs(lambda y: cost(ja.eval_fn(y), (t0, t1)), x, lower=lower, upper=upper, **kw)

    return jax.jit(jax.vmap(one))(jnp.asarray(x0), *jcplx.from_numpy(T))


def _compare(jr, tr, flat_lanes):
    np.testing.assert_array_equal(tr.n_iters.numpy(), np.asarray(jr.n_iters))
    np.testing.assert_array_equal(tr.converged.numpy(), np.asarray(jr.converged))
    np.testing.assert_allclose(tr.f.numpy(), np.asarray(jr.f), atol=1e-9)
    dx = np.abs(tr.x.numpy() - np.asarray(jr.x)).max(axis=1)
    assert (dx <= 1e-8).sum() >= len(dx) - flat_lanes and dx.max() <= 1e-6, np.sort(dx)[-4:]


@pytest.mark.parametrize("max_iters", [40, 250])
def test_lbfgs_matches_jax_lane_by_lane(max_iters):
    """CNOT chain of depth 3 to Haar targets under the square cost: at 40
    iterations about half of the lanes are cut short, at 250 all converge."""
    ja = jt.build_ansatz(jt.cycle_gates([jgates.CNOT], 3))
    ta = tt.build_ansatz(tt.cycle_gates([tgates.CNOT], 3))
    T = haar_sample(L, seed=2)
    x0 = np.random.default_rng(0).uniform(0, 2 * np.pi, (L, ja.n_params))
    jr = _jax_lanes(ja, jcosts.square_cost, x0, T, max_iters=max_iters, **KW)
    Tt = torch.as_tensor(T)
    tr = lbfgs(lambda x: tcosts.square_cost(ta.eval_fn(x), Tt), torch.as_tensor(x0), max_iters=max_iters, **KW)
    _compare(jr, tr, flat_lanes=2)
    assert int(tr.converged.sum()) == (L if max_iters == 250 else int(np.asarray(jr.converged).sum())) > 0
    # the host reads the device once per iteration and per block of trial
    # steps, not once per trial step
    assert tr.n_syncs < tr.n_evals / 2


def test_lbfgs_with_bounds_and_a_cusped_cost_matches_jax():
    """A parameterized conversion-gain gate under bounds and the basic cost
    (a square-root cusp at the optimum): projections, failed line searches
    and the steepest-descent restart all occur."""
    bounds = (np.zeros(2), np.full(2, np.pi / 2))
    ja = jt.build_ansatz_v2(lambda q, dtype: jham.conversion_gain_u(q[0], q[1], t=1.0, dtype=dtype), 2, 1, gate_bounds=bounds)
    ta = tt.build_ansatz_v2(
        lambda q, dtype: tham.conversion_gain_u(q[..., 0], q[..., 1], t=1.0, dtype=dtype), 2, 1, gate_bounds=bounds
    )
    T = np.broadcast_to(jgates.CNOT.to_numpy(), (L, 4, 4)).copy()
    rng = np.random.default_rng(5)
    x0 = ja.lower + rng.uniform(size=(L, ja.n_params)) * (ja.upper - ja.lower)
    jr = _jax_lanes(ja, jcosts.basic_cost, x0, T, jnp.asarray(ja.lower), jnp.asarray(ja.upper), max_iters=120, **KW)
    Tt = torch.as_tensor(T)
    tr = lbfgs(
        lambda x: tcosts.basic_cost(ta.eval_fn(x), Tt), torch.as_tensor(x0), max_iters=120,
        lower=torch.as_tensor(ta.lower), upper=torch.as_tensor(ta.upper), **KW,
    )
    # a lane whose line search ends on a tie at the cusp may take another
    # branch: 2 lanes may differ in their iteration count
    same = tr.n_iters.numpy() == np.asarray(jr.n_iters)
    assert same.sum() >= L - 2, (tr.n_iters.numpy(), np.asarray(jr.n_iters))
    np.testing.assert_array_equal(tr.converged.numpy()[same], np.asarray(jr.converged)[same])
    np.testing.assert_allclose(tr.f.numpy()[same], np.asarray(jr.f)[same], atol=1e-9)
    assert (tr.x >= torch.as_tensor(ta.lower)).all() and (tr.x <= torch.as_tensor(ta.upper)).all()


def test_finished_lanes_do_not_move_and_nan_stays_in_its_lane():
    """Lane 0 starts at its minimum (done before the first step), lane 1's
    cost is NaN everywhere, lanes 2.. run: 0 keeps its state bit for bit, 1
    stays where it is without touching the others."""
    a = torch.as_tensor(np.random.default_rng(1).uniform(1, 2, (6, 5)))
    center = torch.as_tensor(np.random.default_rng(2).normal(size=(6, 5)))

    def fun(x):
        f = (a * (x - center) ** 2).sum(-1) + ((x - center) ** 4).sum(-1)
        return torch.cat([f[:1], f[1:2] * float("nan"), f[2:]])

    x0 = center + 1.0
    x0[0] = center[0]
    r = lbfgs(fun, x0, max_iters=200, f_tol=1e-20, g_tol=1e-12)
    assert r.n_iters[0] == 0 and torch.equal(r.x[0], x0[0]) and r.converged[0]
    assert torch.equal(r.x[1], x0[1]) and not r.converged[1] and torch.isnan(r.f[1])
    assert r.converged[2:].all() and (r.x[2:] - center[2:]).abs().max() < 1e-6
    # the same lanes alone take the same path: no lane sees another
    alone = lbfgs(lambda x: (a[2:] * (x - center[2:]) ** 2).sum(-1) + ((x - center[2:]) ** 4).sum(-1), x0[2:],
                  max_iters=200, f_tol=1e-20, g_tol=1e-12)
    assert torch.equal(alone.x, r.x[2:]) and torch.equal(alone.n_iters, r.n_iters[2:])


def test_iteration_limit_and_result_fields():
    x0 = torch.as_tensor(np.random.default_rng(3).normal(size=(4, 3)))
    r = lbfgs(lambda x: ((x - 1.0) ** 4).sum(-1), x0, max_iters=3, f_tol=1e-30)
    assert (r.n_iters == 3).all() and not r.converged.any()
    assert r.x.shape == (4, 3) and r.f.shape == (4,) and r.n_iters.dtype == torch.int32
    assert (r.f < ((x0 - 1.0) ** 4).sum(-1)).all()
    assert r.n_evals >= 2 * 3 and r.n_syncs >= 3
