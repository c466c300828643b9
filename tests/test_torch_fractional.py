"""The quarter-iSwap basis, conversion_gain_gate(0, 0, 0, pi/8, 1), on the
CPU against the JAX package.

A fractional iSwap is the paper's subject: parallel drive under a speed
limit. The quarter-iSwap needs up to 6 applications (its cached coverage set
has layers 1..6), so its templates are the plain u3 chains of depth 5 and 6
that the kernel path takes since the kernels have two parameters a thread
(n = 36, 42). Here: the monodromy depths of Haar targets, exactly as JAX
gives them, and TemplateOptimizer with each target's own range (its
monodromy depth to 6) on depth-5 targets from the same starts as the JAX
optimizer. JAX compiles its solver for ~12 s a depth on a CPU, so depth 6
is held to the port alone here (a forced depth-6 solve certified in f64) and
to the kernels' host build (test_torch_kernel_lanes.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from slam_decomposition_tpu.coverage import coverage as jcov
from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import templates as jt
from slam_decomposition_tpu.opt import optimizer as joptimizer

from slam_decomposition_torch.coverage.coverage import load_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt import costs
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_sample

THRESH = 1e-10
ANGLE = np.pi / 8  # g2 of the quarter-iSwap: a quarter of iSwap's pi/2
N_TARGETS, SEED = 300, 456


def _q():
    return gates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)


def _basis():
    q = _q()
    return lambda k: build_ansatz(cycle_gates([q], k))


def _ranges(ks):
    return [list(range(max(int(k), 2), 7)) for k in ks]


@pytest.fixture(scope="module")
def targets():
    U = haar_sample(N_TARGETS, seed=SEED)
    return U, monodromy_ks_batch(load_coverage(_q()), U, device="cpu")


def test_quarter_iswap_depths_match_jax(targets):
    U, ks = targets
    jq = jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)
    assert str(_q()) == str(jq) == "2QGate(0.00000000, 0.39269908, 1.00000000)"
    np.testing.assert_array_equal(ks, jcov.monodromy_ks_batch(jcov.gate_set_to_coverage(jq), U))
    vals, counts = np.unique(ks, return_counts=True)
    assert dict(zip(vals.tolist(), counts.tolist())) == {2: 4, 3: 47, 4: 233, 5: 16}


def test_quarter_iswap_optimizer_matches_jax(targets, monkeypatch):
    """Twelve depth-5 targets, each over its range [5, 6], through both
    packages from the port's starts (the JAX optimizer's _init_params is
    replaced here, in the test): every target solved at depth 5 on the kernel
    path (its plain versions here), the same success, cycles and n_params,
    losses within 1e-10 of each other (both certify at 1e-10; the JAX cost
    is its f64 evaluation, the port's the polish's certificate), and the
    port's losses the f64 cost of its parameters within 1e-13."""
    U, ks = targets
    idx = np.where(ks == 5)[0][:12]
    T = U[idx]
    kw = dict(spanning_range=[2, 3, 4, 5, 6])
    opt = TemplateOptimizer(_basis(), objective="square", override_fail=True, device="cpu", **kw)
    drawn = []
    init = opt._init_params
    monkeypatch.setattr(opt, "_init_params", lambda *a: drawn.append(init(*a)) or drawn[-1])
    res = opt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    assert opt.solver_paths == {5: "kernels"} and len(drawn) == 1
    assert res.success.all() and (res.cycles == 5).all() and (res.n_params == 36).all(), res.loss
    feed = iter(drawn)
    monkeypatch.setattr(
        joptimizer.TemplateOptimizer, "_init_params", lambda self, key, a, b, r: jnp.asarray(next(feed).numpy())
    )
    jq = jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)
    jopt = joptimizer.TemplateOptimizer(lambda k: jt.build_ansatz(jt.cycle_gates([jq], k)), objective="square",
                                        override_fail=True, **kw)
    jres = jopt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    np.testing.assert_array_equal(res.success, jres.success)
    np.testing.assert_array_equal(res.cycles, jres.cycles)
    np.testing.assert_array_equal(res.n_params, jres.n_params)
    np.testing.assert_allclose(res.loss, jres.loss, atol=1e-10)
    a = opt.builder(5)
    true = costs.square_cost(a.eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)


def test_quarter_iswap_depth_6_takes_the_kernel_path(targets):
    """Depth-5 targets forced to depth 6 (n = 42): the kernel path's plain
    versions solve them, and each loss is the f64 cost of its parameters."""
    U, ks = targets
    T = U[np.where(ks == 5)[0][:2]]
    opt = TemplateOptimizer(_basis(), override_fail=True, device="cpu")
    res = opt.approximate_from_distribution(T, spanning_ranges=[[6]] * len(T))
    assert opt.solver_paths == {6: "kernels"} and res.success.all() and (res.n_params == 42).all(), res.loss
    true = costs.square_cost(opt.builder(6).eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)
