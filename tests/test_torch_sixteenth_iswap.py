"""The sixteenth-iSwap basis, conversion_gain_gate(0, 0, 0, pi/32, 1), on the
CPU against the JAX package.

The sixteenth-iSwap needs up to 24 applications (its cached coverage set has
layers 1..24): four in five Haar targets need depth 13 or more, the plain u3
chains of n = 84..150 parameters that the kernel path takes through the
depth-generic programs (csrc/*_generic.cu*, K a runtime argument). Here: the
monodromy depths of Haar targets, exactly as JAX gives them, and
TemplateOptimizer with each target's own range (its monodromy depth to 24)
on depth-13 targets from the same starts as the JAX optimizer. The generic
programs themselves are held to the plain versions by their host build
(test_torch_kernel_lanes.py)."""

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
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

ANGLE = np.pi / 32  # g2 of the sixteenth-iSwap: a sixteenth of iSwap's pi/2
DEPTHS = list(range(2, 25))
N_TARGETS, SEED = 300, 456
# the depths of haar_sample(100000, seed=456), which chip_smoke.py holds the
# card's depths to
HIST = {4: 4, 5: 23, 6: 64, 7: 252, 8: 613, 9: 1540, 10: 2920, 11: 5354, 12: 8720, 13: 12870, 14: 17255,
        15: 21618, 16: 24813, 17: 2555, 18: 999, 19: 314, 20: 69, 21: 15, 22: 2}
# four depth-13 targets that the port solves at depth 13 from these starts
DEPTH13 = [6, 29, 33, 53]


def _q():
    return gates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)


def _jq():
    return jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)


def _basis():
    q = _q()
    return lambda k: build_ansatz(cycle_gates([q], k))


def _ranges(ks):
    return [list(range(max(int(k), 2), 25)) for k in ks]


def _hist(ks):
    vals, counts = np.unique(ks, return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


@pytest.fixture(scope="module")
def targets():
    U = haar_sample(N_TARGETS, seed=SEED)
    return U, monodromy_ks_batch(load_coverage(_q()), U, device="cpu")


def test_sixteenth_iswap_depths_match_jax(targets):
    U, ks = targets
    assert str(_q()) == str(_jq()) == "2QGate(0.00000000, 0.09817477, 1.00000000)"
    np.testing.assert_array_equal(ks, jcov.monodromy_ks_batch(jcov.gate_set_to_coverage(_jq()), U))
    assert (ks >= 13).mean() > 0.75 and ks.max() <= 24


def test_sixteenth_iswap_depths_at_full_width_match_jax():
    """The 100000 targets chip_smoke.py solves: the port's depths on the CPU
    equal the JAX package's, with the histogram that script holds the card's
    depths to (80.5% at depth 13 or more, none past 22)."""
    U = haar_sample(100_000, seed=SEED)
    ks = monodromy_ks_batch(load_coverage(_q()), U, device="cpu")
    np.testing.assert_array_equal(ks, jcov.monodromy_ks_batch(jcov.gate_set_to_coverage(_jq()), U))
    assert _hist(ks) == HIST
    assert (ks >= 13).sum() == 80_510


def test_sixteenth_iswap_optimizer_matches_jax(targets, monkeypatch):
    """Four depth-13 targets, each over its range [13..24], through both
    packages from the port's starts (the JAX optimizer's _init_params is
    replaced here, in the test): every target solved at depth 13 on the
    kernel path (its plain versions here), the same success, cycles and
    n_params, losses within 1e-10 of each other (both certify at 1e-10; the
    JAX cost is its f64 evaluation, the port's the polish's certificate), and
    the port's losses the f64 cost of its parameters within 1e-13."""
    U, ks = targets
    idx = np.array(DEPTH13)
    assert (ks[idx] == 13).all()
    T = U[idx]
    opt = TemplateOptimizer(_basis(), objective="square", override_fail=True, device="cpu", spanning_range=DEPTHS)
    drawn = []
    init = opt._init_params
    monkeypatch.setattr(opt, "_init_params", lambda *a: drawn.append(init(*a)) or drawn[-1])
    res = opt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    assert opt.solver_paths == {13: "kernels"} and len(drawn) == 1
    assert res.success.all() and (res.cycles == 13).all() and (res.n_params == 84).all(), res.loss
    feed = iter(drawn)
    monkeypatch.setattr(
        joptimizer.TemplateOptimizer, "_init_params", lambda self, key, a, b, r: jnp.asarray(next(feed).numpy())
    )
    jq = _jq()
    jopt = joptimizer.TemplateOptimizer(lambda k: jt.build_ansatz(jt.cycle_gates([jq], k)), objective="square",
                                        override_fail=True, spanning_range=DEPTHS)
    jres = jopt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    np.testing.assert_array_equal(res.success, jres.success)
    np.testing.assert_array_equal(res.cycles, jres.cycles)
    np.testing.assert_array_equal(res.n_params, jres.n_params)
    np.testing.assert_allclose(res.loss, jres.loss, atol=1e-10)
    true = costs.square_cost(opt.builder(13).eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)


@pytest.mark.parametrize("k", [16])
def test_sixteenth_iswap_deep_chains_take_the_kernel_path(targets, k):
    """Two depth-13 targets forced to depth 16 (n = 102, the depth most
    targets need): the kernel path's plain versions solve them, and each
    loss is the f64 cost of its parameters."""
    U, ks = targets
    T = U[DEPTH13[:2]]
    opt = TemplateOptimizer(_basis(), override_fail=True, device="cpu")
    res = opt.approximate_from_distribution(T, spanning_ranges=[[k]] * len(T))
    assert opt.solver_paths == {k: "kernels"} and res.success.all() and (res.n_params == 6 * (k + 1)).all(), res.loss
    true = costs.square_cost(opt.builder(k).eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)
