"""The eighth-iSwap basis, conversion_gain_gate(0, 0, 0, pi/16, 1), on the
CPU against the JAX package.

The eighth-iSwap needs up to 12 applications (its cached coverage set has
layers 1..12): four in five Haar targets need depth 7 or more, the plain u3
chains of n = 48..78 parameters that the kernel path takes since the kernels
are instantiated to depth 12 (three parameters a thread of the LM's warp
from depth 10). Here: the monodromy depths of Haar targets, exactly as JAX
gives them, and TemplateOptimizer with each target's own range (its
monodromy depth to 12) on depth-7 targets from the same starts as the JAX
optimizer. JAX compiles its optimizer for ~25 s a depth on a CPU, so depths
10 and 12 are held to the port alone here (forced solves certified in f64)
and to the kernels' host build (test_torch_kernel_lanes.py)."""

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
ANGLE = np.pi / 16  # g2 of the eighth-iSwap: an eighth of iSwap's pi/2
DEPTHS = list(range(2, 13))
N_TARGETS, SEED = 300, 456
# eight depth-7 targets that the port solves at depth 7 from these starts:
# of the first ten depth-7 targets, two (indices 16 and 27) miss with all
# five restarts there in a batch of eight, and would make JAX compile its
# optimizer at deeper depths as well
DEPTH7 = [1, 4, 6, 13, 20, 23, 29, 31]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for this module, restored after it: the plain
    versions here run many small ops, where extra threads only add
    synchronisation (and contend with the other test processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _q():
    return gates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)


def _basis():
    q = _q()
    return lambda k: build_ansatz(cycle_gates([q], k))


def _ranges(ks):
    return [list(range(max(int(k), 2), 13)) for k in ks]


@pytest.fixture(scope="module")
def targets():
    U = haar_sample(N_TARGETS, seed=SEED)
    return U, monodromy_ks_batch(load_coverage(_q()), U, device="cpu")


def test_eighth_iswap_depths_match_jax(targets):
    U, ks = targets
    jq = jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)
    assert str(_q()) == str(jq) == "2QGate(0.00000000, 0.19634954, 1.00000000)"
    np.testing.assert_array_equal(ks, jcov.monodromy_ks_batch(jcov.gate_set_to_coverage(jq), U))
    vals, counts = np.unique(ks, return_counts=True)
    assert dict(zip(vals.tolist(), counts.tolist())) == {3: 1, 4: 3, 5: 13, 6: 34, 7: 84, 8: 149, 9: 14, 10: 2}


def test_eighth_iswap_depths_at_full_width_match_jax():
    """The 100000 targets chip_smoke.py solves: the port's depths on the CPU
    equal the JAX package's, with the histogram that script holds the card's
    depths to (four in five at depth 7 or more)."""
    U = haar_sample(100_000, seed=SEED)
    ks = monodromy_ks_batch(load_coverage(_q()), U, device="cpu")
    jq = jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)
    np.testing.assert_array_equal(ks, jcov.monodromy_ks_batch(jcov.gate_set_to_coverage(jq), U))
    vals, counts = np.unique(ks, return_counts=True)
    assert dict(zip(vals.tolist(), counts.tolist())) == {
        2: 3, 3: 88, 4: 865, 5: 4460, 6: 14074, 7: 30125, 8: 46431, 9: 3554, 10: 383, 11: 17
    }


def test_eighth_iswap_optimizer_matches_jax(targets, monkeypatch):
    """Eight depth-7 targets, each over its range [7..12], through both
    packages from the port's starts (the JAX optimizer's _init_params is
    replaced here, in the test): every target solved at depth 7 on the kernel
    path (its plain versions here), the same success, cycles and n_params,
    losses within 1e-10 of each other (both certify at 1e-10; the JAX cost
    is its f64 evaluation, the port's the polish's certificate), and the
    port's losses the f64 cost of its parameters within 1e-13."""
    U, ks = targets
    idx = np.array(DEPTH7)
    assert (ks[idx] == 7).all()
    T = U[idx]
    opt = TemplateOptimizer(_basis(), objective="square", override_fail=True, device="cpu", spanning_range=DEPTHS)
    drawn = []
    init = opt._init_params
    monkeypatch.setattr(opt, "_init_params", lambda *a: drawn.append(init(*a)) or drawn[-1])
    res = opt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    assert opt.solver_paths == {7: "kernels"} and len(drawn) == 1
    assert res.success.all() and (res.cycles == 7).all() and (res.n_params == 48).all(), res.loss
    feed = iter(drawn)
    monkeypatch.setattr(
        joptimizer.TemplateOptimizer, "_init_params", lambda self, key, a, b, r: jnp.asarray(next(feed).numpy())
    )
    jq = jgates.conversion_gain_gate(0, 0, 0, ANGLE, 1.0)
    jopt = joptimizer.TemplateOptimizer(lambda k: jt.build_ansatz(jt.cycle_gates([jq], k)), objective="square",
                                        override_fail=True, spanning_range=DEPTHS)
    jres = jopt.approximate_from_distribution(T, spanning_ranges=_ranges(ks[idx]))
    np.testing.assert_array_equal(res.success, jres.success)
    np.testing.assert_array_equal(res.cycles, jres.cycles)
    np.testing.assert_array_equal(res.n_params, jres.n_params)
    np.testing.assert_allclose(res.loss, jres.loss, atol=1e-10)
    true = costs.square_cost(opt.builder(7).eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)


@pytest.mark.parametrize("k", [10, 12])
def test_eighth_iswap_deep_chains_take_the_kernel_path(targets, k):
    """Two depth-7 targets forced to depth 10 (n = 66, the first depth with
    three parameters a thread of the LM's warp) and to depth 12 (n = 78):
    the kernel path's plain versions solve them, and each loss is the f64
    cost of its parameters."""
    U, ks = targets
    T = U[DEPTH7[:2]]
    opt = TemplateOptimizer(_basis(), override_fail=True, device="cpu")
    res = opt.approximate_from_distribution(T, spanning_ranges=[[k]] * len(T))
    assert opt.solver_paths == {k: "kernels"} and res.success.all() and (res.n_params == 6 * (k + 1)).all(), res.loss
    true = costs.square_cost(opt.builder(k).eval_fn(torch.as_tensor(res.params)), torch.as_tensor(T)).numpy()
    np.testing.assert_allclose(res.loss, true, atol=1e-13)
