"""The port's TemplateOptimizer on the CPU: against the JAX package from the
same numpy starts, and the cases of the JAX package's own optimizer tests
run through the port (the solvers beneath it: test_torch_general_solver.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import hamiltonians as jham
from slam_decomposition_tpu.models import templates as jt
from slam_decomposition_tpu.opt import optimizer as joptimizer

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.models.templates import build_ansatz, build_ansatz_v2, cycle_gates
from slam_decomposition_torch.opt import costs
from slam_decomposition_torch.opt.optimizer import SynthesisResult, TemplateOptimizer
from slam_decomposition_torch.opt.preseed import PreseedStore
from slam_decomposition_torch.opt.samplers import haar_exact_sample, haar_sample
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

THRESH = 1e-10
BOUNDS = (np.zeros(2), np.full(2, np.pi / 2))


def _basis(gate):
    return lambda k: build_ansatz(cycle_gates([gate], k))


def _jbasis(gate):
    return lambda k: jt.build_ansatz(jt.cycle_gates([gate], k))


def _jcg(q, dtype):
    return jham.conversion_gain_u(q[0], q[1], t=1.0, dtype=dtype)


def _tcg(q, dtype):
    return ham.conversion_gain_u(q[..., 0], q[..., 1], t=1.0, dtype=dtype)


def _opt(basis, **kw):
    kw.setdefault("override_fail", True)
    return TemplateOptimizer(basis, device="cpu", **kw)


# --------------------------------------------------------------- optimizer


def test_readme_quick_start():
    """The README's first quick-start with the port's import path."""
    from slam_decomposition_torch.models.gates import SQISWAP
    from slam_decomposition_torch.opt.optimizer import TemplateOptimizer

    basis = lambda k: build_ansatz(cycle_gates([SQISWAP], k))  # noqa: E731
    opt = TemplateOptimizer(basis, objective="square", spanning_range=[2, 3], device="cpu")
    result = opt.approximate_from_distribution(haar_sample(16, seed=0))
    assert isinstance(result, SynthesisResult)
    assert result.success.all() and result.loss.max() <= THRESH
    assert set(result.cycles) <= {2, 3} and (result.n_params == 6 * (result.cycles + 1)).all()
    assert opt.solver_paths == {2: "kernels", 3: "kernels"}
    from slam_decomposition_torch.opt.samplers import sqiswap_count_batch

    # the analytic count is the least depth; a target whose 5 restarts all miss
    # at k=2 is solved at k=3 (1 of these 16)
    count = sqiswap_count_batch(haar_sample(16, seed=0), device="cpu")
    assert (result.cycles >= count).all() and (result.cycles == count).sum() >= 14


def test_optimizer_matches_jax_end_to_end(monkeypatch):
    """Both packages from the port's x0s (the JAX optimizer's _init_params is
    replaced here, in the test): same success, cycles and n_params, losses
    to 1e-10."""
    targets = np.concatenate(
        [np.stack([g.to_numpy() for g in (gates.SQISWAP, gates.ISWAP, gates.CNOT, gates.SWAP)]), haar_sample(4, seed=3)]
    )
    kw = dict(spanning_range=[1, 2, 3], training_restarts=4, seed=5)
    opt = _opt(_basis(gates.SQISWAP), **kw)
    drawn = []
    init = opt._init_params
    monkeypatch.setattr(opt, "_init_params", lambda *a: drawn.append(init(*a)) or drawn[-1])
    res = opt.approximate_from_distribution(targets)
    assert len(drawn) == 3 and opt.solver_paths == {1: "kernels", 2: "kernels", 3: "kernels"}
    feed = iter(drawn)
    monkeypatch.setattr(
        joptimizer.TemplateOptimizer, "_init_params", lambda self, key, a, b, r: jnp.asarray(next(feed).numpy())
    )
    jres = joptimizer.TemplateOptimizer(_jbasis(jgates.SQISWAP), override_fail=True, **kw).approximate_from_distribution(targets)
    np.testing.assert_array_equal(res.success, jres.success)
    np.testing.assert_array_equal(res.cycles, jres.cycles)
    np.testing.assert_array_equal(res.n_params, jres.n_params)
    np.testing.assert_allclose(res.loss, jres.loss, atol=1e-10)
    assert res.success.all() and res.cycles[:4].tolist() == [1, 2, 2, 3]
    assert res.params.shape == jres.params.shape == (8, 24)


def test_cnot_basis_haar_k3():
    opt = _opt(_basis(gates.CNOT), spanning_range=[3], training_restarts=4, max_iters=250)
    res = opt.approximate_from_distribution(haar_sample(8, seed=2))
    assert res.success.all(), res.loss


def test_cnot_swap_needs_exactly_3():
    swap = gates.SWAP.to_numpy()[None]
    res2 = _opt(_basis(gates.CNOT), spanning_range=[2], training_restarts=6).approximate_from_distribution(swap)
    assert not res2.success.any(), "SWAP should NOT be reachable with 2 CNOTs"
    res3 = _opt(_basis(gates.CNOT), spanning_range=[3], training_restarts=6).approximate_from_distribution(swap)
    assert res3.success.all(), res3.loss


def test_spanning_early_exit():
    """sqiSwap itself is solved at k=1 (the depth-1 kernel instances' plain
    versions), not k=3."""
    opt = _opt(_basis(gates.SQISWAP), spanning_range=[1, 2, 3], training_restarts=4)
    tgt = np.stack([gates.SQISWAP.to_numpy(), gates.ISWAP.to_numpy()])
    res = opt.approximate_from_distribution(tgt)
    assert res.success.all()
    assert res.cycles[0] == 1 and res.n_params[0] == 12
    assert res.cycles[1] == 2
    # per-target ranges: a target is only tried at its own depths
    res = opt.approximate_from_distribution(tgt, spanning_ranges=[[1], [2, 3]])
    assert res.cycles.tolist() == [1, 2]


def test_default_spanning_range_reaches_depth_5_without_error():
    """The default range is 1..5: every depth of it takes the kernel path by
    rule (on any device; the kernels cover depths 1..79), SWAP is solved at 3
    and never gets to 4 or 5; a chain of depth 80 takes the general path."""
    opt = _opt(_basis(gates.SQISWAP), training_restarts=3)
    assert opt.spanning_range == [1, 2, 3, 4, 5]
    res = opt.approximate_from_distribution(gates.SWAP.to_numpy())
    assert res.success.all() and res.cycles.tolist() == [3]
    assert all(opt._solver_for(k, opt.basis(k))[1] == "kernels" for k in (4, 5, 6, 7, 12, 13, 24, 48, 64, 79))
    assert opt._solver_for(80, opt.basis(80))[1] == "general"


def test_b_basis_haar_k2():
    opt = _opt(_basis(gates.berkeley()), spanning_range=[2], training_restarts=6)
    res = opt.approximate_from_distribution(haar_sample(6, seed=4))
    assert res.success.all(), res.loss


@pytest.mark.parametrize("method", ["auto", "lbfgs"])
def test_v2_parameterized_gate(method):
    """Optimize over the 2Q gate's parameters too: one conversion-gain gate
    with free (gc, gg) under bounds, plus 1Q layers, reaches CNOT at k=1."""
    ansatz = build_ansatz_v2(_tcg, n_gate_params=2, k=1, gate_bounds=BOUNDS)
    opt = _opt(ansatz, training_restarts=6, max_iters=200, method=method)
    res = opt.approximate_target_U(gates.CNOT.to_numpy())
    assert res.success.all(), res.loss
    assert opt.solver_paths == {1: "general" if method == "auto" else "lbfgs"}
    q = res.params[0, ansatz.n_params_1q :]
    assert (q >= 0).all() and (q <= np.pi / 2).all()


def test_failure_raises_without_override():
    opt = TemplateOptimizer(_basis(gates.CNOT), spanning_range=[1], training_restarts=2, max_iters=100, device="cpu")
    with pytest.raises(ValueError, match="failed to converge"):
        opt.approximate_from_distribution(gates.SWAP.to_numpy()[None])


def test_preseeding_end_to_end(tmp_path, monkeypatch):
    """Solved decompositions persist and seed a later run on the same
    coordinates."""
    monkeypatch.setenv("SLAM_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("SLAM_CACHE_DIR", str(tmp_path))
    targets = haar_sample(3, seed=21)
    mk = lambda: _opt(  # noqa: E731
        _basis(gates.SQISWAP), spanning_range=[3], training_restarts=3, preseed=True, preseed_key="t"
    )
    opt1 = mk()
    res1 = opt1.approximate_from_distribution(targets)
    assert res1.success.all()
    assert len(opt1.preseed_store) == 3
    opt2 = mk()
    assert len(opt2.preseed_store) == 3
    seeds, ok = opt2.preseed_store.seeds_for(opt1.preseed_store.coords, opt1.preseed_store.params.shape[1], cycles=3)
    assert ok.all()
    np.testing.assert_allclose(seeds, opt1.preseed_store.params)  # temperature 0: the stored parameters
    _, far = opt2.preseed_store.seeds_for(opt1.preseed_store.coords, 18, cycles=2)
    assert not far.any()  # another cycle count seeds nothing
    res2 = opt2.approximate_from_distribution(targets)
    assert res2.success.all()
    assert len(PreseedStore.load("t")) == 6 and len(PreseedStore.load("other")) == 0


_PRESEED_CHILD = """
import sys
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_sample

opt = TemplateOptimizer(
    lambda k: build_ansatz(cycle_gates([gates.SQISWAP], k)),
    spanning_range=[3], training_restarts=3, override_fail=True,
    preseed=True, device="cpu",  # no explicit preseed_key
)
print("KEY", opt.preseed_store.key)
print("LEN0", len(opt.preseed_store))
if sys.argv[1] == "solve":
    opt.approximate_from_distribution(haar_sample(2, seed=5))
    print("LEN1", len(opt.preseed_store))
"""


def test_preseed_default_key_survives_restart(tmp_path):
    """The default store key comes from the template's content, not from
    object identity, so seeds saved in one process are found by the next."""
    env = dict(os.environ, SLAM_DATA_DIR=str(tmp_path), SLAM_CACHE_DIR=str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    run = lambda mode: subprocess.run(  # noqa: E731
        [sys.executable, "-c", _PRESEED_CHILD, mode], env=env, cwd=root, capture_output=True, text=True, check=True
    ).stdout.split()
    out1, out2 = run("solve"), run("load")
    assert out1[1] == out2[1]  # the same key in both processes
    assert int(out1[3]) == 0 and int(out1[5]) == 2
    assert int(out2[3]) == 2  # the second process sees the first's solutions


def test_preseed_store_never_writes_the_data_directory(tmp_path, monkeypatch):
    """The store is saved under the build directory, and the data directory
    (here a copy of the JAX package's) is only read: a solve with
    ``preseed=True`` adds no file to it, and a second load finds the store
    where it was saved."""
    import pathlib
    import shutil

    from slam_decomposition_torch.opt import preseed

    data, build = tmp_path / "data", tmp_path / "build"
    shutil.copytree(pathlib.Path(__file__).resolve().parents[1] / "slam_decomposition_tpu" / "data", data)
    monkeypatch.setenv("SLAM_DATA_DIR", str(data))
    monkeypatch.setenv("SLAM_CACHE_DIR", str(build))
    before = sorted(p.name for p in data.iterdir())
    opt = TemplateOptimizer(
        _basis(gates.SQISWAP), spanning_range=[3], training_restarts=3, override_fail=True, preseed=True, device="cpu"
    )
    opt.approximate_from_distribution(haar_sample(2, seed=5))
    assert sorted(p.name for p in data.iterdir()) == before
    path = preseed.store_path(opt.preseed_store.key)
    assert path.parent == build / "slam_preseed" and path.exists()
    assert len(PreseedStore.load(opt.preseed_store.key)) == 2
    # a store found only in the data directory is read there
    moved = data / path.name
    shutil.move(path, moved)
    assert len(PreseedStore.load(opt.preseed_store.key)) == 2
    assert not path.exists()


@pytest.mark.parametrize("obj", ["square_reduced", "makhlin_functional"])
def test_fast_path_class_objectives(obj):
    """The reduced / Makhlin family rides Adam + LM on the 3-dim Makhlin
    residual (the general path), not L-BFGS."""
    opt = _opt(_basis(gates.SQISWAP), objective=obj, spanning_range=[3], training_restarts=4, success_threshold=1e-9)
    assert opt._residual_for() == ("makhlin", costs.COSTS[obj])
    res = opt.approximate_from_distribution(haar_sample(8, seed=4))
    assert res.success.all(), (obj, res.loss)
    assert opt.solver_paths == {3: "general"} and not opt.lbfgs_stats


def test_objective_routing():
    mk = lambda **kw: _opt(_basis(gates.SQISWAP), **kw)  # noqa: E731
    assert mk()._residual_for() == ("phase", None)
    assert mk(objective="basic")._residual_for() == ("phase", costs.basic_cost)
    assert mk(objective="square_reduced_bell")._residual_for() == (None, None)  # no residual: L-BFGS
    assert mk(objective="square_reduced_bell", method="gauss_newton")._residual_for() == ("phase", None)
    assert mk(method="lbfgs")._residual_for() == (None, None)
    assert mk(constraint_max_cost=1.0)._residual_for() == (None, None)
    assert mk(objective=lambda U, V: costs.square_cost(U, V))._residual_for() == (None, None)
    with pytest.raises(ValueError, match="MixedOrderBasisTemplate"):
        mk().cost_from_distribution(haar_sample(2, seed=0))


def test_builder_is_the_k_to_ansatz_function():
    """opt.builder is the k -> Ansatz function, as in the JAX package
    (tests/test_optimizer.py calls opt.builder(3)); basis is its alias. A
    fixed Ansatz gives a builder that returns it at every k."""
    opt = _opt(_basis(gates.SQISWAP))
    jopt = joptimizer.TemplateOptimizer(_jbasis(jgates.SQISWAP))
    a, ja = opt.builder(3), jopt.builder(3)
    assert a.k == ja.k == 3 and a.n_params == ja.n_params == 24 and opt.basis is opt.builder
    x = np.random.default_rng(3).uniform(0, 2 * np.pi, a.n_params)
    re, im = ja.eval_fn(jnp.asarray(x))
    np.testing.assert_allclose(a.eval_fn(torch.as_tensor(x)).numpy(), np.asarray(re) + 1j * np.asarray(im), atol=1e-12)
    fixed = build_ansatz(cycle_gates([gates.CNOT], 2))
    assert _opt(fixed).builder(5) is fixed


def test_gauss_newton_with_a_ceiling_takes_the_phase_path(monkeypatch):
    """method="gauss_newton" with a cost ceiling: the JAX optimizer builds
    the phase-residual Adam + LM solver and ignores the ceiling
    (optimizer.py:153-173); so does the port (the kernel path for a plain
    chain), with no L-BFGS run."""
    from slam_decomposition_tpu.opt import gauss_newton as jgn

    seen = []
    make = jgn.make_solver
    monkeypatch.setattr(jgn, "make_solver", lambda *a, **kw: seen.append(kw) or make(*a, **kw))
    kw = dict(spanning_range=[2], training_restarts=3, method="gauss_newton", constraint_max_cost=0.5)
    jopt = joptimizer.TemplateOptimizer(_jbasis(jgates.SQISWAP), override_fail=True, **kw)
    jopt._make_solver(jopt.builder(2), 2, 3)  # built, not compiled
    assert seen[0]["residual"] == "phase" and seen[0]["final_cost_fn"] is None
    opt = _opt(_basis(gates.SQISWAP), **kw)
    assert opt._residual_for() == ("phase", None)
    res = opt.approximate_from_distribution(haar_exact_sample(2, 2, seed=3, device="cpu"))
    assert opt.solver_paths == {2: "kernels"} and not opt.lbfgs_stats and res.success.all(), res.loss


def test_cost_ceiling_is_an_exterior_penalty():
    """With a ceiling on the circuit cost the solve takes L-BFGS with the
    penalty; CNOT costs 1.0 in conversion-gain units, so a ceiling of 1.2
    still admits it and the solution respects it."""
    cost = lambda q: (abs(q[..., 0]) + abs(q[..., 1])) / (np.pi / 2)  # noqa: E731
    ansatz = build_ansatz_v2(_tcg, n_gate_params=2, k=1, gate_bounds=BOUNDS, gate_cost_fn=cost)
    opt = _opt(ansatz, training_restarts=6, max_iters=200, constraint_max_cost=1.2)
    res = opt.approximate_target_U(gates.CNOT.to_numpy())
    assert opt.solver_paths == {1: "lbfgs"} and res.success.all(), res.loss
    assert float(ansatz.circuit_cost(res.params[0])) <= 1.2 + 1e-6


def test_training_history_includes_lm_phase():
    """use_callback records both phases: Adam (B, R, iters) and the f64 LM
    polish (B, lm_iters), where convergence happens."""
    opt = _opt(_basis(gates.SQISWAP), spanning_range=[3], training_restarts=2, use_callback=True)
    opt.approximate_from_distribution(haar_sample(2, seed=1))
    assert opt.training_history and opt.training_history_lm
    adam, lm = opt.training_history[0], opt.training_history_lm[0]
    assert adam.shape == (2, 2, 100) and lm.shape == (2, 6)
    assert (lm.min(axis=1) < 1e-12).all()
    assert opt.coordinate_list[0].shape == (2, 3) and len(opt.training_loss) == 1


def test_multichunk_dispatch():
    """Chunking (B > chunk_size, a short last chunk, no padding) is invisible
    in the results: the starts are drawn for the whole batch."""
    targets = haar_exact_sample(2, 20, seed=11, device="cpu")  # all reachable at k=2
    kw = dict(spanning_range=[2], training_restarts=3, seed=7)
    res_chunked = _opt(_basis(gates.SQISWAP), chunk_size=8, **kw).approximate_from_distribution(targets)  # 8 + 8 + 4
    res_single = _opt(_basis(gates.SQISWAP), **kw).approximate_from_distribution(targets)
    np.testing.assert_allclose(res_chunked.loss, res_single.loss, atol=1e-12)
    assert (res_chunked.cycles == res_single.cycles).all()
    assert (res_chunked.success == res_single.success).all()
    assert res_chunked.success.mean() > 0.5


def test_result_does_not_depend_on_the_seed_of_another_run():
    """The starts come from a generator seeded by ``seed`` alone."""
    kw = dict(spanning_range=[2], training_restarts=2)
    T = haar_exact_sample(2, 4, seed=1, device="cpu")
    a = _opt(_basis(gates.SQISWAP), seed=3, **kw).approximate_from_distribution(T)
    _opt(_basis(gates.SQISWAP), seed=9, **kw).approximate_from_distribution(T)
    b = _opt(_basis(gates.SQISWAP), seed=3, **kw).approximate_from_distribution(T)
    np.testing.assert_array_equal(a.params, b.params)
