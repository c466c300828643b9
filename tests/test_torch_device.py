"""The port's entry points run on the card unless the caller asks for the
CPU: called without ``device`` where torch sees no CUDA device, each one
raises instead of returning a CPU result. Each test decides inside itself
whether there is a card, so every pytest worker collects the same tests."""

import numpy as np
import pytest
import torch

from slam_decomposition_torch.config import resolve_device
from slam_decomposition_torch.coverage.coverage import (
    circuit_to_polytope,
    gate_set_to_coverage,
    load_coverage,
    monodromy_ks_batch,
    monodromy_ranges_batch,
    monodromy_reps_float,
    weyl_coords_float,
)
from slam_decomposition_torch.coverage.haar import haar_monodromy_samples
from slam_decomposition_torch.coverage.mixed import MixedOrderBasisTemplate
from slam_decomposition_torch.explore import smush_volume
from slam_decomposition_torch.explore.oct import make_smush_eval
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models import trajectory
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops.kak_batch import make_analytic_init
from slam_decomposition_torch.opt.gauss_newton import ChainSolver, GeneralSolver, make_analytic_solver, make_solver
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_exact_sample, haar_sample, sqiswap_count_batch
from slam_decomposition_torch.pipeline import decompose_haar
from slam_decomposition_torch.transpile import library
from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch
from slam_decomposition_torch.transpile.consolidate import block_coordinate_counts
from slam_decomposition_torch.tools import certify_frontier
from slam_decomposition_torch.transpile import passes
from slam_decomposition_torch.transpile.passes import pass_manager_basic
from slam_decomposition_torch.utils.playground import ParallelDriveExplorer
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

U = haar_sample(4, seed=3)
ANSATZ = build_ansatz(cycle_gates([gates.SQISWAP], 2))
CHAIN = ANSATZ.chain_gates
ENTRY_POINTS = {
    "decompose_haar": lambda: decompose_haar(B=8, chunk=8, restarts=1),
    "make_solver": lambda: make_solver(ANSATZ.eval_fn, ANSATZ.n_params),
    "make_solver(eval_fn, kernel path)": lambda: make_solver(ANSATZ.eval_fn, ANSATZ.n_params, chain_gates=CHAIN),
    "make_solver(eval_fn, general path)": lambda: make_solver(ANSATZ.eval_fn, ANSATZ.n_params, residual="makhlin"),
    "ChainSolver": lambda: ChainSolver(CHAIN),
    "GeneralSolver": lambda: GeneralSolver(ANSATZ.eval_fn, ANSATZ.n_params),
    "TemplateOptimizer": lambda: TemplateOptimizer(ANSATZ),
    "haar_exact_sample": lambda: haar_exact_sample(2, 4, seed=0),
    "make_analytic_solver": lambda: make_analytic_solver(2),
    "make_analytic_init": lambda: make_analytic_init(2),
    "sqiswap_decompose_batch": lambda: sqiswap_decompose_batch(U),
    "pass_manager_basic": lambda: pass_manager_basic(library.qft(3), "sqiswap", 0.25, batched=False),
    "block_coordinate_counts": lambda: block_coordinate_counts(library.qft(3)),
    "sqiswap_count_batch(numpy)": lambda: sqiswap_count_batch(U),
    "monodromy_ks_batch(numpy)": lambda: monodromy_ks_batch(load_coverage(gates.cg_sqiswap()), U),
    "monodromy_ranges_batch(numpy)": lambda: monodromy_ranges_batch(load_coverage(gates.cg_sqiswap()), U),
    "monodromy_reps_float(numpy)": lambda: monodromy_reps_float(U),
    "weyl_coords_float(numpy)": lambda: weyl_coords_float(U),
    "gate_set_to_coverage(a build)": lambda: gate_set_to_coverage(gates.CNOT, use_cache=False),
    "circuit_to_polytope": lambda: circuit_to_polytope([gates.CNOT]),
    "haar_monodromy_samples": lambda: haar_monodromy_samples(8, seed=0),
    "MixedOrderBasisTemplate.cost_from_distribution": lambda: MixedOrderBasisTemplate([gates.cg_sqiswap()]).cost_from_distribution(U),
    "smush_prefix_unitaries": lambda: trajectory.smush_prefix_unitaries(0, 0, 1.0, 0, [1.0, 2.0], [0.0, 1.0]),
    "smush_trajectory": lambda: trajectory.smush_trajectory(0, 0, 1.0, 0, [1.0, 2.0], [0.0, 1.0]),
    "drive_pulse_for_target": lambda: trajectory.drive_pulse_for_target(U[0], 1.0, 0.0, restarts=1),
    "improved_cx": lambda: trajectory.improved_cx(restarts=1),
    "improved_swap(exact)": lambda: trajectory.improved_swap(exact=True, restarts=1),
    "improved_swap_two_pulse": lambda: trajectory.improved_swap_two_pulse(restarts=1),
    "evaluate_drive_sequence": lambda: trajectory.evaluate_drive_sequence(np.zeros(10), [1.0], 1.0, 0.0, 4),
    "make_smush_eval": lambda: make_smush_eval(1.0, 0.0, 4),
    "sample_smush_coords": lambda: smush_volume.sample_smush_coords(1.0, 0.0, 1.0, 1, n_samples=3),
    "targeted_smush_coords": lambda: smush_volume.targeted_smush_coords(1.0, 0.0, 1.0, 1, restarts=1, iters=1),
    "extend_coverage": lambda: smush_volume.extend_coverage("B", save=False),
    "ParallelDriveExplorer": lambda: ParallelDriveExplorer(N=2, R=2),
    "pass_manager_optimized_sqiswap(fit_1q)": lambda: passes.pass_manager_optimized_sqiswap(
        library.qft(3), 0.25, fit_1q=True),
    "fit_substituted_pd": lambda: passes.fit_substituted_pd([], {}, {}),
    "frontier_targets": lambda: certify_frontier.frontier_targets("B", 1, 2),
    "certify_row": lambda: certify_frontier.certify_row("B", 1, 2, restarts=1),
}


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_defaults_to_the_card(no_card, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[name]()


def test_tensor_input_keeps_its_device(no_card):
    # device=None means the tensor's own device: a CPU tensor stays on the CPU
    T = torch.as_tensor(U)
    assert np.array_equal(sqiswap_count_batch(T), sqiswap_count_batch(U, device="cpu"))
    cov = load_coverage(gates.cg_sqiswap())
    assert np.array_equal(monodromy_ks_batch(cov, T), monodromy_ks_batch(cov, U, device="cpu"))
    assert resolve_device("cpu") == torch.device("cpu")
