"""The port's utilities (utils/profiling.device_trace, utils/visualize.py)
on the CPU, and its examples (examples/torch_*.py) each run once in a
subprocess with ``--device cpu``.

The plots are checked by their data on the Agg backend, not their pixels:
the Weyl coordinates against the JAX package's, the coverage hulls'
vertices against the JAX coverage set's."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from slam_decomposition_tpu.coverage.coverage import gate_set_to_coverage as jgate_set_to_coverage
from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import weyl as jweyl

from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.utils import visualize as vz
from slam_decomposition_torch.utils.profiling import device_trace
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    import matplotlib.pyplot as plt

    plt.close("all")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with device_trace(tmp_path) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert path.parent == tmp_path and path.exists()
    events = json.loads(path.read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_plot_matrix_writes_each_phase():
    U = gates.CNOT.to_numpy() * np.exp(0.3j)
    ax = vz.plot_matrix(U)
    assert [t.get_text() for t in ax.texts] == ["0.30"] * 4
    np.testing.assert_array_equal(ax.images[0].get_array(), np.abs(U))


def _offsets(w):
    return np.asarray(w.ax.collections[-1]._offsets3d).T


def test_unitary_to_weyl_coordinates_equal_jax():
    us = [gates.CNOT.to_numpy(), gates.ISWAP.to_numpy(), gates.SQISWAP.to_numpy()]
    want = np.asarray(jweyl.c1c2c3(jcplx.from_numpy(np.stack(us))))
    np.testing.assert_allclose(_offsets(vz.unitary_to_weyl(*us)), want, atol=1e-12)


def test_optimizer_training_plot_draws_each_segment():
    fig = vz.optimizer_training_plot([[1.0, 0.1, 0.0], [0.5, 1e-20]], title="t")
    assert len(fig.axes[0].lines) == 2 and fig.axes[0].get_title() == "t"
    np.testing.assert_array_equal(fig.axes[0].lines[0].get_ydata(), [1.0, 0.1, 1e-16])
    traj = [[[0.1, 0.0, 0.0], [0.2, 0.1, 0.0]]]
    fig = vz.optimizer_training_plot([[1.0]], coordinate_trajectories=traj)
    assert len(fig.axes) == 2
    assert len(fig.axes[1].lines) == len(vz.WeylChamberAxes.EDGES) + 1


def test_coordinate_lists_and_their_update():
    a, b = np.array([[0.1, 0.0, 0.0], [0.3, 0.1, 0.0]]), np.array([[0.5, 0.5, 0.0]])
    w = vz.coordinate_2dlist_weyl(a, [], b, colors=["r", "b"])
    assert len(w.ax.collections) == 2
    np.testing.assert_allclose(_offsets(w), b)
    w2 = vz.update_coordinate_2dlist_weyl(w, b, a)
    assert w2 is w and len(w.ax.collections) == 2 and len(w.ax.lines) == len(vz.WeylChamberAxes.EDGES)
    np.testing.assert_allclose(_offsets(w), a)


def test_plot_hamiltonian_sweep_labels_each_cell():
    m = np.array([[0.123, 0.5], [0.25, 1.0]])
    labels = [[(0.1, 1.0), (0.1, 2.0)], [(0.2, 1.0), (0.2, 2.0)]]
    fig = vz.plot_hamiltonian_sweep(m, labels=labels)
    ax = fig.axes[0]
    assert [t.get_text() for t in ax.texts] == ["0.12", "0.5", "0.25", "1.0"]
    assert [t.get_text() for t in ax.get_xticklabels()] == ["1.0", "2.0"]
    assert [t.get_text() for t in ax.get_yticklabels()] == ["0.1", "0.2"]


def test_plot_coverage_set_hulls_the_jax_vertices():
    """The first two sqiSwap layers: the hull points are the JAX coverage
    set's vertices, mapped to positive canonical coordinates."""
    cov = [cp for cp in gate_set_to_coverage(gates.cg_sqiswap(), device="cpu") if cp.cost > 0][:2]
    jcov = [cp for cp in jgate_set_to_coverage(jgates.cg_sqiswap()) if cp.cost > 0][:2]
    for cp, jcp in zip(cov, jcov):
        want = [[float(v[0] + v[1]), float(v[0] + v[2]), float(v[1] + v[2])]
                for sub in jcp.polytope.convex_subpolytopes for v in sub.vertices()]
        got = vz.coverage_hull_points(cp)
        np.testing.assert_allclose(sorted(got.tolist()), sorted(want), atol=1e-15)
    w = vz.plot_coverage_set(cov)
    assert len(w.ax.lines) > len(vz.WeylChamberAxes.EDGES)


def test_plot_candidate_scores_colors_by_the_metric():
    params = [(0, 0, 0.1, 0.2, 1), (0, 0, 0.3, 0.4, 1)]
    scores = [(1.5, 2.0, 3.0), (1.2, 2.5, 3.5)]
    ax = vz.plot_candidate_scores(params, scores, metric=1)
    sc = ax.collections[0]
    np.testing.assert_allclose(sc.get_offsets(), [[0.1, 0.2], [0.3, 0.4]])
    np.testing.assert_allclose(sc.get_array(), [2.0, 2.5])


SLOW = pytest.mark.slow  # several seconds of solves on the CPU
EXAMPLES = [
    pytest.param("torch_01_synthesis", "k counts:", marks=SLOW),
    pytest.param("torch_02_coverage", "E[Haar] cost: 2.2098826363"),
    pytest.param("torch_04_parallel_drive", "SWAP via 2 driven iSwap pulses", marks=SLOW),
    pytest.param("torch_05_hopper_kernels", "launches:", marks=SLOW),
    pytest.param("torch_06_three_qubit", "W-state monotones", marks=SLOW),
    pytest.param("torch_07_optimal_control", "pop(|01>) along pulse"),
    pytest.param("torch_08_full_pipeline", "certified 16/16", marks=SLOW),
]


@pytest.mark.parametrize("name, expect", EXAMPLES)
def test_example_runs_on_the_cpu(name, expect):
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # one intra-op thread beside the other test workers
    proc = subprocess.run([sys.executable, str(ROOT / "examples" / f"{name}.py"), "--device", "cpu"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert expect in proc.stdout
