"""The port's parallel-drive trajectories, pulse solvers and explorer on the
CPU (models/trajectory.py, utils/playground.py), against the JAX package
on the same numpy inputs: prefix products at 1e-12, coordinates at 1e-9,
the golden two-pulse SWAP, and the driven solves at the JAX package's own
small budget from the same starts. The full solves (``improved_cx``, the
two-pulse SWAP) run on the card in chip_smoke.py; ``improved_cx`` also
runs here under the ``slow`` marker."""

import json
import pathlib

import matplotlib

matplotlib.use("Agg")

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import hamiltonians as jham
from slam_decomposition_tpu.models import trajectory as jtraj
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.opt import costs as jcosts
from slam_decomposition_tpu.opt.gauss_newton import make_solver as jmake_solver

from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.models import trajectory as traj
from slam_decomposition_torch.models.gates import CNOT, SWAP
from slam_decomposition_torch.ops import su2, weyl
from slam_decomposition_torch.opt import costs
from slam_decomposition_torch.opt.gauss_newton import ChainSolver, GeneralSolver, make_solver
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.utils.playground import ParallelDriveExplorer

CPU = "cpu"
ARTIFACT = pathlib.Path(__file__).resolve().parents[1] / "slam_decomposition_tpu" / "data" / "improved_swap_2pulse.json"


def _infidelity(target, U):
    return 1.0 - abs(np.trace(target.conj().T @ U)) / 4.0


def _pulse(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, 2), rng.uniform(-4.0, 4.0, (2, n))


@pytest.mark.parametrize("n", [1, 33])
def test_prefix_unitaries_against_jax(n):
    (pc, pg), (gx, gy) = _pulse(n, n)
    got = traj.smush_prefix_unitaries(pc, pg, np.pi / 2, 0.2, gx, gy, t=0.8, device=CPU).numpy()
    want = jcplx.to_numpy(jtraj.smush_prefix_unitaries(pc, pg, np.pi / 2, 0.2, gx, gy, t=0.8))
    assert np.abs(got - want).max() <= 1e-12
    # the last prefix is the whole pulse
    assert np.abs(got[-1] - ham.smush_u(pc, pg, np.pi / 2, 0.2, gx, gy, t=0.8).numpy()).max() <= 1e-12
    # per-slice durations
    dts = np.random.default_rng(n).uniform(0.05, 0.2, n)
    got = traj.smush_prefix_unitaries(pc, pg, np.pi / 2, 0.2, gx, gy, dts=dts, device=CPU).numpy()
    want = jcplx.to_numpy(jtraj.smush_prefix_unitaries(pc, pg, np.pi / 2, 0.2, gx, gy, dts=dts))
    assert np.abs(got - want).max() <= 1e-12


def test_prefix_products_equal_the_running_product():
    Us = ham.smush_slices(0.3, 0.1, np.pi / 2, 0.0, torch.linspace(-3, 3, 13), torch.linspace(2, -1, 13))
    run = [Us[0]]
    for i in range(1, 13):
        run.append(Us[i] @ run[-1])
    assert (traj.prefix_products(Us) - torch.stack(run)).abs().max() <= 1e-13


def test_smush_trajectory_against_jax():
    (pc, pg), (gx, gy) = _pulse(3, 20)
    got = traj.smush_trajectory(pc, pg, np.pi / 2, 0.1, gx, gy, device=CPU)
    want = jtraj.smush_trajectory(pc, pg, np.pi / 2, 0.1, gx, gy)
    assert got.shape == (20, 3) and np.abs(got - want).max() <= 1e-9


def test_constant_drive_reaches_cnot_class():
    """A constant gx ~ 3 drive riding the iSwap coupler lands on the CNOT
    local-equivalence class."""
    U = ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, torch.full((10,), 3.0, dtype=torch.float64), torch.zeros(10))
    c = weyl.c1c2c3(U[None]).numpy()[0]
    assert abs(c[0] - 0.5) < 1e-6
    assert abs(c[1]) < 0.01 and abs(c[2]) < 0.01


def test_evolve_smush_population_transfer():
    # conversion only: |01> -> |10>, populations cos^2 / sin^2
    n = 32
    psi0 = torch.zeros(4, dtype=torch.complex128)
    psi0[1] = 1.0
    states = ham.evolve_smush(0.0, 0.0, np.pi / 2, 0.0, np.zeros(n), np.zeros(n), psi0)
    pops = ham.populations(states).numpy()
    assert pops.shape == (n + 1, 4)
    np.testing.assert_allclose(pops.sum(axis=1), 1.0, atol=1e-12)
    np.testing.assert_allclose(pops[0], [0, 1, 0, 0], atol=1e-12)
    np.testing.assert_allclose(pops[-1], [0, 0, 1, 0], atol=1e-9)
    ts = np.arange(n + 1) / n
    np.testing.assert_allclose(pops[:, 1], np.cos(np.pi / 2 * ts) ** 2, atol=1e-9)
    U = ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, np.zeros(n), np.zeros(n))
    np.testing.assert_allclose(states[-1].numpy(), (U @ psi0).numpy(), atol=1e-9)


def test_improved_swap_two_pulse_golden_artifact():
    """SWAP from two parallel-driven full-iSwap-time pulses: the artifact's
    construction re-evaluated certifies, and equals the JAX package's
    unitary."""
    art = json.loads(ARTIFACT.read_text())
    locs = [np.array([[complex(re, im) for re, im in row] for row in L]) for L in art["locals"]]
    args = (art["params"], art["plan"], art["gc"], art["gg"], art["n_slices"], locs)
    U = traj.evaluate_drive_sequence(*args, device=CPU)
    assert _infidelity(SWAP.to_numpy(), U) < 1e-10
    assert art["certified_loss"] < 1e-10
    assert np.abs(U - jtraj.evaluate_drive_sequence(*args)).max() <= 1e-12
    core = traj.evaluate_drive_sequence(*args[:5], device=CPU)
    assert np.abs(core - jtraj.evaluate_drive_sequence(*args[:5])).max() <= 1e-12


def _smush_eval_pair(n_slices=4):
    def jeval(x):
        return jham.smush_u(x[0], x[1], 0.5, 0.25, x[2 : 2 + n_slices], x[2 + n_slices :], t=1.0)

    def teval(x):
        return ham.smush_u(x[..., 0], x[..., 1], 0.5, 0.25, x[..., 2 : 2 + n_slices], x[..., 2 + n_slices :], t=1.0)

    return jeval, teval, 2 + 2 * n_slices


def test_driven_solver_matches_jax_at_its_small_budget():
    """tests/test_optimizer.py's driven case (B = 3, R = 4, adam 37, lm32 2,
    lm 2) from the same starts: GeneralSolver against the JAX solver, costs
    at 1e-5 (f32 Adam and ranking LM in both)."""
    jeval, teval, n = _smush_eval_pair()
    B, R = 3, 4
    T = haar_sample(B, seed=3)
    x0 = np.random.default_rng(0).uniform(0, 2 * np.pi, (B, R, n))
    it = dict(adam_iters=37, lm32_iters=2, lm_iters=2)
    _, fj = jax.jit(jmake_solver(jeval, n, **it))(jnp.asarray(x0), jcplx.from_numpy(T))
    solver = make_solver(teval, n, device=CPU, **it)
    assert isinstance(solver, GeneralSolver)
    _, ft = solver.solve(torch.as_tensor(x0), torch.as_tensor(T))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-5)


def test_makhlin_class_fit_matches_jax_at_the_same_budget():
    """The class fit the pulse solvers run (Makhlin residual, ranked and
    certified by the Makhlin functional) with the same 37 Adam steps and
    its own 16 + 16 LM iterations, on CNOT (out of one application's reach
    at these couplings) and a target the pulse reaches: the cost of every
    lane that converges in the JAX package agrees to 1e-10, and the port's
    x lies on the class (restarts tie at rounding level, so x is not
    compared)."""
    jeval, teval, n = _smush_eval_pair(n_slices=2)  # 2 slices: half the JAX compile
    rng = np.random.default_rng(5)
    T = np.stack([CNOT.to_numpy(), jcplx.to_numpy(jeval(jnp.asarray(rng.uniform(-2, 2, n))))])
    x0 = rng.uniform(0, 2 * np.pi, (2, 4, n))
    it = dict(adam_iters=37, lm32_iters=16, lm_iters=16, residual="makhlin")
    _, fj = jax.jit(jmake_solver(jeval, n, final_cost_fn=jcosts.makhlin_functional_cost, **it))(
        jnp.asarray(x0), jcplx.from_numpy(T)
    )
    fj = np.asarray(fj)
    xt, ft = make_solver(teval, n, final_cost_fn=costs.makhlin_functional_cost, device=CPU, **it).solve(
        torch.as_tensor(x0), torch.as_tensor(T)
    )
    conv = fj <= 1e-10
    assert conv.any(), fj
    assert (np.abs(ft.numpy() - fj)[conv] <= 1e-10).all(), (ft, fj)
    g = weyl.g1g2g3(teval(xt)) - weyl.g1g2g3(torch.as_tensor(T))
    assert (g.abs().amax(-1).numpy()[conv] <= 1e-5).all()


def test_improved_swap_exact_certifies():
    """The exact 3-segment SWAP takes the chain kernels' path (their plain
    versions on the CPU), certifies, and its locals rebuild SWAP."""
    p, loss, (A1, B1, A2, B2) = traj.improved_swap(exact=True, restarts=8, device=CPU)
    assert loss < 1e-10
    ns, per = 4, 10
    U = ham.smush_u(p[0], p[1], np.pi / 2, 0.0, p[2:6], p[6:10], t=0.5)
    for j in (1, 2):
        q = torch.as_tensor(p[3 * per + (j - 1) * 6 : 3 * per + j * 6])
        L = torch.kron(su2.u3(q[0], q[1], q[2]), su2.u3(q[3], q[4], q[5]))
        pp = p[j * per : (j + 1) * per]
        U = ham.smush_u(pp[0], pp[1], np.pi / 2, 0.0, pp[2 : 2 + ns], pp[2 + ns :], t=0.5) @ (L @ U)
    Uf = np.kron(A2, B2) @ U.numpy() @ np.kron(A1, B1)
    assert 1 - (abs(np.trace(SWAP.to_numpy().conj().T @ Uf)) ** 2 + 4) / 20 < 1e-10
    for W in (A1, B1, A2, B2):
        np.testing.assert_allclose(W @ W.conj().T, np.eye(2), atol=1e-9)


def test_improved_swap_exact_routes_to_the_chain_solver(monkeypatch):
    seen = []
    real = ChainSolver.solve

    def spy(self, x0s, tgt):
        seen.append((self.k, tuple(x0s.shape)))
        return real(self, x0s, tgt)

    monkeypatch.setattr(ChainSolver, "__call__", spy)
    traj.improved_swap(exact=True, restarts=4, device=CPU)
    assert seen == [(3, (1, 4, 24))]


def test_drive_pulse_exact_mode_returns_params_and_loss(monkeypatch):
    """mode="exact" fits the pulse alone (Adam 400, LM 12): here with the
    counts cut, to check its plumbing against a reachable target."""
    _, teval, n = _smush_eval_pair()
    import slam_decomposition_torch.opt.gauss_newton as gn

    real = gn.make_solver
    monkeypatch.setattr(gn, "make_solver", lambda *a, **k: real(*a, **{**k, "adam_iters": 20, "lm_iters": 2}))
    x, loss = traj.drive_pulse_for_target(CNOT.to_numpy(), np.pi / 2, 0.0, restarts=2, mode="exact", device=CPU)
    assert x.shape == (n,) and np.isfinite(loss)


@pytest.mark.slow
def test_improved_cx_certifies():
    """The full parallel-driven CX solve (~10 s on the CPU): certified, and
    the returned locals rebuild CNOT within trace infidelity 1e-10."""
    x, loss, locs = traj.improved_cx(device=CPU)
    U = traj.evaluate_drive_sequence(x, [1.0], np.pi / 2, 0.0, 4, locs, device=CPU)
    assert loss <= 1e-10 and _infidelity(CNOT.to_numpy(), U) <= 1e-10


# ---------------------------------------------------------------- explorer


def test_explorer_update_shapes_and_chamber_bounds():
    ex = ParallelDriveExplorer(N=4, R=3, t=0.8, device=CPU)
    segs = ex.update(q0=0.7, q1=0.3)
    assert segs.shape == (4, 3, 3)
    assert (segs[..., 0] <= 0.5 + 1e-9).all() and np.isfinite(segs).all()
    assert ex.final_unitary.shape == (4, 4)
    np.testing.assert_allclose(ex.final_unitary @ ex.final_unitary.conj().T, np.eye(4), atol=1e-9)
    # the JAX explorer's segments at the same setting
    from slam_decomposition_tpu.utils.playground import ParallelDriveExplorer as JExplorer

    jex = JExplorer(N=4, R=3, t=0.8)
    assert np.abs(jex.update(q0=0.7, q1=0.3) - segs).max() <= 1e-9


def test_explorer_update_rejects_unknown_params():
    ex = ParallelDriveExplorer(N=2, R=2, device=CPU)
    with pytest.raises(TypeError):
        ex.update(bogus=1.0)


def test_explorer_compose_concatenates_trajectories():
    a = ParallelDriveExplorer(N=3, R=2, device=CPU)
    b = ParallelDriveExplorer(N=2, R=2, device=CPU)
    a.update(q0=0.5)
    b.update(q1=0.4)
    both = a.compose(b)
    assert both.shape == (5, 2, 3)
    np.testing.assert_allclose(both[:3], a.coordinate_list, atol=1e-12)


def test_explorer_plot_and_headless_interact_guard():
    ex = ParallelDriveExplorer(N=2, R=2, device=CPU)
    w = ex.plot()
    assert w.ax is not None
    with pytest.raises(RuntimeError, match="headless"):
        ex.interact()


def test_improved_cx_trajectory_shapes(monkeypatch):
    """The solved pulse's path (here a stand-in solution: the solve itself
    is test_improved_cx_certifies) and the two-application baseline."""
    from slam_decomposition_torch.utils import playground

    x = np.linspace(-1.0, 1.0, 10)
    monkeypatch.setattr(traj, "improved_cx", lambda **kw: (x, 1e-14, None))
    segs, baseline, loss = playground.improved_cx_trajectory(n_slices=4, R=3, device=CPU)
    assert segs.shape == (4, 3, 3) and baseline.shape == (2, 25, 3) and loss == 1e-14
    want = traj.smush_trajectory(x[0], x[1], np.pi / 2, 0.0, np.repeat(x[2:6], 3), np.repeat(x[6:], 3), device=CPU)
    want[:, 0] = np.minimum(want[:, 0], 1 - want[:, 0])
    assert np.abs(segs.reshape(-1, 3) - want).max() <= 1e-12
