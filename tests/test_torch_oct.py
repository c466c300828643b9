"""The port's optimal-control pulse shaping (explore/oct.py) on the CPU:
the window, the functionals and the membership test against the JAX
package, GRAPE over 20 iterations from the JAX package's own starts held to
its result at 1e-9, and the JAX tests' properties at their seeds (the port
draws the JAX package's starts, ops/threefry.py)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.explore import oct as joct
from slam_decomposition_tpu.ops import cplx as jcplx

from slam_decomposition_torch.explore.oct import (
    OCTResult,
    _functional,
    flattop,
    hs_cost,
    is_perfect_entangler,
    make_smush_eval,
    optimize_pulses,
    optimize_pulses_from,
    pe_functional,
)
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.opt.samplers import haar_sample
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

CPU = "cpu"


def _u(g):
    return torch.as_tensor(g.to_numpy())


def test_flattop_window():
    w = flattop(64, rise_frac=0.1).numpy()
    assert np.abs(w - np.asarray(joct.flattop(64, rise_frac=0.1))).max() <= 1e-15
    assert w[0] < 0.1 and w[-1] < 0.1
    assert np.isclose(w[28:36], 1.0).all()
    assert (np.diff(w[:6]) > 0).all() and (np.diff(w[-6:]) < 0).all()


PE_IN = ("CNOT", "ISWAP", "SQISWAP", "sqswap", "B")
PE_OUT = ("id", "id2", "SWAP")


def _named(module, name):
    return {
        "sqswap": lambda: module.canonical(np.pi / 8, np.pi / 8, np.pi / 8, "sqswap"),
        "B": module.berkeley,
        "id": lambda: module.canonical(0.0, 0.0, 0.0, "id"),
        "id2": lambda: module.canonical(np.pi / 2, 0.0, 0.0, "id2"),
    }.get(name, lambda: getattr(module, name))()


@pytest.mark.parametrize("name", PE_IN + PE_OUT)
def test_pe_membership_and_functional_against_jax(name):
    U = _named(gates, name).to_numpy()
    pe = bool(is_perfect_entangler(torch.as_tensor(U), tol=1e-7))
    assert pe == (name in PE_IN) == bool(joct.is_perfect_entangler(jcplx.from_numpy(U), tol=1e-7))
    assert abs(float(pe_functional(torch.as_tensor(U))) - float(joct.pe_functional(jcplx.from_numpy(U)))) <= 1e-12


def test_pe_functional_signs():
    assert float(pe_functional(torch.eye(4, dtype=torch.complex128))) > 1.0
    assert float(pe_functional(_u(gates.riswap(0.25)))) > 0.05
    assert abs(float(pe_functional(_u(gates.CNOT)))) < 1e-9
    assert float(pe_functional(_u(gates.berkeley()))) <= 1e-9


def test_hs_cost_zero_at_match_and_phase_aware():
    U = _u(gates.CNOT)
    assert float(hs_cost(U, U)) == 0.0
    V = U * np.exp(0.5j)
    assert float(hs_cost(U, V)) > 1e-3
    assert abs(float(hs_cost(U, V)) - float(joct.hs_cost(jcplx.from_numpy(U.numpy()), jcplx.from_numpy(V.numpy())))) <= 1e-15


def test_make_smush_eval_against_jax():
    p = np.random.default_rng(2).uniform(-1, 1, (2, 16))
    ev = make_smush_eval(np.pi / 2, 0.1, 16, t=0.9, phi_c=0.2, device=CPU)
    jev = joct.make_smush_eval(np.pi / 2, 0.1, 16, t=0.9, phi_c=0.2)
    assert np.abs(ev(torch.as_tensor(p)).numpy() - jcplx.to_numpy(jev(jnp.asarray(p)))).max() <= 1e-12
    # batched over restarts
    P = np.stack([p, -p])
    assert np.abs(ev(torch.as_tensor(P))[1].numpy() - jcplx.to_numpy(jev(jnp.asarray(-p)))).max() <= 1e-12


@pytest.mark.parametrize("kind", ["hs", "square", "li", "pe"])
def test_functionals_against_jax(kind):
    U, T = haar_sample(2, seed=len(kind))
    got = _functional(kind, torch.as_tensor(T))(torch.as_tensor(U))
    want = joct._functional(kind, jcplx.from_numpy(T))(jcplx.from_numpy(U))
    assert abs(float(got) - float(want)) <= 1e-12
    with pytest.raises(ValueError):
        _functional("bogus", torch.as_tensor(T))


def test_optimize_pulses_matches_jax_from_its_starts():
    """20 GRAPE iterations of the perfect-entangler descent (the hinge, the
    amplitude penalty and the membership selection) at the same seed: the
    selected raw pulses, value, history and propagator at 1e-9. The other
    functionals share the recursion and differ only in the functional, held
    above; optimize_pulses_from, the descent from given starts, is the same
    call from the JAX package's draw."""
    gc, n, R, seed = 7 * np.pi / 8, 4, 3, 1
    kw = dict(functional="pe", iters=20, lr=0.2, amp_penalty=0.05)
    jres = joct.optimize_pulses(joct.make_smush_eval(gc, 0.0, n), n, restarts=R, seed=seed, **kw)
    ev = make_smush_eval(gc, 0.0, n, device=CPU)
    res = optimize_pulses(ev, n, restarts=R, seed=seed, **kw)
    p0 = (np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (R, 2, n), dtype=jnp.float64)) * 2.0 - 1.0) * 2.0
    assert np.array_equal(optimize_pulses_from(ev, p0, **kw).raw, res.raw)
    assert isinstance(res, OCTResult) and res.history.shape == (21,)
    for a, b in ((res.raw, jres.raw), (res.pulses, jres.pulses), (res.value, jres.value), (res.history, jres.history)):
        assert np.abs(a - np.asarray(b)).max() <= 1e-9
    assert np.abs(res.U.numpy() - jcplx.to_numpy(jres.U)).max() <= 1e-9


def test_grape_reaches_perfect_entangler():
    n = 16
    ev = make_smush_eval(gc=7 * np.pi / 8, gg=0.0, n_slices=n, device=CPU)
    U0 = ev(torch.zeros((2, n), dtype=torch.float64))
    assert not bool(is_perfect_entangler(U0, tol=1e-6))
    assert float(pe_functional(U0)) > 0.05
    res = optimize_pulses(ev, n, functional="pe", restarts=4, iters=200, lr=0.2, seed=1)
    assert bool(is_perfect_entangler(res.U, tol=1e-6))
    assert float(res.value) <= 1e-3
    assert res.history.shape == (201,)
    np.testing.assert_allclose(res.pulses, res.raw * flattop(n).numpy()[None, :], atol=1e-12)


def test_grape_hits_reachable_gate_target():
    n = 12
    ev = make_smush_eval(gc=np.pi / 4, gg=0.0, n_slices=n, device=CPU)
    p_true = jax.random.uniform(jax.random.PRNGKey(7), (2, n), dtype=jnp.float64) * 2.0 - 1.0
    target = ev(torch.as_tensor(np.array(p_true)))
    res = optimize_pulses(ev, n, functional="square", target=target, restarts=8, iters=400, lr=0.1, seed=3)
    assert float(res.value) < 1e-4
    assert res.history[-1] < res.history[0]


def test_final_adam_update_is_selectable():
    n = 8
    ev = make_smush_eval(gc=np.pi / 4, gg=0.0, n_slices=n, device=CPU)
    target = ev(torch.zeros((2, n), dtype=torch.float64))
    res = optimize_pulses(ev, n, functional="square", target=target, restarts=2, iters=1, lr=0.1, seed=0)
    assert res.history.shape == (2,) and res.raw.shape == (2, n)
    assert res.history[-1] != res.history[0]
    assert float(res.value) == float(res.history[-1])


def test_amp_penalty_shrinks_pulses():
    n = 12
    ev = make_smush_eval(gc=7 * np.pi / 8, gg=0.0, n_slices=n, device=CPU)
    kw = dict(functional="pe", restarts=4, iters=150, lr=0.2, seed=5)
    free = optimize_pulses(ev, n, amp_penalty=0.0, **kw)
    pen = optimize_pulses(ev, n, amp_penalty=0.05, **kw)
    assert float(np.mean(pen.raw**2)) < float(np.mean(free.raw**2))
    assert bool(is_perfect_entangler(pen.U, tol=1e-6))


def test_grape_li_reaches_cnot_class_one_application():
    n = 16
    ev = make_smush_eval(gc=np.pi / 2, gg=0.0, n_slices=n, device=CPU)
    res = optimize_pulses(ev, n, functional="li", target=gates.CNOT.to_numpy(), restarts=8, iters=400, lr=0.15, seed=2)
    assert float(res.value) < 1e-3
    np.testing.assert_allclose(weyl.c1c2c3(res.U).numpy(), [0.5, 0.0, 0.0], atol=0.05)


def test_eval_fn_without_window_is_refused():
    with pytest.raises(ValueError, match="window"):
        optimize_pulses_from(lambda p: p, np.zeros((1, 2, 4)), functional="pe", iters=1)
