"""The port's templates, 1Q gates, Hamiltonians and gate zoo against the JAX
package's on the same numpy inputs made from a seed (CPU, f64).

A template's ``eval_fn`` is the same chain of the same small products in
both packages, so the two agree to 1e-12 on the same x; parameter counts,
boxes and costs are equal."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import hamiltonians as jham
from slam_decomposition_tpu.models import templates as jt
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import su2 as jsu2
from slam_decomposition_tpu.ops.expm import expm_taylor as jexpm_taylor
from slam_decomposition_tpu.opt.samplers import haar_sample

from slam_decomposition_torch.models import gates as tgates
from slam_decomposition_torch.models import hamiltonians as tham
from slam_decomposition_torch.models import templates as tt
from slam_decomposition_torch.ops import su2 as tsu2
from slam_decomposition_torch.ops.expm import expm_taylor
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)

ATOL = 1e-12


def _jcg(q, dtype):
    return jham.conversion_gain_u(q[0], q[1], t=1.0, dtype=dtype)


def _tcg(q, dtype):
    return tham.conversion_gain_u(q[..., 0], q[..., 1], t=1.0, dtype=dtype)


def _jcg_phased(q, dtype):
    return jham.conversion_gain_u(q[0], q[1], phi_c=q[2], phi_g=q[3], t=0.5, dtype=dtype)


def _tcg_phased(q, dtype):
    return tham.conversion_gain_u(q[..., 0], q[..., 1], phi_c=q[..., 2], phi_g=q[..., 3], t=0.5, dtype=dtype)


def _seq(mod, names):
    return [getattr(mod, n) if isinstance(n, str) else mod.riswap(n) for n in names]


BOUNDS = (np.zeros(2), np.full(2, np.pi / 2))
# name -> make(templates module, gates module, gate_fn, phased gate_fn)
TEMPLATES = {
    "plain_k1": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.CNOT], 1)),
    "plain_k3": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.SQISWAP], 3)),
    "plain_k5": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.SQISWAP], 5)),
    "mixed_order": lambda t, g, cg, cgp: t.build_ansatz(_seq(g, ["CNOT", 0.5, "ISWAP", 0.25])),
    "berkeley_k2": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.berkeley()], 2)),
    "vz_only": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.CNOT], 2), vz_only=True),
    "no_exterior": lambda t, g, cg, cgp: t.build_ansatz(t.cycle_gates([g.CNOT], 3), no_exterior_1q=True),
    "no_exterior_vz": lambda t, g, cg, cgp: t.build_ansatz(
        t.cycle_gates([g.SQISWAP, g.CNOT], 4), no_exterior_1q=True, vz_only=True
    ),
    "3q_edges": lambda t, g, cg, cgp: t.build_ansatz(
        _seq(g, ["CNOT", 0.5, "ISWAP"]), edges=[(0, 1), (1, 2), (0, 2)], n_qubits=3
    ),
    "3q_reversed_edge": lambda t, g, cg, cgp: t.build_ansatz(_seq(g, ["CNOT", "CNOT"]), edges=[(1, 0), (2, 1)], n_qubits=3),
    "3q_no_exterior": lambda t, g, cg, cgp: t.build_ansatz(
        _seq(g, ["CNOT", 0.5]), edges=[(0, 1), (1, 2)], n_qubits=3, no_exterior_1q=True
    ),
    "v2_k1_bounds": lambda t, g, cg, cgp: t.build_ansatz_v2(cg, n_gate_params=2, k=1, gate_bounds=BOUNDS),
    "v2_k2": lambda t, g, cg, cgp: t.build_ansatz_v2(cg, n_gate_params=2, k=2),
    "v2_phased_cost": lambda t, g, cg, cgp: t.build_ansatz_v2(
        cgp, n_gate_params=4, k=2, gate_cost_fn=lambda q: (abs(q[..., 0]) + abs(q[..., 1])) * 0.5 / (np.pi / 2)
    ),
    "v2_no_exterior_vz": lambda t, g, cg, cgp: t.build_ansatz_v2(
        cg, n_gate_params=2, k=3, no_exterior_1q=True, vz_only=True, gate_bounds=BOUNDS
    ),
}


def _both(name):
    return TEMPLATES[name](jt, jgates, _jcg, _jcg_phased), TEMPLATES[name](tt, tgates, _tcg, _tcg_phased)


@pytest.mark.parametrize("name", list(TEMPLATES))
def test_template_matches_jax(name):
    ja, ta = _both(name)
    for field in ("n_qubits", "k", "n_params", "n_params_1q", "use_bounds", "driven", "fixed_cost"):
        assert getattr(ta, field) == getattr(ja, field), field
    np.testing.assert_array_equal(ta.lower, ja.lower)
    np.testing.assert_array_equal(ta.upper, ja.upper)
    assert (ta.chain_gates is None) == (ja.chain_gates is None)
    if ja.chain_gates is not None:
        np.testing.assert_allclose(ta.chain_gates, ja.chain_gates, atol=1e-15)
    x = np.random.default_rng(len(name)).uniform(-np.pi, np.pi, (5, ja.n_params))
    want = jcplx.to_numpy(jax.vmap(ja.eval_fn)(jnp.asarray(x)))
    got = ta.eval_fn(torch.as_tensor(x))
    d = 2**ja.n_qubits
    assert got.shape == (5, d, d)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    # batched by shape, over any leading dimensions
    more = ta.eval_fn(torch.as_tensor(x).reshape(5, 1, -1).expand(5, 2, -1))
    np.testing.assert_allclose(more[:, 1].numpy(), want, atol=ATOL)
    assert (ta.cost_fn is None) == (ja.cost_fn is None)
    if ja.cost_fn is None:
        assert ta.circuit_cost(x[0]) == ja.circuit_cost(x[0]) == ja.fixed_cost
    else:
        np.testing.assert_allclose(
            ta.circuit_cost(x).numpy(), [float(ja.circuit_cost(xi)) for xi in x], atol=ATOL
        )


def test_f32_parameters_stay_f32():
    _, ta = _both("3q_edges")
    assert ta.eval_fn(torch.zeros(ta.n_params, dtype=torch.float32)).dtype == torch.complex64
    # a parameterized template evaluates in its own dtype, as in the JAX package
    _, tv = _both("v2_k2")
    assert tv.eval_fn(torch.zeros(tv.n_params, dtype=torch.float32)).dtype == torch.complex128


def test_vz_only_and_no_exterior_shapes():
    a = tt.build_ansatz(tt.cycle_gates([tgates.CNOT], 2), vz_only=True)
    assert a.n_params == 3 * 2  # 3 layers x 2 qubits x 1 param
    b = tt.build_ansatz(tt.cycle_gates([tgates.CNOT], 3), no_exterior_1q=True)
    assert b.n_params == 2 * 6  # interior layers only
    assert a.chain_gates is None and b.chain_gates is None


def test_hamiltonian_ansatz_matches_jax():
    ja = jt.hamiltonian_ansatz(jham.conversion_gain_u, 5, lower=np.zeros(5), upper=np.full(5, np.pi))
    ta = tt.hamiltonian_ansatz(tham.conversion_gain_u, 5, lower=np.zeros(5), upper=np.full(5, np.pi))
    assert ta.driven and ja.driven and ta.n_params == ja.n_params == 5 and ta.n_params_1q == 0 and ta.k == ja.k
    np.testing.assert_array_equal(ta.upper, ja.upper)
    x = np.random.default_rng(1).uniform(0, np.pi, (4, 5))
    want = jcplx.to_numpy(jax.vmap(ja.eval_fn)(jnp.asarray(x)))
    np.testing.assert_allclose(ta.eval_fn(torch.as_tensor(x)).numpy(), want, atol=ATOL)
    default = tt.hamiltonian_ansatz(tham.snail_effective_u, 2)
    assert default.lower.tolist() == [0, 0] and default.upper.tolist() == [1, 1]


def test_rotations_and_u3_angles_match_jax():
    th = np.random.default_rng(2).uniform(-2 * np.pi, 2 * np.pi, 7)
    for name in ("rz", "rx", "ry"):
        got = getattr(tsu2, name)(torch.as_tensor(th))
        assert got.shape == (7, 2, 2)
        np.testing.assert_allclose(got.numpy(), jcplx.to_numpy(getattr(jsu2, name)(jnp.asarray(th))), atol=1e-15)
        assert getattr(tsu2, name)(torch.as_tensor(th, dtype=torch.float32)).dtype == torch.complex64
    Ws = list(haar_sample(5, n_qubits=1, seed=3)) + [np.eye(2), np.array([[0, 1], [1, 0]]), np.diag([1, 1j])]
    for W in Ws:
        want = jsu2.u3_angles(W)
        got = tsu2.u3_angles(W)
        assert got == pytest.approx(want, abs=1e-15)
        V = tsu2.u3(*(torch.tensor(a, dtype=torch.float64) for a in got)).numpy()
        assert abs(abs(np.trace(V.conj().T @ W)) - 2.0) < 1e-12  # equal up to a global phase


def test_conversion_gain_and_expm_match_jax():
    rng = np.random.default_rng(4)
    gc, gg, pc, pg, t = rng.uniform(0, np.pi / 2, (5, 6))
    H = tham.conversion_gain_h(torch.as_tensor(gc), torch.as_tensor(gg), torch.as_tensor(pc), torch.as_tensor(pg))
    jH = jham.conversion_gain_h(jnp.asarray(gc), jnp.asarray(gg), jnp.asarray(pc), jnp.asarray(pg))
    np.testing.assert_allclose(H.numpy(), jcplx.to_numpy(jH), atol=1e-15)
    U = tham.conversion_gain_u(torch.as_tensor(gc), torch.as_tensor(gg), torch.as_tensor(pc), torch.as_tensor(pg), torch.as_tensor(t))
    jU = jham.conversion_gain_u(jnp.asarray(gc), jnp.asarray(gg), jnp.asarray(pc), jnp.asarray(pg), jnp.asarray(t))
    np.testing.assert_allclose(U.numpy(), jcplx.to_numpy(jU), atol=ATOL)
    np.testing.assert_allclose((U @ U.conj().transpose(-2, -1)).numpy(), np.broadcast_to(np.eye(4), (6, 4, 4)), atol=1e-13)
    # numbers as well as tensors, and the named family
    np.testing.assert_allclose(
        tham.conversion_gain_u(np.pi / 4, np.pi / 4).numpy(), jcplx.to_numpy(jham.conversion_gain_u(np.pi / 4, np.pi / 4)), atol=ATOL
    )
    np.testing.assert_allclose(
        tham.snail_effective_u(torch.as_tensor(gc), t=0.5).numpy(), jcplx.to_numpy(jham.snail_effective_u(jnp.asarray(gc), t=0.5)), atol=ATOL
    )
    A = rng.normal(size=(3, 8, 8)) + 1j * rng.normal(size=(3, 8, 8))
    np.testing.assert_allclose(expm_taylor(torch.as_tensor(A)).numpy(), jcplx.to_numpy(jexpm_taylor(jcplx.from_numpy(A))), rtol=1e-12, atol=ATOL)
    np.testing.assert_allclose(
        expm_taylor(torch.as_tensor(A[:, :4, :4] * 0.3)).numpy(), torch.linalg.matrix_exp(torch.as_tensor(A[:, :4, :4] * 0.3)).numpy(), atol=1e-13
    )


GATES = [
    "CNOT", "CZ", "SWAP", "ISWAP", "IDENTITY2", "SQISWAP", "CPARITY_SWAP", "MARGOLUS", "CCZ", "CCIX", "CISWAP", "PERES",
    ("riswap", 0.3), ("canonical", 0.3, 0.2, 0.1), ("berkeley",), ("fsim", 0.4, 0.7), ("syc",),
    ("conversion_gain_gate", 0.1, 0.2, 0.7, 0.3, 0.8), ("cg_iswap",), ("cg_sqiswap",), ("cg_cnot",), ("cg_sqcnot",),
    ("cg_b",), ("cg_sqb",),
]


@pytest.mark.parametrize("spec", GATES, ids=lambda s: s if isinstance(s, str) else s[0])
def test_gate_zoo_matches_jax(spec):
    make = (lambda m: getattr(m, spec)) if isinstance(spec, str) else (lambda m: getattr(m, spec[0])(*spec[1:]))
    jg, tg = make(jgates), make(tgates)
    assert str(tg) == str(jg) and tg.n_qubits == jg.n_qubits and tg.params == jg.params
    assert tg.cost() == jg.cost() and tg.duration == jg.duration and tg.fidelity() == jg.fidelity()
    np.testing.assert_allclose(tg.to_numpy(), jg.to_numpy(), atol=1e-14)


def test_gate_canonical_forms_and_custom_cost_match_jax():
    jg = jgates.conversion_gain_gate(0.1, 0.2, 0.9, 0.3, 0.5)
    tg = tgates.conversion_gain_gate(0.1, 0.2, 0.9, 0.3, 0.5)
    for fn in ("cg_canonicalize",):
        a, b = getattr(jgates, fn)(jg), getattr(tgates, fn)(tg)
        assert str(a) == str(b) and a.params == b.params and a.cost() == b.cost()
    a, b = jgates.cg_normalize_duration(jg, 2.0), tgates.cg_normalize_duration(tg, 2.0)
    assert a.params == b.params
    np.testing.assert_allclose(b.to_numpy(), tg.to_numpy(), atol=1e-13)  # the unitary stays
    U = haar_sample(1, seed=9)[0]
    a, b = jgates.custom_cost_gate(U, "mine", 1.5, 0.75), tgates.custom_cost_gate(U, "mine", 1.5, 0.75)
    assert (str(b), b.cost(), b.duration) == (str(a), a.cost(), a.duration) == ("mine", 1.5, 0.75)
    np.testing.assert_array_equal(b.to_numpy(), U)
