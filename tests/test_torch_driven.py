"""The port's driven (Trotter) building blocks on the CPU against the JAX
package on the same numpy inputs: the matrix exponentials, every
Hamiltonian and propagator, the smush products, the state evolution, the
gates built from them, and positive_canonical_to_monodromy. Tolerance
1e-12 (both evaluate the same f64 arithmetic; the slice products and the
Horner steps associate alike)."""

import numpy as np
import pytest
import scipy.linalg
import torch

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.models import hamiltonians as jham
from slam_decomposition_tpu.ops import cplx as jcplx
from slam_decomposition_tpu.ops import expm as jexpm
from slam_decomposition_tpu.ops import weyl as jweyl

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.ops import expm
from slam_decomposition_torch.ops import weyl

TOL = 1e-12


def _np(x):
    if isinstance(x, tuple):
        return jcplx.to_numpy(x)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b).max()
    assert err <= tol, err


def _hermitian(rng, d, scale):
    A = rng.normal(size=(d, d)) + 1j * rng.normal(size=(d, d))
    H = A + A.conj().T
    return H * (scale / np.linalg.norm(H, 2))


# the largest slice norm the driven path reaches: a smush slice of the
# extended-coverage sampler at drive bound 4 pi (gc + gg <= pi / 2, drives
# +-4 pi on both qubits, dt = 1/4): ||dt H|| <= (pi/2 + 2 * 4 pi) / 4 ~ 6.7
def _largest_slice_h():
    H = ham.smush_h(0.0, 0.0, np.pi / 4, np.pi / 4, 4 * np.pi, 4 * np.pi).numpy() * 0.25
    return H


def test_largest_slice_norm():
    n = np.linalg.norm(_largest_slice_h(), 2)
    assert 6.0 < n < 7.5, n


@pytest.mark.parametrize("d,scale", [(4, 0.3), (4, 3.0), (8, 3.0), (4, "slice")])
def test_expm_skew_and_eigh_against_jax_and_scipy(d, scale):
    rng = np.random.default_rng(d + 7)
    H = _largest_slice_h() if scale == "slice" else _hermitian(rng, d, scale)
    want = scipy.linalg.expm(-1j * 0.9 * H)
    Ht = torch.as_tensor(H)
    for U in (expm.expm_skew(Ht, 0.9), expm.expm_eigh(Ht, 0.9)):
        _close(U, want, 1e-12)
    _close(expm.expm_skew(Ht, 0.9), jexpm.expm_skew(jcplx.from_numpy(H), 0.9))
    _close(expm.expm_eigh(Ht, 0.9), jexpm.expm_eigh(jcplx.from_numpy(H), 0.9), 1e-11)
    # a batch, with t broadcast against it
    Hs = np.stack([H, 0.5 * H])
    _close(expm.expm_skew(torch.as_tensor(Hs), 0.9), np.stack([want, scipy.linalg.expm(-0.45j * H)]))


def _params(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(-np.pi, np.pi, 4), rng.uniform(-4 * np.pi, 4 * np.pi, (2, n))


def test_smush_h_against_jax():
    (pc, pg, gc, gg), (gx, gy) = _params(1, 1)
    _close(ham.smush_h(pc, pg, gc, gg, gx[0], gy[0]), jham.smush_h(pc, pg, gc, gg, gx[0], gy[0]))


@pytest.mark.parametrize("n", [4, 40])  # 40: the JAX package's lax.scan branch
def test_smush_u_against_jax(n):
    (pc, pg, gc, gg), (gx, gy) = _params(n, n)
    _close(ham.smush_u(pc, pg, gc, gg, gx, gy, t=0.7), jham.smush_u(pc, pg, gc, gg, gx, gy, t=0.7))


def test_smush_u_batched_over_lanes():
    rng = np.random.default_rng(3)
    x = rng.uniform(-3, 3, (5, 10))
    U = ham.smush_u(torch.as_tensor(x[:, 0]), torch.as_tensor(x[:, 1]), 0.5, 0.25, torch.as_tensor(x[:, 2:6]),
                    torch.as_tensor(x[:, 6:]))
    want = np.stack([_np(jham.smush_u(r[0], r[1], 0.5, 0.25, r[2:6], r[6:])) for r in x])
    _close(U, want)


def test_smush_1q_phase_u_against_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(-2, 2, 8)
    gx, gy = rng.uniform(-3, 3, (2, 7))
    _close(ham.smush_1q_phase_u(*a, gx, gy, t=0.9), jham.smush_1q_phase_u(*a, gx, gy, t=0.9))


def test_evolve_smush_and_populations_against_jax():
    (pc, pg, gc, gg), (gx, gy) = _params(5, 12)
    psi = np.array([0.6, 0.8j, 0.0, 0.0])
    states = ham.evolve_smush(pc, pg, gc, gg, gx, gy, torch.as_tensor(psi), t=1.3)
    jstates = jham.evolve_smush(pc, pg, gc, gg, gx, gy, jcplx.from_numpy(psi), t=1.3)
    _close(states, jstates)
    _close(ham.populations(states), jham.populations(jstates))
    # evolve_piecewise on its own: the last state is the product applied
    Hs = ham.smush_h(pc, pg, gc, gg, torch.as_tensor(gx), torch.as_tensor(gy))
    _close(ham.evolve_piecewise(Hs, torch.as_tensor(psi), 1.3 / 12)[-1],
           ham.smush_u(pc, pg, gc, gg, gx, gy, t=1.3).numpy() @ psi)


@pytest.mark.parametrize("name", ["fsim", "circulator", "delta", "conversion_gain"])
def test_hamiltonians_and_propagators_against_jax(name):
    rng = np.random.default_rng(len(name))
    n_args = {"fsim": 2, "circulator": 6, "delta": 12, "conversion_gain": 4}[name]
    p = rng.uniform(-2, 2, n_args)
    if name == "fsim":
        pairs = [(ham.fsim_h(*p), jham.fsim_h(*p)), (ham.fsim_u(*p, t=0.8), jham.fsim_u(*p, t=0.8))]
    elif name == "circulator":
        pairs = [(ham.circulator_h(*p), jham.circulator_h(*p)), (ham.circulator_u(*p, t=0.8), jham.circulator_u(*p, t=0.8))]
    elif name == "delta":
        pairs = [
            (ham.delta_conversion_gain_h(*p), jham.delta_conversion_gain_h(*p)),
            (ham.delta_conversion_gain_u(*p, t=0.8), jham.delta_conversion_gain_u(*p, t=0.8)),
        ]
    else:
        pairs = [(ham.conversion_gain_h(*p), jham.conversion_gain_h(*p)), (ham.conversion_gain_u(*p, t=0.8), jham.conversion_gain_u(*p, t=0.8))]
    for got, want in pairs:
        _close(got, want)
    U = _np(pairs[-1][0])
    np.testing.assert_allclose(U @ U.conj().T, np.eye(U.shape[0]), atol=1e-12)


def test_generator_constants_equal_jax():
    for name in ("K_CONV", "K_GAIN", "K_X", "K_Y", "K_Z1", "K_Z2", "K_AB", "K_AC", "K_BC", "K_AB_G", "K_AC_G",
                 "K_BC_G", "K_HOP", "K_ZZ"):
        np.testing.assert_array_equal(getattr(ham, name), getattr(jham, name))


GATE_CASES = {
    "fsim_hamiltonian_gate": lambda m: m.fsim_hamiltonian_gate(0.7, -1.3, 0.8),
    "smush_gate": lambda m: m.smush_gate(0.3, 0.1, np.pi / 2, 0.2, [1.0, -2.0, 0.5], [0.3, 0.0, 3.0], 0.9),
    "circulator_snail_gate": lambda m: m.circulator_snail_gate(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7),
    "vswap": lambda m: m.vswap(),
    "delta_swap": lambda m: m.delta_swap(0.5),
}


@pytest.mark.parametrize("name", sorted(GATE_CASES))
def test_driven_gates_against_jax(name):
    g, jg = GATE_CASES[name](gates), GATE_CASES[name](jgates)
    assert (str(g), g.n_qubits, g.params) == (str(jg), jg.n_qubits, jg.params)
    assert abs(g.cost() - jg.cost()) <= 1e-15
    _close(g.to_numpy(), jg.to_numpy())


def test_positive_canonical_to_monodromy_against_jax():
    c = np.random.default_rng(9).uniform(0, 1, (50, 3)) * [1.0, 0.5, 0.5]
    _close(weyl.positive_canonical_to_monodromy(c), np.asarray(jweyl.positive_canonical_to_monodromy(c)))
