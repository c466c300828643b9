"""Parity of the port's router (transpile/route.py, host numpy) with the JAX
package's: the same generators and seeds give the same routed op lists and
layouts, and a routed circuit equals its source up to the tracked layout
permutations."""

import numpy as np
import pytest

from slam_decomposition_tpu.transpile import library as jlibrary
from slam_decomposition_tpu.transpile import route as jroute

from slam_decomposition_torch.transpile import library
from slam_decomposition_torch.transpile import route

GENS = {
    "qv": lambda lib, s: lib.qv(9, seed=s),
    "vqe_linear": lambda lib, s: lib.vqe_linear(9, seed=s),
    "vqe_full": lambda lib, s: lib.vqe_full(9, seed=s),
    "qft": lambda lib, s: lib.qft(9),
}


def _same_ops(a, b):
    assert a.n_qubits == b.n_qubits and len(a.ops) == len(b.ops)
    for x, y in zip(a.ops, b.ops):
        assert (x.name, x.qubits, x.params, x.duration) == (y.name, y.qubits, y.params, y.duration)
        assert (x.matrix is None) == (y.matrix is None)
        if x.matrix is not None:
            np.testing.assert_array_equal(x.matrix, y.matrix)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", list(GENS))
def test_route_matches_jax(name, seed):
    edges = route.grid_coupling(3, 3)
    assert edges == jroute.grid_coupling(3, 3)
    got, init, final = route.route(GENS[name](library, seed), edges, seed=seed, rows_cols=(3, 3),
                                   return_layouts=True)
    want, jinit, jfinal = jroute.route(GENS[name](jlibrary, seed), edges, seed=seed, rows_cols=(3, 3),
                                       return_layouts=True)
    _same_ops(got, want)
    assert (list(init), list(final)) == (list(jinit), list(jfinal))
    assert route.duration_proxy(got) == jroute.duration_proxy(want)


def test_router_helpers_match_jax():
    assert route.snake_order(3, 4) == jroute.snake_order(3, 4)
    np.testing.assert_array_equal(route._distances(9, route.grid_coupling(3, 3)),
                                  jroute._distances(9, jroute.grid_coupling(3, 3)))
    c, jc = library.qft(5), jlibrary.qft(5)
    _same_ops(route.schedule_for_duration(c), jroute.schedule_for_duration(jc))
    assert route._commute_dag(c.ops) == jroute._commute_dag(jc.ops)
    with pytest.raises(ValueError):
        route.route(library.qft(5), route.grid_coupling(2, 2))


def _perm_matrix(layout):
    """Maps a logical amplitude index to its physical one."""
    n = len(layout)
    P = np.zeros((2**n, 2**n))
    for idx in range(2**n):
        bits = [(idx >> (n - 1 - q)) & 1 for q in range(n)]
        pbits = [0] * n
        for q in range(n):
            pbits[layout[q]] = bits[q]
        P[sum(b << (n - 1 - i) for i, b in enumerate(pbits)), idx] = 1.0
    return P


@pytest.mark.parametrize("seed", range(3))
def test_commutation_aware_routing_preserves_unitary(seed):
    """QFT-4 on a 2x2 grid (tests/test_transpile.py): the routed circuit
    equals the original modulo the initial and final layouts."""
    qft = library.qft(4)
    routed, init, final = route.route(qft, route.grid_coupling(2, 2), seed=seed, rows_cols=(2, 2),
                                      return_layouts=True)
    U_log, U_phys = qft.to_matrix(), routed.to_matrix()
    Pi, Pf = _perm_matrix(init), _perm_matrix(final)
    assert np.abs(np.abs(U_phys @ Pi) - np.abs(Pf @ U_log)).max() < 1e-9
    A = (U_phys @ Pi) @ (Pf @ U_log).conj().T
    assert np.abs(np.abs(np.trace(A)) - 16) < 1e-9
