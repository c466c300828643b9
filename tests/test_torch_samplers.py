"""The port's samplers against the JAX package's (host numpy in both, so a
seed gives the same unitaries bit for bit), and the analytic sqiSwap count
against the full synthesis (CPU)."""

import numpy as np
import pytest

from slam_decomposition_tpu.models import gates as jgates
from slam_decomposition_tpu.opt import samplers as js
from slam_decomposition_tpu.transpile import library as jlibrary

from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.opt import samplers as ts
from slam_decomposition_torch.transpile import library
from slam_decomposition_torch.transpile.kak import sqiswap_decompose
from torch_threads import one_torch_thread  # noqa: F401  (torch on one intra-op thread)


def test_haar_sample_batched_unitary():
    U = ts.haar_sample(17, seed=0)
    assert U.shape == (17, 4, 4)
    eye = np.broadcast_to(np.eye(4), (17, 4, 4))
    assert np.abs(np.conj(np.swapaxes(U, 1, 2)) @ U - eye).max() < 1e-12
    assert np.array_equal(U, ts.haar_sample(17, seed=0))  # the same seed reproduces
    assert np.array_equal(U, js.haar_sample(17, seed=0))
    assert np.array_equal(ts.haar_sample(3, n_qubits=3, seed=1), js.haar_sample(3, n_qubits=3, seed=1))


def test_sqiswap_count_batch_matches_synthesis():
    Us = list(ts.haar_sample(40, seed=7))
    Us += [
        np.eye(4), G.SQISWAP.to_numpy(), G.ISWAP.to_numpy(), G.CNOT.to_numpy(), G.SWAP.to_numpy(),
        G.berkeley().to_numpy(), G.canonical(0.3, 0.2, 0.1).to_numpy(),
    ]
    Us = np.stack(Us)
    batch = ts.sqiswap_count_batch(Us, device="cpu")
    serial = np.array([sqiswap_decompose(U)[1] for U in Us])
    np.testing.assert_array_equal(batch, serial)
    np.testing.assert_array_equal(batch, js.sqiswap_count_batch(Us))
    # single-matrix auto-promotion
    assert ts.sqiswap_count_batch(G.SWAP.to_numpy(), device="cpu") == serial[-3]


@pytest.mark.parametrize("n_uses,n", [(2, 200), (3, 100)])
def test_haar_exact_sample_batched(n_uses, n):
    U = ts.haar_exact_sample(n_uses, n, seed=3, device="cpu")
    assert U.shape == (n, 4, 4)
    assert (ts.sqiswap_count_batch(U, device="cpu") == n_uses).all()
    assert np.array_equal(U, js.haar_exact_sample(n_uses, n, seed=3))
    # spot-check a few against the full synthesis count
    for i in range(0, n, max(1, n // 5)):
        assert sqiswap_decompose(U[i])[1] == n_uses


def test_haar_exact_sample_budget():
    with pytest.raises(RuntimeError):
        ts.haar_exact_sample(1, 5, seed=0, max_tries=256, device="cpu")  # a class of measure zero


def test_symplectic_index_bijection_small_n():
    """The Koenig-Smolin index map hits every element of Sp(2n, GF(2))
    exactly once for n=1 (6) and n=2 (720), and every output preserves
    the symplectic form."""
    assert (ts.sp_group_order(1), ts.sp_group_order(2)) == (6, 720)
    assert ts.sp_group_order(3) == js.sp_group_order(3)
    for n in (1, 2):
        seen = set()
        for i in range(ts.sp_group_order(n)):
            g = ts.symplectic_from_index(i, n)
            nn = 2 * n
            for a in range(nn):
                for b in range(a + 1, nn):
                    assert ts._sp_inner(g[a], g[b]) == (1 if a // 2 == b // 2 else 0)
            seen.add(g.tobytes())
        assert len(seen) == ts.sp_group_order(n)
    for i in (0, 17, 1451519):
        np.testing.assert_array_equal(ts.symplectic_from_index(i, 3), js.symplectic_from_index(i, 3))


def test_clifford_unitary_covers_full_group_n1():
    """Symplectic index x all sign patterns builds exactly the enumerated 1Q
    Clifford group (24 elements mod phase), with no duplicates."""

    def canon(U):
        flat = U.reshape(-1)
        idx = int(np.argmax(np.abs(flat) > 1e-9))
        Uc = U * (abs(flat[idx]) / flat[idx])
        return tuple(np.round(Uc.reshape(-1), 6).view(float))

    keys = set()
    for i in range(ts.sp_group_order(1)):
        g = ts.symplectic_from_index(i, 1)
        for s in range(4):
            U = ts.clifford_unitary(g, np.array([s & 1, (s >> 1) & 1]))
            assert np.allclose(U @ U.conj().T, np.eye(2), atol=1e-12)
            keys.add(canon(U))
    assert keys == {canon(U) for U in ts._clifford_group(1)}


@pytest.mark.parametrize("n_qubits", [1, 2, 3])
def test_clifford_sample_matches_jax(n_qubits):
    Us = ts.clifford_sample(6, n_qubits=n_qubits, seed=7)
    d = 2**n_qubits
    assert Us.shape == (6, d, d)
    assert np.array_equal(Us, js.clifford_sample(6, n_qubits=n_qubits, seed=7))
    assert np.array_equal(ts.clifford_sample_any(2, n_qubits, seed=1), js.clifford_sample_any(2, n_qubits, seed=1))


def test_clifford_sample_3q():
    """n >= 3 sampling: unitary, and conjugates single-qubit Paulis to
    signed Paulis (the defining Clifford property)."""
    Us = ts.clifford_sample(6, n_qubits=3, seed=7)
    probes = [
        np.array([1, 0, 0, 0, 0, 0]),  # X_0
        np.array([0, 1, 0, 0, 0, 0]),  # Z_0
        np.array([0, 0, 1, 1, 0, 0]),  # Y_1 (up to phase)
        np.array([0, 0, 0, 0, 1, 1]),  # Y_2
    ]
    for U in Us:
        assert np.allclose(U @ U.conj().T, np.eye(8), atol=1e-12)
        for v in probes:
            a = np.abs(U @ ts._pauli_matrix(v, 0) @ U.conj().T)
            nz = a[a > 1e-9]
            assert np.allclose(nz, 1.0, atol=1e-9)
            assert len(nz) == 8  # exactly one nonzero entry per row and column


def test_gate_and_circuit_samples_match_jax():
    got = ts.gate_sample(G.berkeley(), 3)
    assert got.shape == (3, 4, 4) and got.flags.writeable
    np.testing.assert_allclose(got, js.gate_sample(jgates.berkeley(), 3), atol=1e-15)
    blocks = ts.circuit_sample(library.qft(4))
    want = js.circuit_sample(jlibrary.qft(4))
    assert blocks.shape == want.shape and blocks.shape[1:] == (4, 4)
    np.testing.assert_allclose(blocks, want, atol=1e-12)
