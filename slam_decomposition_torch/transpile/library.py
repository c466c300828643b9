"""Benchmark circuit generators (JAX transpile/library.py, unchanged; reference
src/slam/utils/circuit_suite.py). Seeded generators draw from numpy's
default_rng exactly as the JAX package does, so a seed builds the same
circuit in both packages.

Nine families at size q, qiskit-free, on the local IR: QV, VQE(Linear),
VQE(Full), QFT, QAOA, CDKM ripple-carry adder, RGQFT multiplier, GHZ, HLF.
Each returns a transpile.ir.Circuit of <=2Q ops (3Q prims pre-unrolled).
"""

from __future__ import annotations

import numpy as np

from slam_decomposition_torch.transpile.ir import Circuit, _ccx_into
from slam_decomposition_torch.opt.samplers import haar_sample


def qv(q: int, seed=None) -> Circuit:
    """Quantum Volume: q layers of Haar 4x4s on a random pairing
    (circuit_suite.py:40-43)."""
    rng = np.random.default_rng(seed)
    c = Circuit(q)
    for layer in range(q):
        perm = rng.permutation(q)
        us = haar_sample(q // 2, seed=int(rng.integers(0, 2**31)))
        for i in range(q // 2):
            c.unitary(us[i], (int(perm[2 * i]), int(perm[2 * i + 1])), name="qv2q")
    return c


def _su2_layer(c: Circuit, q: int, rng):
    for i in range(q):
        c.ry(rng.uniform(0, 2 * np.pi), i)
        c.rz(rng.uniform(0, 2 * np.pi), i)


def vqe_linear(q: int, reps: int = 2, seed=None) -> Circuit:
    """EfficientSU2 with linear entanglement, randomized params
    (circuit_suite.py:13-23)."""
    rng = np.random.default_rng(seed)
    c = Circuit(q)
    _su2_layer(c, q, rng)
    for _ in range(reps):
        for i in range(q - 1):
            c.cx(i, i + 1)
        _su2_layer(c, q, rng)
    return c


def vqe_full(q: int, reps: int = 3, seed=None) -> Circuit:
    """EfficientSU2 with all-to-all entanglement (circuit_suite.py:26-33;
    reps defaults to 3 = qiskit EfficientSU2's default, which the reference
    implicitly used by not passing reps)."""
    rng = np.random.default_rng(seed)
    c = Circuit(q)
    _su2_layer(c, q, rng)
    for _ in range(reps):
        for i in range(q):
            for j in range(i + 1, q):
                c.cx(i, j)
        _su2_layer(c, q, rng)
    return c


def qft(q: int) -> Circuit:
    """Standard QFT with controlled phases + final swaps
    (circuit_suite.py:50-53)."""
    c = Circuit(q)
    for i in range(q):
        c.h(i)
        for j in range(i + 1, q):
            c.cp(np.pi / (2 ** (j - i)), j, i)
    for i in range(q // 2):
        c.swap(i, q - 1 - i)
    return c


def qaoa(q: int, reps: int = 1, p_edge: float = 0.5, seed=None) -> Circuit:
    """QAOA on a random G(q, 0.5) graph: rzz cost layers + rx mixer
    (circuit_suite.py:60-79)."""
    rng = np.random.default_rng(seed)
    edges = [
        (i, j)
        for i in range(q)
        for j in range(i + 1, q)
        if rng.random() < p_edge
    ]
    c = Circuit(q)
    for i in range(q):
        c.h(i)
    for _ in range(reps):
        for (i, j) in edges:
            c.rzz(2 * rng.random(), i, j)
        for i in range(q):
            c.rx(rng.random(), i)
    return c


def adder(q: int) -> Circuit:
    """CDKM ripple-carry adder on q qubits (two (q-1)/2-bit registers +
    carry), MAJ/UMA ladder unrolled to 1Q/2Q (circuit_suite.py:88-99)."""
    if q % 2 != 0:
        raise ValueError("q must be even")
    n = (q - 1) // 2
    a = list(range(n))  # register a
    b = list(range(n, 2 * n))  # register b
    cin = 2 * n  # carry qubit
    c = Circuit(q)

    def maj(x, y, z):
        c.cx(z, y)
        c.cx(z, x)
        _ccx_into(c, x, y, z)

    def uma(x, y, z):
        _ccx_into(c, x, y, z)
        c.cx(z, x)
        c.cx(x, y)

    maj(cin, b[0], a[0])
    for i in range(1, n):
        maj(a[i - 1], b[i], a[i])
    for i in range(n - 1, 0, -1):
        uma(a[i - 1], b[i], a[i])
    uma(cin, b[0], a[0])
    return c


def multiplier(q: int) -> Circuit:
    """RGQFT-style multiplier: QFT on the output register, doubly-controlled
    phase ladder, inverse QFT (circuit_suite.py:106-117). Controlled-
    controlled phases unroll to cp/cx pairs."""
    if q % 4 != 0:
        raise ValueError("q must be divisible by 4")
    n = q // 4
    a = list(range(n))
    b = list(range(n, 2 * n))
    out = list(range(2 * n, 4 * n))
    m = len(out)
    c = Circuit(q)
    # QFT on out
    for i in range(m):
        c.h(out[i])
        for j in range(i + 1, m):
            c.cp(np.pi / (2 ** (j - i)), out[j], out[i])
    # ccphase(theta, a_i, b_j, out_k) = cp(t/2 on pair) ladder
    for i in range(n):
        for j in range(n):
            for k in range(m):
                theta = 2 * np.pi * (2 ** (i + j)) / (2 ** (m - k))
                theta = np.mod(theta, 2 * np.pi)
                if abs(theta) < 1e-12:
                    continue
                # controlled-controlled-phase via 3 cp + 2 cx
                c.cp(theta / 2, b[j], out[k])
                c.cx(a[i], b[j])
                c.cp(-theta / 2, b[j], out[k])
                c.cx(a[i], b[j])
                c.cp(theta / 2, a[i], out[k])
    # inverse QFT on out
    for i in range(m - 1, -1, -1):
        for j in range(m - 1, i, -1):
            c.cp(-np.pi / (2 ** (j - i)), out[j], out[i])
        c.h(out[i])
    return c


def ghz(q: int) -> Circuit:
    """GHZ ladder (circuit_suite.py:122-128)."""
    c = Circuit(q)
    c.h(0)
    for i in range(1, q):
        c.cx(0, i)
    return c


def hlf(q: int, seed=None) -> Circuit:
    """Hidden Linear Function on a random symmetric adjacency matrix
    (circuit_suite.py:135-144)."""
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, 2, size=(q, q))
    adj = np.where(adj + adj.T > 0, 1, 0)
    c = Circuit(q)
    for i in range(q):
        c.h(i)
    for i in range(q):
        for j in range(i + 1, q):
            if adj[i, j]:
                c.cz(i, j)
    for i in range(q):
        if adj[i, i]:
            c.s(i)
    for i in range(q):
        c.h(i)
    return c


BENCHMARK_CIRCUITS = {
    "QV": qv,
    "VQE(Linear)": vqe_linear,
    "VQE(Full)": vqe_full,
    "QFT": qft,
    "QAOA": qaoa,
    "Adder": adder,
    "Multiplier": multiplier,
    "GHZ": ghz,
    "HLF": hlf,
}
