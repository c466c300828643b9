"""Target distributions and sqiSwap counts (the JAX package's
opt/samplers.py).

The samplers are host numpy and return stacked (B, d, d) unitaries;
``haar_sample``, the Clifford samplers and ``gate_sample`` are verbatim
copies of the numpy code, so a seed gives bit-identical targets in both
packages. ``sqiswap_count_batch`` runs its coordinates on the device it is
given, with no padding and no CPU pin, and ``haar_exact_sample`` filters
Haar draws by it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from slam_decomposition_torch.config import device_of
from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.ops.weyl import c1c2c3


def haar_sample(n_samples: int = 1, n_qubits: int = 2, seed: Optional[int] = None):
    """Haar-random U(2^n) via QR of complex Ginibre (sampler.py:62-71).

    Batched: one stacked QR for the whole draw (numpy's qr broadcasts over
    leading dims), no per-sample Python loop.
    """
    rng = np.random.default_rng(seed)
    d = 2**n_qubits
    z = (
        rng.standard_normal((n_samples, d, d))
        + 1j * rng.standard_normal((n_samples, d, d))
    ) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    diag = np.einsum("...ii->...i", r)
    ph = diag / np.abs(diag)
    return q * ph[:, None, :]


_H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
_S = np.diag([1, 1j])
_CNOT = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])
_I2 = np.eye(2)


def _clifford_generators(n_qubits: int):
    gens = []
    if n_qubits == 1:
        return [_H, _S]
    if n_qubits == 2:
        gens = [np.kron(_H, _I2), np.kron(_I2, _H), np.kron(_S, _I2), np.kron(_I2, _S), _CNOT]
        return gens
    raise NotImplementedError


# ---------------------------------------------------------------------------
# exact-uniform Clifford sampling for ANY n (Koenig-Smolin symplectic index)
# ---------------------------------------------------------------------------
# A bijection {0..|Sp(2n,2)|-1} -> Sp(2n, GF(2))
# (Koenig & Smolin, J. Math. Phys. 55, 122202 (2014)) picks the symplectic
# tableau exactly uniformly; 2n sign bits pick the Pauli phases; the
# unitary is built directly from the tableau by stabilizer projection —
# no circuit synthesis step at all. Bit convention: symplectic vectors are
# (x1, z1, x2, z2, ...) with form <v,w> = sum_i v_x[i] w_z[i] + v_z[i] w_x[i].


def _sp_inner(v: np.ndarray, w: np.ndarray) -> int:
    t = 0
    for i in range(len(v) >> 1):
        t ^= int(v[2 * i]) & int(w[2 * i + 1])
        t ^= int(w[2 * i]) & int(v[2 * i + 1])
    return t


def _transvection(k: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (v + _sp_inner(k, v) * k) % 2


def _int2bits(i: int, n: int) -> np.ndarray:
    out = np.zeros(n, dtype=np.int64)
    for j in range(n):
        out[j] = i & 1
        i >>= 1
    return out


def _find_transvection(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """h (2, 2n) with Z_h1 Z_h0 x = y (Koenig-Smolin Lemma 2)."""
    out = np.zeros((2, len(x)), dtype=np.int64)
    if np.array_equal(x, y):
        return out
    if _sp_inner(x, y) == 1:
        out[0] = (x + y) % 2
        return out
    # find a qubit slot where both x and y are nonzero
    z = np.zeros(len(x), dtype=np.int64)
    for i in range(len(x) >> 1):
        ii = 2 * i
        if (x[ii] + x[ii + 1]) != 0 and (y[ii] + y[ii + 1]) != 0:
            z[ii] = (x[ii] + y[ii]) % 2
            z[ii + 1] = (x[ii + 1] + y[ii + 1]) % 2
            if z[ii] + z[ii + 1] == 0:  # same Pauli on this slot
                z[ii + 1] = 1
                if x[ii] != x[ii + 1]:
                    z[ii] = 1
            out[0] = (x + z) % 2
            out[1] = (y + z) % 2
            return out
    # else: one slot where x nonzero / y zero, one where y nonzero / x zero
    for i in range(len(x) >> 1):
        ii = 2 * i
        if (x[ii] + x[ii + 1]) != 0 and (y[ii] + y[ii + 1]) == 0:
            if x[ii] == x[ii + 1]:
                z[ii + 1] = 1
            else:
                z[ii + 1] = x[ii]
                z[ii] = x[ii + 1]
            break
    for i in range(len(x) >> 1):
        ii = 2 * i
        if (x[ii] + x[ii + 1]) == 0 and (y[ii] + y[ii + 1]) != 0:
            if y[ii] == y[ii + 1]:
                z[ii + 1] = 1
            else:
                z[ii + 1] = y[ii]
                z[ii] = y[ii + 1]
            break
    out[0] = (x + z) % 2
    out[1] = (y + z) % 2
    return out


def sp_group_order(n: int) -> int:
    """|Sp(2n, GF(2))| = 2^(n^2) prod_j (4^j - 1)."""
    o = 1 << (n * n)
    for j in range(1, n + 1):
        o *= (1 << (2 * j)) - 1
    return o


def symplectic_from_index(i: int, n: int) -> np.ndarray:
    """The i-th element of Sp(2n, GF(2)) under the Koenig-Smolin bijection
    (rows are images of the basis vectors X1, Z1, X2, Z2, ...)."""
    nn = 2 * n
    s = (1 << nn) - 1
    k = (i % s) + 1
    i //= s
    f1 = _int2bits(k, nn)
    e1 = np.zeros(nn, dtype=np.int64)
    e1[0] = 1
    T = _find_transvection(e1, f1)  # T maps e1 -> f1
    bits = _int2bits(i % (1 << (nn - 1)), nn - 1)
    i //= 1 << (nn - 1)
    eprime = e1.copy()
    for j in range(2, nn):
        eprime[j] = bits[j - 1]
    h0 = _transvection(T[0], eprime)
    h0 = _transvection(T[1], h0)
    if bits[0] == 1:
        f1 = f1 * 0  # zero vector: the f1 transvection becomes a no-op
    if n == 1:
        g = np.eye(2, dtype=np.int64)
    else:
        gsub = symplectic_from_index(i, n - 1)
        g = np.zeros((nn, nn), dtype=np.int64)
        g[:2, :2] = np.eye(2, dtype=np.int64)
        g[2:, 2:] = gsub
    for j in range(nn):
        row = _transvection(T[0], g[j])
        row = _transvection(T[1], row)
        row = _transvection(h0, row)
        row = _transvection(f1, row)
        g[j] = row
    return g


def _pauli_matrix(v: np.ndarray, sign: int) -> np.ndarray:
    """Hermitian Pauli (-1)^sign * i^(x.z) X^x Z^z for the symplectic
    vector v = (x1, z1, x2, z2, ...)."""
    X = np.array([[0, 1], [1, 0]], dtype=complex)
    Z = np.array([[1, 0], [0, -1]], dtype=complex)
    P = np.array([[1.0 + 0j]])
    xz = 0
    for q in range(len(v) >> 1):
        x, z = int(v[2 * q]), int(v[2 * q + 1])
        xz += x & z
        m = np.eye(2, dtype=complex)
        if x:
            m = m @ X
        if z:
            m = m @ Z
        P = np.kron(P, m)
    return ((-1) ** sign) * (1j**xz) * P


def clifford_unitary(g: np.ndarray, signs: np.ndarray) -> np.ndarray:
    """Unitary (2^n, 2^n) of the Clifford with tableau g (rows 2j / 2j+1 =
    symplectic images of X_j / Z_j) and 2n phase bits, via stabilizer
    projection: |psi_0> = C|0> is the +1 eigenvector of the Z-images,
    column x is prod_j (X_j image)^{x_j} |psi_0> (the X-images commute,
    so the product order is irrelevant)."""
    n = len(g) >> 1
    d = 1 << n
    proj = np.eye(d, dtype=complex)
    for j in range(n):
        S = _pauli_matrix(g[2 * j + 1], int(signs[2 * j + 1]))
        proj = proj @ (np.eye(d, dtype=complex) + S) / 2.0
    # rank-1 projector (times a phase-free positive factor): any nonzero
    # column is |psi_0>
    norms = np.linalg.norm(proj, axis=0)
    c = int(np.argmax(norms))
    psi0 = proj[:, c] / norms[c]
    imgX = [_pauli_matrix(g[2 * j], int(signs[2 * j])) for j in range(n)]
    C = np.empty((d, d), dtype=complex)
    for x in range(d):
        col = psi0
        for j in range(n):
            if (x >> (n - 1 - j)) & 1:  # qubit 0 = most significant bit
                col = imgX[j] @ col
        C[:, x] = col
    return C


def clifford_sample_any(
    n_samples: int = 1, n_qubits: int = 3, seed: Optional[int] = None
) -> np.ndarray:
    """Exactly uniform Cliffords (mod global phase) for ANY qubit count:
    uniform symplectic index x uniform sign bits. Ground truth: for
    n <= 2 the construction enumerates EXACTLY the BFS group (tested)."""
    rng = np.random.default_rng(seed)
    order = sp_group_order(n_qubits)
    out = np.empty((n_samples, 1 << n_qubits, 1 << n_qubits), dtype=complex)
    for s in range(n_samples):
        idx = int(rng.integers(0, order))
        signs = rng.integers(0, 2, size=2 * n_qubits)
        out[s] = clifford_unitary(symplectic_from_index(idx, n_qubits), signs)
    return out


_CLIFFORD_CACHE = {}


def _clifford_group(n_qubits: int) -> np.ndarray:
    """The full n-qubit Clifford group modulo global phase, enumerated by
    BFS over {H_i, S_i, CNOT_ij} with phase-canonicalized matrices
    (|C_1| = 24, |C_2| = 11520)."""
    if n_qubits in _CLIFFORD_CACHE:
        return _CLIFFORD_CACHE[n_qubits]
    gens = _clifford_generators(n_qubits)
    d = 2**n_qubits

    def canon(U):
        flat = U.reshape(-1)
        idx = int(np.argmax(np.abs(flat) > 1e-9))
        Uc = U * (abs(flat[idx]) / flat[idx])
        return Uc, tuple(np.round(Uc.reshape(-1), 6).view(float))

    seen = {}
    frontier = [np.eye(d, dtype=complex)]
    Uc, key = canon(frontier[0])
    seen[key] = Uc
    while frontier:
        nxt = []
        for U in frontier:
            for g in gens:
                Uc, key = canon(g @ U)
                if key not in seen:
                    seen[key] = Uc
                    nxt.append(Uc)
        frontier = nxt
    group = np.stack(list(seen.values()))
    expected = {1: 24, 2: 11520}.get(n_qubits)
    if expected is not None and len(group) != expected:
        raise RuntimeError(f"Clifford enumeration found {len(group)} != {expected}")
    _CLIFFORD_CACHE[n_qubits] = group
    return group


def clifford_sample(n_samples: int = 1, n_qubits: int = 2, seed: Optional[int] = None):
    """Exactly uniform random Clifford unitaries (up to global phase).

    n <= 2: draw from the fully enumerated group (24 / 11520 elements);
    n >= 3: Koenig-Smolin symplectic index + sign bits (the same
    distribution, no enumeration)."""
    if n_qubits >= 3:
        return clifford_sample_any(n_samples, n_qubits, seed)
    group = _clifford_group(n_qubits)
    rng = np.random.default_rng(seed)
    return group[rng.integers(0, len(group), size=n_samples)].copy()


def gate_sample(gate: Gate, n_samples: int = 1):
    """Repeat a fixed gate's unitary."""
    U = gate.to_numpy()
    return np.broadcast_to(U, (n_samples, *U.shape)).copy()


COUNT_TOL = 1e-8  # region-test tolerance in chamber units (JAX samplers.py:331)


def sqiswap_count_batch(Us, device=None) -> np.ndarray:
    """Analytic sqiSwap application counts (0/1/2/3) for a batch of U(4)s
    (JAX samplers.py:299-336): one batched f64 c1c2c3 on ``device`` (default:
    the tensor's device, or the card for numpy input), then the Huang et al.
    (arXiv:2105.06074) region test |z| <= x - y in the positive canonical
    cell, after the CNOT-mirror fold c1 > 1/2 -> 1 - c1. Equals the count
    ``transpile.kak.sqiswap_decompose`` emits."""
    device = device_of(Us, device)
    U = torch.as_tensor(Us)
    single = U.ndim == 2
    if single:
        U = U[None]
    c = c1c2c3(U.to(device=device, dtype=torch.complex128)).cpu().numpy()
    fold = c[:, 0] > 0.5
    x = np.where(fold, 1.0 - c[:, 0], c[:, 0])
    y = c[:, 1]
    az = np.abs(c[:, 2])
    tol = COUNT_TOL
    n = np.full(len(c), 3, dtype=np.int64)
    n[az <= x - y + tol] = 2
    n[(np.abs(x - 0.25) < tol) & (np.abs(y - 0.25) < tol) & (az < tol)] = 1
    n[(x < tol) & (y < tol) & (az < tol)] = 0
    return n[0] if single else n


def haar_exact_sample(
    n_uses: int, n_samples: int = 1, seed: Optional[int] = None, max_tries: int = 10_000, device=None
):
    """Haar samples that need exactly ``n_uses`` sqiSwap applications, by the
    analytic count. Each round draws one oversized Haar batch (sized by the
    Haar measure of the count's region: P[2] ~ 0.79, P[3] ~ 0.21), counts it
    in one call on ``device`` (default: the card) and keeps the matches: the
    distribution of a one-at-a-time rejection loop, since a filter commutes
    with i.i.d. draws. ``max_tries`` bounds the total number of draws."""
    rng = np.random.default_rng(seed)
    region_p = {0: 1e-4, 1: 1e-4, 2: 0.79, 3: 0.21}.get(n_uses, 0.25)
    out = []
    drawn = 0
    n_found = 0
    while n_found < n_samples and drawn < max_tries:
        want = n_samples - n_found
        batch = min(max(int(want / region_p * 1.3) + 8, 64), max_tries - drawn)
        U = haar_sample(batch, seed=int(rng.integers(0, 2**31)))
        drawn += batch
        hit = U[sqiswap_count_batch(U, device) == n_uses]
        n_found += len(hit)
        out.append(hit)
    if n_found < n_samples:
        raise RuntimeError(f"could not draw {n_samples} exact-{n_uses} samples")
    return np.concatenate(out)[:n_samples]


def circuit_sample(circuit):
    """All consolidated 2Q block unitaries of a ``transpile.ir.Circuit``."""
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks

    return np.stack([b.unitary for b in consolidate_2q_blocks(circuit)])
