"""Basis gates, the u3 chain and its square cost, in plain NumPy (f64).

The chain of depth k on n = 6(k + 1) parameters is
U(x) = L_k G ... L_1 G L_0, with L_i = kron(u3(x[6i:6i+3]), u3(x[6i+3:6i+6]))
and u3 in the qiskit convention. Its square cost against a target T is
1 - (|tr(T^dag U)|^2 + 4) / 20, computed here as f / 5 - f^2 / 80 from
f = ||U - e^{i phi} T||_F^2 with phi = arg tr(T^dag U): the same number for
unitary pairs, without the cancellation of 1 - (...) near a certified cost.
"""

from __future__ import annotations

import numpy as np

_CR = np.array([[0.0, 0.0], [1.0, 0.0]])  # raising operator, big-endian order
_A = np.kron(_CR, np.eye(2))
_B = np.kron(np.eye(2), _CR)


def riswap(alpha: float) -> np.ndarray:
    """iSwap^alpha."""
    c, s = np.cos(np.pi * alpha / 2.0), np.sin(np.pi * alpha / 2.0)
    return np.array([[1, 0, 0, 0], [0, c, 1j * s, 0], [0, 1j * s, c, 0], [0, 0, 0, 1]], dtype=complex)


def conversion_gain(phi_c: float, phi_g: float, gc: float, gg: float, t: float) -> np.ndarray:
    """expm(-i t H), H = gc (e^{i phi_c} A B^dag + h.c.) + gg (e^{i phi_g} A B + h.c.),
    by the eigendecomposition of the Hermitian H."""
    conv = np.exp(1j * phi_c) * (_A @ _B.T)
    gain = np.exp(1j * phi_g) * (_A @ _B)
    H = gc * (conv + conv.conj().T) + gg * (gain + gain.conj().T)
    w, V = np.linalg.eigh(H)
    return (V * np.exp(-1j * t * w)[None, :]) @ V.conj().T


def gate(spec: dict) -> np.ndarray:
    """The 4x4 matrix of a configuration's gate entry."""
    kind = spec["gate"]
    if kind == "riswap":
        return riswap(spec["alpha"])
    if kind == "conversion_gain":
        return conversion_gain(spec["phi_c"], spec["phi_g"], spec["gc"], spec["gg"], spec["t"])
    raise ValueError(f"unknown gate kind {kind!r}")


def u3(theta, phi, lam) -> np.ndarray:
    """(..., 2, 2) qiskit U gates."""
    ct, st = np.cos(theta / 2.0), np.sin(theta / 2.0)
    out = np.empty(np.shape(theta) + (2, 2), dtype=complex)
    out[..., 0, 0] = ct
    out[..., 0, 1] = -np.exp(1j * lam) * st
    out[..., 1, 0] = np.exp(1j * phi) * st
    out[..., 1, 1] = np.exp(1j * (phi + lam)) * ct
    return out


def layer(x6: np.ndarray) -> np.ndarray:
    """(..., 6) -> (..., 4, 4): kron(u3(x[0:3]), u3(x[3:6]))."""
    a = u3(x6[..., 0], x6[..., 1], x6[..., 2])
    b = u3(x6[..., 3], x6[..., 4], x6[..., 5])
    return np.einsum("...ab,...cd->...acbd", a, b).reshape(*x6.shape[:-1], 4, 4)


def chain(x: np.ndarray, G: np.ndarray) -> np.ndarray:
    """(m, 6(k+1)) parameters -> (m, 4, 4) chain unitaries with gate G."""
    k = x.shape[-1] // 6 - 1
    U = layer(x[..., 0:6])
    for i in range(1, k + 1):
        U = layer(x[..., 6 * i : 6 * i + 6]) @ (G @ U)
    return U


def square_cost(x: np.ndarray, T: np.ndarray, G: np.ndarray) -> np.ndarray:
    """(m,) square cost of each chain against its target."""
    U = chain(x, G)
    tr = np.einsum("mij,mij->m", T.conj(), U)
    z = tr / np.maximum(np.abs(tr), 1e-300)
    r = U - z[:, None, None] * T
    f = (r.real**2 + r.imag**2).sum(axis=(1, 2))
    return f / 5.0 - f * f / 80.0
