"""The 2Q gates the main path needs (JAX models/gates.py:28-72, 94-115,
180-202, 344): ``Gate``, ``riswap``/``SQISWAP``, ``conversion_gain_gate``,
``cg_hash`` and ``cg_sqiswap``.

A gate's matrix is built on the host in complex128. The conversion-gain
propagator is ``expm(-i t H)`` (JAX models/hamiltonians.py:89-94), taken
with ``torch.linalg.matrix_exp`` rather than the JAX package's Taylor
scaling-and-squaring.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

HALF_PI = np.pi / 2.0

# 2Q generators, big-endian qubit order (JAX models/hamiltonians.py:25-40)
_CR = np.array([[0.0, 0.0], [1.0, 0.0]])
_A2 = np.kron(_CR, np.eye(2))
_B2 = np.kron(np.eye(2), _CR)
K_CONV = _A2 @ _B2.T  # A B^dag (conversion)
K_GAIN = _A2 @ _B2  # A B (gain)


@dataclasses.dataclass(frozen=True)
class Gate:
    """Immutable gate: ``str(gate)`` is its name, which is also the key of
    its cached coverage set."""

    name: str
    n_qubits: int
    params: Tuple[float, ...]
    _matrix_fn: Callable[..., np.ndarray]
    _cost_fn: Optional[Callable[..., float]] = None

    def to_numpy(self) -> np.ndarray:
        """The gate's matrix, complex128 numpy."""
        return np.asarray(self._matrix_fn(*self.params), dtype=np.complex128)

    def cost(self) -> float:
        if self._cost_fn is None:
            return 1.0
        return float(self._cost_fn(*self.params))

    def __str__(self) -> str:
        return self.name


def riswap(alpha: float) -> Gate:
    """iSwap^alpha; cost = alpha."""

    def fn(a):
        c = np.cos(np.pi * a / 2.0)
        s = np.sin(np.pi * a / 2.0)
        return np.array(
            [[1, 0, 0, 0], [0, c, 1j * s, 0], [0, 1j * s, c, 0], [0, 0, 0, 1]]
        )

    return Gate(
        name=f"riswap({alpha})",
        n_qubits=2,
        params=(alpha,),
        _matrix_fn=fn,
        _cost_fn=lambda a: float(a),
    )


SQISWAP = riswap(0.5)


def _phased(K: np.ndarray, g: float, phi: float) -> np.ndarray:
    """g (e^{i phi} K + e^{-i phi} K^dag) for a real generator K."""
    return g * (np.exp(1j * phi) * K + np.exp(-1j * phi) * K.T)


def conversion_gain_u(gc, gg, phi_c=0.0, phi_g=0.0, t=1.0) -> np.ndarray:
    """U = expm(-i t H), H = gc (e^{i phi_c} A B^dag + h.c.) + gg (e^{i phi_g} A B + h.c.)."""
    H = _phased(K_CONV, gc, phi_c) + _phased(K_GAIN, gg, phi_g)
    A = torch.as_tensor(-1j * t * H, dtype=torch.complex128)
    return torch.linalg.matrix_exp(A).numpy()


def _cg_cost(p1, p2, g1, g2, t):
    return (abs(g1) + abs(g2)) * t / HALF_PI


def cg_hash(g1: float, g2: float, t: float) -> str:
    """Content hash used as the coverage-cache key."""
    return f"2QGate({g1:.8f}, {g2:.8f}, {t:.8f})"


def conversion_gain_gate(p1: float, p2: float, g1: float, g2: float, t: float = 1.0) -> Gate:
    """Phased conversion+gain evolution; params (phi_c, phi_g, gc, gg, t)."""

    def fn(p1_, p2_, g1_, g2_, t_):
        return conversion_gain_u(g1_, g2_, phi_c=p1_, phi_g=p2_, t=t_)

    return Gate(
        name=cg_hash(g1, g2, t),
        n_qubits=2,
        params=(p1, p2, g1, g2, t),
        _matrix_fn=fn,
        _cost_fn=_cg_cost,
    )


def cg_sqiswap() -> Gate:
    return conversion_gain_gate(0, 0, np.pi / 2, 0, 0.5)
