"""The gate zoo (JAX models/gates.py): ``Gate`` with its cost model, the
fixed 2Q and 3Q gates, ``riswap``/``SQISWAP``, ``canonical``/``berkeley``,
``fsim``/``syc``, ``conversion_gain_gate`` with its named instances and
canonical forms, and ``custom_cost_gate``. The gates built from the smush,
fsim and circulator Hamiltonians wait for those Hamiltonians.

A gate's matrix is built on the host in complex128; the conversion-gain
propagator is ``models.hamiltonians.conversion_gain_u``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

from slam_decomposition_torch.models.hamiltonians import conversion_gain_u
from slam_decomposition_torch.ops.weyl import MAGIC, V_SIGNS

HALF_PI = np.pi / 2.0

@dataclasses.dataclass(frozen=True)
class Gate:
    """Immutable gate: ``str(gate)`` is its name, which is also the key of
    its cached coverage set."""

    name: str
    n_qubits: int
    params: Tuple[float, ...]
    _matrix_fn: Callable[..., np.ndarray]
    _cost_fn: Optional[Callable[..., float]] = None
    duration_override: Optional[float] = None

    def to_numpy(self) -> np.ndarray:
        """The gate's matrix, complex128 numpy."""
        return np.asarray(self._matrix_fn(*self.params), dtype=np.complex128)

    def cost(self) -> float:
        if self._cost_fn is None:
            return 1.0
        return float(self._cost_fn(*self.params))

    @property
    def duration(self) -> float:
        if self.duration_override is not None:
            return self.duration_override
        return self.cost()

    def fidelity(self, base: float = 0.999) -> float:
        """1 - (1 - base) * cost, floored at 0."""
        return max(1.0 - (1.0 - base) * self.cost(), 0.0)

    def __str__(self) -> str:
        return self.name


def _const_gate(name, n_qubits, arr) -> Gate:
    arr = np.asarray(arr, dtype=complex)
    return Gate(name=name, n_qubits=n_qubits, params=(), _matrix_fn=lambda: arr)


CNOT = _const_gate("cx", 2, [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]])
CZ = _const_gate("cz", 2, np.diag([1, 1, 1, -1]))
SWAP = _const_gate("swap", 2, [[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
ISWAP = _const_gate("iswap", 2, [[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]])
IDENTITY2 = _const_gate("id2", 2, np.eye(4))


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


def canonical(c1: float, c2: float, c3: float, name: str = "can") -> Gate:
    """CAN(c1, c2, c3) = expm(i (c1 XX + c2 YY + c3 ZZ)), inputs in radians,
    from its diagonal form in the magic basis (ops/weyl.py)."""

    def fn(a, b, c):
        return (MAGIC * np.exp(1j * (V_SIGNS @ np.array([a, b, c])))[None, :]) @ MAGIC.conj().T

    return Gate(name=f"{name}({c1:.6f},{c2:.6f},{c3:.6f})", n_qubits=2, params=(c1, c2, c3), _matrix_fn=fn)


def berkeley() -> Gate:
    """B gate = CAN(pi/4, pi/8, 0)."""
    return dataclasses.replace(canonical(np.pi / 4, np.pi / 8, 0.0, name="B"), name="B")


def fsim(theta: float, phi: float) -> Gate:
    """FSim(theta, phi)."""

    def fn(th, ph):
        c, s = np.cos(th), np.sin(th)
        return np.array([[1, 0, 0, 0], [0, c, -1j * s, 0], [0, -1j * s, c, 0], [0, 0, 0, np.exp(1j * ph)]])

    return Gate(name=f"fsim({theta:.4f},{phi:.4f})", n_qubits=2, params=(theta, phi), _matrix_fn=fn)


def syc() -> Gate:
    """Sycamore = FSim(pi/2, pi/6)."""
    return dataclasses.replace(fsim(np.pi / 2, np.pi / 6), name="SYC")


def _cg_cost(p1, p2, g1, g2, t):
    return (abs(g1) + abs(g2)) * t / HALF_PI


def cg_hash(g1: float, g2: float, t: float) -> str:
    """Content hash used as the coverage-cache key."""
    return f"2QGate({g1:.8f}, {g2:.8f}, {t:.8f})"


def conversion_gain_gate(p1: float, p2: float, g1: float, g2: float, t: float = 1.0) -> Gate:
    """Phased conversion+gain evolution; params (phi_c, phi_g, gc, gg, t)."""

    def fn(p1_, p2_, g1_, g2_, t_):
        return conversion_gain_u(g1_, g2_, phi_c=p1_, phi_g=p2_, t=t_).numpy()

    return Gate(
        name=cg_hash(g1, g2, t),
        n_qubits=2,
        params=(p1, p2, g1, g2, t),
        _matrix_fn=fn,
        _cost_fn=_cg_cost,
    )


def cg_sqiswap() -> Gate:
    return conversion_gain_gate(0, 0, np.pi / 2, 0, 0.5)


def cg_normalize_duration(gate: Gate, new_duration: float) -> Gate:
    """Rescale the g terms so that t becomes new_duration; the unitary and
    the cost stay."""
    p1, p2, g1, g2, t = gate.params
    scale = t / new_duration
    return conversion_gain_gate(p1, p2, g1 * scale, g2 * scale, new_duration)


def cg_canonicalize(gate: Gate) -> Gate:
    """Order gc < gg and normalize the duration to 1: the form that keys
    coverage sets."""
    p1, p2, g1, g2, t = gate.params
    if g1 > g2:
        g1, g2 = g2, g1
    return cg_normalize_duration(conversion_gain_gate(p1, p2, g1, g2, t), 1.0)


def cg_iswap(t=1.0) -> Gate:
    return conversion_gain_gate(0, 0, np.pi / 2, 0, t)


def cg_cnot(t=1.0) -> Gate:
    return conversion_gain_gate(0, 0, np.pi / 4, np.pi / 4, t)


def cg_sqcnot() -> Gate:
    return conversion_gain_gate(0, 0, np.pi / 4, np.pi / 4, 0.5)


def cg_b(t=1.0) -> Gate:
    return conversion_gain_gate(0, 0, 3 * np.pi / 8, np.pi / 8, t)


def cg_sqb() -> Gate:
    return conversion_gain_gate(0, 0, 3 * np.pi / 8, np.pi / 8, 0.5)


# ----------------------------------------------------------------- 3Q gates

CPARITY_SWAP = _const_gate("cpswap", 3, np.eye(8)[[0, 4, 1, 6, 2, 3, 5, 7]])
MARGOLUS = _const_gate(
    "margolus", 3, np.diag([1.0, 1, 1, 1, 1, -1, 1, 1]) @ np.eye(8)[:, [0, 1, 2, 3, 4, 5, 7, 6]]
)
CCZ = _const_gate("ccz", 3, np.diag([1, 1, 1, 1, 1, 1, 1, -1]))
_ccix = np.eye(8, dtype=complex)
_ccix[6, 6] = _ccix[7, 7] = 0
_ccix[6, 7] = _ccix[7, 6] = 1j
CCIX = _const_gate("ccix", 3, _ccix)
_ciswap = np.eye(8, dtype=complex)
_ciswap[5, 5] = _ciswap[6, 6] = 0
_ciswap[5, 6] = _ciswap[6, 5] = 1j
CISWAP = _const_gate("ciswap", 3, _ciswap)
PERES = _const_gate("peres", 3, np.eye(8)[:, [0, 1, 2, 3, 7, 6, 5, 4]])


def custom_cost_gate(unitary, name: str, cost: float = 1.0, duration: float = 1.0, n_qubits: int = 2) -> Gate:
    """Wrap an arbitrary unitary with a cost and a duration."""
    arr = np.asarray(unitary, dtype=complex)
    return Gate(
        name=name, n_qubits=n_qubits, params=(), _matrix_fn=lambda: arr,
        _cost_fn=lambda: cost, duration_override=duration,
    )
