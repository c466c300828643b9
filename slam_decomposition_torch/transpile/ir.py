"""Minimal circuit IR (JAX transpile/ir.py, host numpy, unchanged).

Circuits are a flat list of ops over numpy matrices — enough for the
transpilation flows (consolidate -> synthesize -> analyze) while batched
math runs as torch on the device. Big-endian qubit order (qubit 0 = first
tensor factor) throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

_H = np.array([[1, 1], [1, -1]]) / np.sqrt(2)
_X = np.array([[0.0, 1], [1, 0]])
_Y = np.array([[0, -1j], [1j, 0]])
_Z = np.diag([1.0, -1])
_S = np.diag([1, 1j])
_T = np.diag([1, np.exp(1j * np.pi / 4)])
_ID = np.eye(2)


def _rx(t):
    return np.array(
        [[np.cos(t / 2), -1j * np.sin(t / 2)], [-1j * np.sin(t / 2), np.cos(t / 2)]]
    )


def _ry(t):
    return np.array(
        [[np.cos(t / 2), -np.sin(t / 2)], [np.sin(t / 2), np.cos(t / 2)]]
    )


def _rz(t):
    return np.diag([np.exp(-1j * t / 2), np.exp(1j * t / 2)])


def _u3(theta, phi, lam):
    c, s = np.cos(theta / 2), np.sin(theta / 2)
    return np.array(
        [
            [c, -np.exp(1j * lam) * s],
            [np.exp(1j * phi) * s, np.exp(1j * (phi + lam)) * c],
        ]
    )


_CX = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex)
_CZ = np.diag([1, 1, 1, -1]).astype(complex)
_SWAP = np.array([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=complex)
_ISWAP = np.array([[1, 0, 0, 0], [0, 0, 1j, 0], [0, 1j, 0, 0], [0, 0, 0, 1]])


def _cp(t):
    return np.diag([1, 1, 1, np.exp(1j * t)])


def _rzz(t):
    return np.diag(
        [np.exp(-1j * t / 2), np.exp(1j * t / 2), np.exp(1j * t / 2), np.exp(-1j * t / 2)]
    )


def _riswap(alpha):
    h = alpha / 2
    c, s = np.cos(np.pi * h), np.sin(np.pi * h)
    return np.array(
        [[1, 0, 0, 0], [0, c, 1j * s, 0], [0, 1j * s, c, 0], [0, 0, 0, 1]]
    )


_MATRIX_FNS = {
    "h": lambda: _H, "x": lambda: _X, "y": lambda: _Y, "z": lambda: _Z,
    "s": lambda: _S, "sdg": lambda: _S.conj(), "t": lambda: _T,
    "tdg": lambda: _T.conj(), "id": lambda: _ID,
    "rx": _rx, "ry": _ry, "rz": _rz, "u": _u3, "p": lambda t: np.diag([1, np.exp(1j * t)]),
    "cx": lambda: _CX, "cz": lambda: _CZ, "swap": lambda: _SWAP,
    "iswap": lambda: _ISWAP, "cp": _cp, "rzz": _rzz, "riswap": _riswap,
}


@dataclasses.dataclass
class Op:
    name: str
    qubits: Tuple[int, ...]
    params: Tuple[float, ...] = ()
    matrix: Optional[np.ndarray] = None  # explicit unitary overrides name
    duration: Optional[float] = None

    @property
    def n_qubits(self) -> int:
        return len(self.qubits)

    def to_matrix(self) -> np.ndarray:
        if self.matrix is not None:
            return self.matrix
        fn = _MATRIX_FNS.get(self.name)
        if fn is None:
            raise KeyError(f"no matrix for op {self.name}")
        return np.asarray(fn(*self.params), dtype=complex)


class Circuit:
    """Flat op-list circuit (replaces qiskit QuantumCircuit at the IR
    boundary)."""

    def __init__(self, n_qubits: int):
        self.n_qubits = n_qubits
        self.ops: List[Op] = []

    # -- builders ------------------------------------------------------
    def append(self, name_or_op, qubits=None, params=(), matrix=None, duration=None):
        if isinstance(name_or_op, Op):
            self.ops.append(name_or_op)
            return self
        self.ops.append(
            Op(
                name=name_or_op,
                qubits=tuple(qubits),
                params=tuple(params),
                matrix=matrix,
                duration=duration,
            )
        )
        return self

    def unitary(self, matrix, qubits, name="unitary", duration=None):
        return self.append(name, qubits, matrix=np.asarray(matrix, dtype=complex), duration=duration)

    def __getattr__(self, name):
        if name in _MATRIX_FNS:
            n_fixed = {"cx", "cz", "swap", "iswap"}
            def add(*args):
                if name in n_fixed:
                    qubits = args
                    params = ()
                elif name in ("cp", "rzz", "riswap"):
                    params = args[:1]
                    qubits = args[1:]
                elif name == "u":
                    params = args[:3]
                    qubits = args[3:]
                elif name in ("rx", "ry", "rz", "p"):
                    params = args[:1]
                    qubits = args[1:]
                else:
                    params = ()
                    qubits = args
                return self.append(name, qubits, params=params)
            return add
        raise AttributeError(name)

    def compose(self, other: "Circuit") -> "Circuit":
        out = Circuit(max(self.n_qubits, other.n_qubits))
        out.ops = list(self.ops) + list(other.ops)
        return out

    def copy(self) -> "Circuit":
        out = Circuit(self.n_qubits)
        out.ops = list(self.ops)
        return out

    # -- analysis ------------------------------------------------------
    def count_ops(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for op in self.ops:
            out[op.name] = out.get(op.name, 0) + 1
        return out

    def two_qubit_ops(self) -> List[Op]:
        return [op for op in self.ops if op.n_qubits == 2]

    def depth(self) -> int:
        level = [0] * self.n_qubits
        d = 0
        for op in self.ops:
            start = max(level[q] for q in op.qubits)
            for q in op.qubits:
                level[q] = start + 1
            d = max(d, start + 1)
        return d

    def to_matrix(self) -> np.ndarray:
        """Full unitary (exponential in n_qubits — intended for n <= ~10)."""
        dim = 2**self.n_qubits
        U = np.eye(dim, dtype=complex)
        for op in self.ops:
            U = embed(op.to_matrix(), op.qubits, self.n_qubits) @ U
        return U

    def __iter__(self):
        return iter(self.ops)

    def __len__(self):
        return len(self.ops)


def embed(u: np.ndarray, qubits: Sequence[int], n_qubits: int) -> np.ndarray:
    """Embed a k-qubit unitary on `qubits` into the full register
    (big-endian)."""
    k = len(qubits)
    dim = 2**n_qubits
    out = np.zeros((dim, dim), dtype=complex)
    others = [q for q in range(n_qubits) if q not in qubits]
    for i in range(dim):
        bi = [(i >> (n_qubits - 1 - q)) & 1 for q in range(n_qubits)]
        a = 0
        for q in qubits:
            a = (a << 1) | bi[q]
        for b in range(2**k):
            bj = list(bi)
            for t, q in enumerate(qubits):
                bj[q] = (b >> (k - 1 - t)) & 1
            j = 0
            for q in range(n_qubits):
                j = (j << 1) | bj[q]
            out[i, j] = u[a, b]
    return out


def unroll_3q_or_more(circ: Circuit) -> Circuit:
    """Decompose >=3-qubit ops into 1Q/2Q gates (Unroll3qOrMore role,
    speed_limit_pass.py:131-137). Supports ccx/ccz/cswap natively; generic
    3Q unitaries via cosine-sine recursion are not needed by the suite."""
    out = Circuit(circ.n_qubits)
    for op in circ.ops:
        if op.n_qubits <= 2:
            out.append(op)
            continue
        if op.name == "ccx":
            _ccx_into(out, *op.qubits)
        elif op.name == "ccz":
            c2, t = op.qubits[1], op.qubits[2]
            out.h(t)
            _ccx_into(out, op.qubits[0], c2, t)
            out.h(t)
        elif op.name == "cswap":
            c, a, b = op.qubits
            out.cx(b, a)
            _ccx_into(out, c, a, b)
            out.cx(b, a)
        else:
            raise NotImplementedError(f"unroll of {op.name}")
    return out


def _ccx_into(c: Circuit, a: int, b: int, t: int):
    """Standard 6-CX Toffoli decomposition."""
    c.h(t)
    c.cx(b, t); c.append("tdg", (t,))
    c.cx(a, t); c.append("t", (t,))
    c.cx(b, t); c.append("tdg", (t,))
    c.cx(a, t); c.append("t", (b,)); c.append("t", (t,))
    c.h(t)
    c.cx(a, b); c.append("t", (a,)); c.append("tdg", (b,))
    c.cx(a, b)
