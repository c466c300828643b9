"""OpenQASM 2 import/export — the qiskit-free interop boundary (JAX
transpile/qasm.py, host code, unchanged).

The reference's API boundary was qiskit QuantumCircuit objects; here
circuits exchange as OpenQASM 2 text (the lingua franca qiskit, cirq,
tket all speak), keeping the framework dependency-free.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from slam_decomposition_torch.transpile.ir import Circuit

_EXPORT_NAMES = {
    "h", "x", "y", "z", "s", "sdg", "t", "tdg", "id",
    "rx", "ry", "rz", "u", "p", "cx", "cz", "swap", "cp", "rzz",
}


def to_qasm(circ: Circuit) -> str:
    lines = [
        "OPENQASM 2.0;",
        'include "qelib1.inc";',
        f"qreg q[{circ.n_qubits}];",
    ]
    for op in circ.ops:
        name = op.name
        if name == "u":
            name = "u3"
        if op.name not in _EXPORT_NAMES:
            if op.n_qubits == 1:
                # decompose an explicit 1Q unitary into u3 + phase
                th, ph, lam, _ = _zyz_angles(op.to_matrix())
                args = f"u3({th},{ph},{lam})"
                lines.append(f"{args} q[{op.qubits[0]}];")
                continue
            raise ValueError(
                f"op {op.name} has no qasm2 form; decompose it first "
                "(e.g. transpile.kak / cx_decompose)"
            )
        params = f"({','.join(repr(float(p)) for p in op.params)})" if op.params else ""
        qubits = ",".join(f"q[{q}]" for q in op.qubits)
        lines.append(f"{name}{params} {qubits};")
    return "\n".join(lines) + "\n"


def _zyz_angles(u: np.ndarray):
    """SU(2) ZYZ Euler angles (theta, phi, lam, phase) with
    u = e^{i phase} Rz(phi) Ry(theta) Rz(lam) in u3 convention."""
    det = np.linalg.det(u)
    su = u / np.sqrt(det)
    theta = 2 * np.arctan2(abs(su[1, 0]), abs(su[0, 0]))
    ang1 = np.angle(su[1, 1])
    ang2 = np.angle(su[1, 0])
    phi = ang1 + ang2
    lam = ang1 - ang2
    phase = np.angle(det) / 2
    return theta, phi, lam, phase


_GATE_RE = re.compile(
    r"^\s*(?P<name>[a-zA-Z_][a-zA-Z0-9_]*)\s*"
    r"(\((?P<params>[^)]*)\))?\s*"
    r"(?P<qubits>q\[\d+\](\s*,\s*q\[\d+\])*)\s*;\s*$"
)

_ALIAS = {"u3": "u", "u1": "p", "cnot": "cx"}


def _eval_param(expr: str) -> float:
    expr = expr.strip().replace("pi", repr(np.pi))
    if not re.fullmatch(r"[0-9eE+\-*/. ()]+", expr):
        raise ValueError(f"unsupported qasm parameter expression: {expr}")
    return float(eval(expr, {"__builtins__": {}}))  # noqa: S307 — sanitized


def from_qasm(text: str) -> Circuit:
    n_qubits = 0
    ops = []
    for line in text.splitlines():
        line = line.split("//")[0].strip()
        if not line or line.startswith(("OPENQASM", "include")):
            continue
        m = re.match(r"qreg\s+q\[(\d+)\];", line)
        if m:
            n_qubits = int(m.group(1))
            continue
        if line.startswith(("creg", "measure", "barrier")):
            continue
        g = _GATE_RE.match(line)
        if not g:
            raise ValueError(f"cannot parse qasm line: {line}")
        name = _ALIAS.get(g.group("name"), g.group("name"))
        params = tuple(
            _eval_param(p) for p in (g.group("params") or "").split(",") if p.strip()
        )
        qubits = tuple(int(x) for x in re.findall(r"q\[(\d+)\]", g.group("qubits")))
        if name == "u2":
            name, params = "u", (np.pi / 2, *params)
        ops.append((name, qubits, params))
    circ = Circuit(n_qubits)
    for name, qubits, params in ops:
        circ.append(name, qubits, params=params)
    return circ
