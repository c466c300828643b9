"""Analytic CX-basis synthesis: any U(4) from 0-3 CNOTs + 1Q layers (JAX
transpile/cx_decompose.py, host numpy, unchanged).

Role of qiskit's TwoQubitBasisDecomposer fallback in the reference
(weyl_decompose.py:480). Counts: 0 for local, 1 for the CX class, 2 for
c3 = 0 classes, 3 otherwise. Middle-layer angles are CLOSED FORM (linear
in the canonical coordinates, Vatan-Williams style; verified exact):

  2-CX:  CX (Rx(2x) ox Rz(2y)) CX           ~ CAN(x, y, 0)
  3-CX:  CXR (Rz(2x+pi/2) ox Ry(2y+pi/2)) CX (I ox Ry(2z+pi/2)) CXR
                                             ~ CAN(x, y, z)

The outer locals are recovered by re-KAK of the middle sandwich, so only
class equality is needed from the closed forms.
"""

from __future__ import annotations

import numpy as np

from slam_decomposition_torch.transpile.kak import (
    PI4,
    _rz,
    _rx,
    kak_form,
)

_CX = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=complex
)  # control qubit 0
_CXR = np.array(
    [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]], dtype=complex
)  # control qubit 1


def _ry(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -s], [s, c]])


def cx_decompose(U: np.ndarray):
    """Returns (steps, n_cx) with steps first-applied-first:
    ("cx", None) / ("1q", (l, r))."""
    form = kak_form(U)
    t = form.t
    steps = []

    def finish(V_class):
        """Close the sandwich: V_class has the same class as CAN(t); emit
        corrected outer locals."""
        vf = kak_form(V_class[0])
        pre = (vf.l2.conj().T, vf.r2.conj().T)
        post = (vf.l1.conj().T, vf.r1.conj().T)
        inner = [("1q", pre)] + V_class[1] + [("1q", post)]
        out = [("1q", (form.l2, form.r2))] + inner + [("1q", (form.l1, form.r1))]
        return out

    if np.abs(t).max() < 1e-9:
        steps = [("1q", (form.l2, form.r2)), ("1q", (form.l1, form.r1))]
        return _merge(steps), 0
    if np.abs(t - np.array([PI4, 0, 0])).max() < 1e-9:
        V = (_CX, [("cx", None)])
        return _merge(finish(V)), 1
    if abs(t[2]) < 1e-9:
        # closed form: CX (Rx(2x) ox Rz(2y)) CX ~ CAN(x, y, 0)
        mid = (_rx(2 * t[0]), _rz(2 * t[1]))
        V = (
            _CX @ np.kron(*mid) @ _CX,
            [("cx", None), ("1q", mid), ("cx", None)],
        )
        return _merge(finish(V)), 2

    # Vatan-Williams alternating-direction sandwich, closed form:
    # CX(1->0) (Rz(2x+pi/2) ox Ry(2y+pi/2)) CX(0->1) (I ox Ry(2z+pi/2)) CX(1->0)
    p = 2.0 * np.asarray(t, dtype=float) + np.pi / 2
    V = (
        _CXR
        @ np.kron(_rz(p[0]), _ry(p[1]))
        @ _CX
        @ np.kron(np.eye(2), _ry(p[2]))
        @ _CXR,
        [
            ("cxr", None),
            ("1q", (np.eye(2), _ry(p[2]))),
            ("cx", None),
            ("1q", (_rz(p[0]), _ry(p[1]))),
            ("cxr", None),
        ],
    )
    return _merge(finish(V)), 3


def _merge(steps):
    out = []
    for kind, payload in steps:
        if kind == "1q" and out and out[-1][0] == "1q":
            l0, r0 = out[-1][1]
            out[-1] = ("1q", (payload[0] @ l0, payload[1] @ r0))
        else:
            out.append((kind, payload))
    return out


def cx_steps_to_matrix(steps):
    U = np.eye(4, dtype=complex)
    for kind, payload in steps:
        if kind == "cx":
            U = _CX @ U
        elif kind == "cxr":
            U = _CXR @ U
        else:
            l, r = payload
            U = np.kron(l, r) @ U
    return U


def cx_decompose_to_circuit(U: np.ndarray, duration_1q: float = 0.0):
    from slam_decomposition_torch.transpile.ir import Circuit

    steps, _ = cx_decompose(U)
    sub = Circuit(2)
    for kind, payload in steps:
        if kind == "cx":
            sub.append("cx", (0, 1), duration=1.0)
        elif kind == "cxr":
            sub.append("cx", (1, 0), duration=1.0)
        else:
            sub.unitary(payload[0], (0,), name="u1q", duration=duration_1q)
            sub.unitary(payload[1], (1,), name="u1q", duration=duration_1q)
    return sub
