"""Single-qubit gates as complex torch tensors (JAX ops/su2.py:10-100). The
complex dtype follows the angle dtype: complex64 for float32 angles,
complex128 for float64."""

from __future__ import annotations

import numpy as np
import torch


def u3(theta: torch.Tensor, phi: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """qiskit-convention U gate on broadcastable real angles -> (..., 2, 2)
    complex (complex64 for float32 angles, complex128 for float64)."""
    ct = torch.cos(theta / 2.0)
    st = torch.sin(theta / 2.0)
    zero = torch.zeros_like(ct)
    re = torch.stack(
        [
            torch.stack([ct, -torch.cos(lam) * st], dim=-1),
            torch.stack([torch.cos(phi) * st, torch.cos(phi + lam) * ct], dim=-1),
        ],
        dim=-2,
    )
    im = torch.stack(
        [
            torch.stack([zero, -torch.sin(lam) * st], dim=-1),
            torch.stack([torch.sin(phi) * st, torch.sin(phi + lam) * ct], dim=-1),
        ],
        dim=-2,
    )
    return torch.complex(re, im)


def _mat2(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] over the broadcast batch of its entries."""
    return torch.stack([torch.stack([a, b], dim=-1), torch.stack([c, d], dim=-1)], dim=-2)


def rz(theta: torch.Tensor) -> torch.Tensor:
    """diag(e^{-i theta/2}, e^{i theta/2}) -> (..., 2, 2) complex."""
    z = torch.zeros_like(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return torch.complex(_mat2(c, z, z, c), _mat2(-s, z, z, s))


def rx(theta: torch.Tensor) -> torch.Tensor:
    """[[c, -i s], [-i s, c]] with c, s = cos, sin(theta/2)."""
    z = torch.zeros_like(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return torch.complex(_mat2(c, z, z, c), _mat2(z, -s, -s, z))


def ry(theta: torch.Tensor) -> torch.Tensor:
    """[[c, -s], [s, c]] with c, s = cos, sin(theta/2)."""
    z = torch.zeros_like(theta)
    c, s = torch.cos(theta / 2), torch.sin(theta / 2)
    return torch.complex(_mat2(c, -s, s, c), _mat2(z, z, z, z))


def u3_angles(W) -> tuple:
    """(theta, phi, lam) with u3(theta, phi, lam) == W up to global phase,
    for any 2x2 unitary W. Host-side numpy (the inverse of u3, for circuit
    parameter extraction)."""
    W = np.asarray(W, dtype=complex)
    a, b = W[0, 0], W[0, 1]
    c, d = W[1, 0], W[1, 1]
    theta = 2.0 * np.arctan2(np.abs(c), np.abs(a))
    if np.abs(a) > 1e-12 and np.abs(c) > 1e-12:
        phi = np.angle(c) - np.angle(a)
        lam = np.angle(-b) - np.angle(a)
    elif np.abs(a) <= 1e-12:  # theta = pi: only phi - lam matters
        phi = np.angle(c) - np.angle(-b)
        lam = 0.0
    else:  # theta = 0: only phi + lam matters
        phi = np.angle(d) - np.angle(a)
        lam = 0.0
    return float(theta), float(phi), float(lam)
