"""Matrix exponential of small (4x4 / 8x8) complex matrices (JAX
ops/expm.py:29-44): scaling and squaring around a fixed-order Taylor
polynomial in Horner form. Branch-free and smooth everywhere, so reverse-
and forward-mode derivatives pass through it at spectral degeneracies too,
and its arithmetic is the JAX package's step for step (the templates'
parity tests hold it to 1e-12). All Hamiltonians here have coefficients of
magnitude <= ~pi: with 7 squarings the scaled norm is < 0.2 and 12 terms
reach < 1e-16 relative error in f64.
"""

from __future__ import annotations

import torch

ORDER = 12
SQUARINGS = 7


def expm_taylor(A: torch.Tensor) -> torch.Tensor:
    """expm(A) for (..., n, n) complex A."""
    n = A.shape[-1]
    As = A * 2.0**-SQUARINGS
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
    P = eye
    for k in range(ORDER, 0, -1):  # P = I + As/1 (I + As/2 (I + ...))
        P = eye + (As @ P) * (1.0 / k)
    for _ in range(SQUARINGS):
        P = P @ P
    return P
