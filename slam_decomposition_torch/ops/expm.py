"""Matrix exponentials of small (4x4 / 8x8) complex matrices (JAX
ops/expm.py).

``expm_taylor``: scaling and squaring around a fixed-order Taylor
polynomial in Horner form. Branch-free and smooth everywhere, so reverse-
and forward-mode derivatives pass through it at spectral degeneracies too,
and its arithmetic is the JAX package's step for step (the templates'
parity tests hold it to 1e-12). With 7 squarings a norm of up to ~25 scales
under 0.2, where 12 terms reach < 1e-16 relative error in f64: the
conversion-gain gates stay under ~pi, and a driven slice at the smush
sampler's largest drives (+-4 pi) reaches ~7.

``expm_skew(H, t)`` = expm(-i t H) for Hermitian H through the Taylor
route; ``expm_eigh`` the same through the Hermitian eigendecomposition.
"""

from __future__ import annotations

import torch

from slam_decomposition_torch.ops.eig import eigh_hermitian

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


def expm_skew(H: torch.Tensor, t=1.0) -> torch.Tensor:
    """expm(-i t H) for (..., n, n) Hermitian H (JAX ops/expm.py:46-55);
    ``t`` a number or a tensor that broadcasts against H."""
    return expm_taylor(-1j * (torch.as_tensor(t, dtype=H.real.dtype, device=H.device) * H))


def expm_eigh(H: torch.Tensor, t=1.0) -> torch.Tensor:
    """expm(-i t H) through the Hermitian eigendecomposition H = V diag(w)
    V^dag (JAX ops/expm.py:58-68): V diag(e^{-i t w}) V^dag."""
    w, V = eigh_hermitian(H)
    ph = torch.polar(torch.ones_like(w), -t * w)
    return V @ (ph[..., :, None] * V.conj().transpose(-2, -1))
