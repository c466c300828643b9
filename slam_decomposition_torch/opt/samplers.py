"""Target distributions and sqiSwap counts (the JAX package's
opt/samplers.py:17-32, 299-336).

``haar_sample`` is a verbatim copy of the numpy code, so a seed gives
bit-identical targets in both packages. ``sqiswap_count_batch`` runs its
coordinates on the device it is given, with no padding and no CPU pin.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from slam_decomposition_torch.config import device_of
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
