"""Target distributions (the JAX package's opt/samplers.py:17-32).

``haar_sample`` is a verbatim copy of the numpy code, so a seed gives
bit-identical targets in both packages.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


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
