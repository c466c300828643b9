"""Sycamore (FSim(pi/2, pi/6)) counting decomposer (JAX
transpile/syc_decompose.py).

The reference's SYCDecomposer emits four FSim(pi/2, pi/6) applications per
block, whatever the block. Here the count is exact per target: the SYC
coverage set gives the minimal k (<= 4) by batched polytope membership.
The set is the JAX package's cached pickle where it exists, read in place,
else the port's own build.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE
from slam_decomposition_torch.coverage.coverage import (
    gate_set_to_coverage,
    monodromy_ks_batch,
    monodromy_range_from_target,
)
from slam_decomposition_torch.models import gates as G

_COVERAGE: dict = {}


def syc_coverage(max_layers: int = 8, device=DEFAULT_DEVICE):
    """The SYC basis's coverage set, memoized per ``max_layers`` (a smaller
    request never reuses a deeper set)."""
    if max_layers not in _COVERAGE:
        _COVERAGE[max_layers] = gate_set_to_coverage(G.syc(), max_layers=max_layers, device=device)
    return _COVERAGE[max_layers]


def syc_counts_batch(targets, device=None) -> np.ndarray:
    """Minimal SYC application counts of a (N, 4, 4) batch, one batched k
    assignment on ``device`` (default: the targets' own, the card for
    numpy)."""
    return monodromy_ks_batch(syc_coverage(), targets, device)


def syc_scores(device=DEFAULT_DEVICE) -> np.ndarray:
    """[E-Haar, D-CNOT, D-SWAP] of the SYC basis, a candidate-database row's
    scores."""
    from slam_decomposition_torch.coverage.haar import expected_cost

    cov = syc_coverage()
    cnot, _ = monodromy_range_from_target(cov, G.CNOT.to_numpy(), device)
    swap, _ = monodromy_range_from_target(cov, G.SWAP.to_numpy(), device)
    return np.array([expected_cost(cov), float(cnot), float(swap)])


def syc_decompose(U: np.ndarray, device=DEFAULT_DEVICE) -> Tuple[List, int]:
    """Counting decomposition of one U(4) into k SYC applications: (steps,
    k) in the sqiswap_decompose step format, ("1q", None) placeholders
    alternating with ("syc", None)."""
    k = int(syc_counts_batch(np.asarray(U)[None], device)[0])
    steps: List = [("1q", None)]
    for _ in range(k):
        steps.append(("syc", None))
        steps.append(("1q", None))
    return steps, k
