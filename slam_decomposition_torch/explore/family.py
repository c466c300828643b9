"""Family extension (JAX explore/family.py): can an "older sibling" gate,
the same gc:gg mix at 2x or 3x the duration, synthesize a target cheaper
than k applications of the child?

The recursion is a few levels deep, so it stays on the host and calls the
coverage engine for ranges; ``family_costs_batch`` assigns a whole target
batch's k once per sibling gate.
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
from slam_decomposition_torch.models.gates import Gate


def coverage_for(gate: Gate, use_smush: bool, device):
    """The coverage set of a conversion-gain gate's canonical form: its
    extended (smush) set where ``use_smush``."""
    if use_smush:
        from slam_decomposition_torch.explore.smush_volume import load_smush_coverage

        return load_smush_coverage(G.cg_canonicalize(gate))
    return gate_set_to_coverage(G.cg_canonicalize(gate), device=device)


def _sibling(gate: Gate, rec_factor: int) -> Gate:
    p1, p2, gc, gg, t = gate.params
    return G.cg_normalize_duration(G.conversion_gain_gate(p1, p2, gc, gg, t * rec_factor), 1.0)


def _within_iswap(gate: Gate) -> bool:
    """The recursion stops at a sibling stronger than iSwap."""
    _, _, g1, g2, _ = gate.params
    return g1 + g2 <= np.pi / 2 + 1e-12


def recursive_sibling_check(
    coverage,
    child_gate: Gate,
    target_u: np.ndarray,
    basis_factor: float = 1.0,
    cost_1q: float = 0.1,
    use_smush: bool = False,
    device=DEFAULT_DEVICE,
) -> Tuple[List[Tuple[Gate, int]], float]:
    """(build_plan, cost): build_plan is [(gate, k)], "apply gate k times";
    the cost is (k+1) * cost_1q + k * basis_factor, or 1.2 for a target
    locally equivalent to the child (k = 1)."""
    if np.allclose(target_u, np.eye(4)):
        return [], 0.0

    ki, _ = monodromy_range_from_target(coverage, target_u, device)
    if ki == 0:
        return [], 0.0
    child_cost = (ki + 1) * cost_1q + ki * basis_factor
    if ki == 1:
        return [(child_gate, 1)], 1.2

    # the older sibling: duration x2 (even ki) or x3 (odd ki)
    rec_factor = 2 if ki % 2 == 0 else 3
    sibling = _sibling(child_gate, rec_factor)
    sib_score = np.inf
    sib_plan: List = []
    if _within_iswap(sibling):
        sib_plan, sib_score = recursive_sibling_check(
            coverage_for(sibling, use_smush, device), sibling, target_u, basis_factor=rec_factor * basis_factor,
            cost_1q=cost_1q, use_smush=use_smush, device=device,
        )
    if sib_score < child_cost:
        return sib_plan, sib_score
    return [(child_gate, ki)], child_cost


def family_costs_batch(
    child_gate: Gate,
    targets: np.ndarray,
    cost_1q: float = 0.1,
    basis_factor: float = 1.0,
    use_smush: bool = False,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """``recursive_sibling_check``'s cost for every target of a (N, 4, 4)
    batch, equal to it lane by lane: the sibling chain depends only on the
    parity of each target's k, so one batched k assignment per distinct
    sibling gate does the whole batch and the rest is numpy."""
    targets = np.asarray(targets)
    if targets.ndim == 2:
        targets = targets[None]

    def rec(gate: Gate, bf: float, idx: np.ndarray) -> np.ndarray:
        ks = monodromy_ks_batch(coverage_for(gate, use_smush, device), targets[idx], device).astype(int)
        out = np.empty(len(idx), dtype=float)
        out[ks == 0] = 0.0
        out[ks == 1] = 1.2
        child_cost = (ks + 1) * cost_1q + ks * bf
        for rec_factor in (2, 3):
            sel = (ks >= 2) & ((ks % 2 == 0) == (rec_factor == 2))
            if not sel.any():
                continue
            sib = _sibling(gate, rec_factor)
            if _within_iswap(sib):
                out[sel] = np.minimum(rec(sib, rec_factor * bf, idx[sel]), child_cost[sel])
            else:
                out[sel] = child_cost[sel]
        return out

    return rec(child_gate, basis_factor, np.arange(len(targets)))
