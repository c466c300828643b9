"""Coverage-driven templates (JAX coverage/mixed.py): a template whose gate
order comes from a coverage polytope's operations, with an optional
duration-scaled gate in their place, and its cost accounting.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE
from slam_decomposition_torch.coverage.coverage import (
    CircuitPolytope,
    gate_set_to_coverage,
    monodromy_ks_batch,
    monodromy_range_from_target,
    monodromy_ranges_batch,
)
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.models.templates import Ansatz, build_ansatz


class MixedOrderBasisTemplate:
    """Holds a basis gate set's coverage and builds per-target templates.

    Conversion-gain gates are canonicalized (gc < gg, duration 1) so one
    cached set serves the family. ``smush`` takes the first gate's extended
    (parallel-drive) set instead (``explore.smush_volume.
    load_smush_coverage``). ``device`` is where the coverage is built when
    no cache holds it, and where coordinates and membership run (default:
    the card, or a tensor's own device)."""

    def __init__(self, base_gates: Sequence[Gate], smush: bool = False, max_layers: int = 10, device=None):
        canon = [G.cg_canonicalize(g) if len(g.params) == 5 else g for g in base_gates]
        self.base_gates = canon
        self.gate_map: Dict[str, Gate] = {str(g): g for g in canon}
        self.device = device
        if smush:
            from slam_decomposition_torch.explore.smush_volume import load_smush_coverage

            self.coverage = load_smush_coverage(canon[0])
        else:
            self.coverage = gate_set_to_coverage(
                *canon, max_layers=max_layers, device=DEFAULT_DEVICE if device is None else device
            )
        self.homogeneous = len(canon) == 1

    def range_for(self, target_u) -> Tuple[int, CircuitPolytope]:
        """Minimum applications and the polytope achieving it."""
        return monodromy_range_from_target(self.coverage, target_u, self.device)

    def ks_for_batch(self, targets) -> np.ndarray:
        """Applications per target of a whole stack, batched."""
        return monodromy_ks_batch(self.coverage, targets, self.device)

    def build(
        self,
        polytope: CircuitPolytope,
        scaled_gate: Optional[Gate] = None,
        no_exterior_1q: bool = False,
        vz_only: bool = False,
    ) -> Ansatz:
        """Ansatz realizing the polytope's operation sequence; a
        duration-scaled gate substitutes homogeneously."""
        k = len(polytope.operations)
        if scaled_gate is not None:
            if not self.homogeneous:
                raise ValueError("scaled-gate substitution needs a homogeneous set")
            seq = [scaled_gate] * k
        else:
            seq = [self.gate_map[name] for name in polytope.operations]
        return build_ansatz(seq, no_exterior_1q=no_exterior_1q, vz_only=vz_only)

    def unit_cost(self, polytope: CircuitPolytope) -> float:
        return polytope.cost

    def cost_from_distribution(self, targets) -> float:
        """Total polytope cost over a target distribution without fitting 1Q
        parameters: one batched range assignment, then the costs summed in
        target order (the JAX package's per-target loop gives the same
        sum)."""
        total = 0.0
        for _, cp in monodromy_ranges_batch(self.coverage, targets, self.device):
            total += cp.cost
        return total
