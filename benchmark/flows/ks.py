"""The k-assignment flow: each target's depth from the coverage set, and
nothing solved, through the port's public `coverage.monodromy_ks_batch` on
the card. It is what the coverage-analysis callers run alone (Haar depth
histograms, the choice of count in the transpile passes, the mixed-order
templates).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.flows.main import port_gate
from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch


@dataclasses.dataclass
class KsOut:
    """What one batch answers, on the host: each target's depth (`ks`, -1
    for none)."""

    ks: np.ndarray

    @property
    def answered(self) -> int:
        """The targets that have a depth."""
        return int((self.ks >= 0).sum())

    def sample(self, pick: np.ndarray) -> dict:
        """The answers for the targets ``pick``, as the judge takes them."""
        return {"ks": self.ks[pick]}


class Flow:
    def __init__(self, config: dict, traffic: dict, device: torch.device, start_seed: int, spans):
        self.spans = spans
        self.coverage = gate_set_to_coverage(port_gate(config.get("coverage_gate") or config["basis"]), device=device)

    def run_batch(self, T: torch.Tensor) -> KsOut:
        with self.spans("ks"):
            return KsOut(monodromy_ks_batch(self.coverage, T))

    def warm(self, T: torch.Tensor, start_seed: int) -> None:
        """One batch (the harness warms a batch of each size that the window takes)."""
        self.run_batch(T)
