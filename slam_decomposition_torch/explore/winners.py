"""Winner selection (JAX explore/winners.py): the best basis gate of the
candidate database under a metric.

Metrics: 0 = E[Haar], 1 = D[CNOT], 2 = D[SWAP], (-1, lambda) = the
lambda-weighted CNOT / SWAP mix, or, with ``target_ops``, the exact cost of
a target distribution from its monodromy ranges.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence, Tuple

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.explore.candidates import get_method_duration, load_candidates
from slam_decomposition_torch.explore.scaling import (
    _family_extendable,
    atomic_cost_scaling,
    load_scaled,
    scaled_gate_for,
)
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.models.gates import Gate

logger = logging.getLogger(__name__)


def _cached_winner(speed_method, duration_1q, metric, family_extension, smush):
    """(winner, scaled winner) from the precomputed scaled-score group, or
    None where the group was never filled (``scaling.cost_scaling``)."""
    cached = load_scaled(speed_method, duration_1q, family_extension, smush)
    if cached is None:
        return None
    best = None
    for params, scaled in cached:
        if isinstance(metric, tuple):
            if len(scaled) < 3:
                continue
            lam = metric[1]
            # linear in the scaled scores: the scaling of the bare mix
            score = lam * scaled[1] + (1 - lam) * scaled[2]
        else:
            if metric >= len(scaled):
                continue
            score = float(scaled[metric])
        if best is None or score < best[0]:
            best = (score, params)
    if best is None:
        return None
    winner_gate = G.conversion_gain_gate(*best[1])
    logger.info("winner %s score %.4f (cached)", winner_gate, best[0])
    return winner_gate, scaled_gate_for(best[1], speed_method)


def pick_winner(
    group_name: str,
    metric=0,
    target_ops: Optional[Sequence[np.ndarray]] = None,
    smush: bool = False,
    family_extension: bool = False,
    device=DEFAULT_DEVICE,
) -> Tuple[Gate, Gate]:
    """(winner gate, its speed-limited gate) of the candidates under
    ``metric``.

    Where the group's scaled scores were precomputed
    (``scaling.cost_scaling``), selection is a lookup. Otherwise every
    candidate is scored here; with ``target_ops`` each candidate's coverage
    set (cache or build; coordinates and membership on ``device``, the card
    unless the caller names another) assigns the whole distribution's ranges
    in one batched call, from the distribution's coordinates computed
    once."""
    speed_method, duration_1q = get_method_duration(group_name)

    if target_ops is None and (
        (metric in (0, 1, 2) and not (family_extension and metric == 0))
        or (isinstance(metric, tuple) and metric[0] == -1)
    ):
        hit = _cached_winner(speed_method, duration_1q, metric, family_extension, smush)
        if hit is not None:
            return hit

    if target_ops is not None:
        from slam_decomposition_torch.coverage.coverage import monodromy_ks_of_reps, monodromy_reps_float
        from slam_decomposition_torch.explore.family import coverage_for

        reps = monodromy_reps_float(np.stack(target_ops), resolve_device(device))  # once for every candidate
    winner = winner_score = winner_scaled = None
    for params, scores in load_candidates():
        if family_extension and not _family_extendable(params):
            continue  # the batch cache's candidate set, so both rank the same
        if smush:
            from slam_decomposition_torch.explore.smush_volume import smush_scores

            s = smush_scores(params)
            if s is None:
                continue
            scores = np.array(list(s) + [-1, -1])
        kw = dict(speed_method=speed_method, duration_1q=duration_1q, family_extension=family_extension,
                  use_smush=smush, metric=metric, device=device)
        if target_ops is None and metric in (0, 1, 2):
            scaled_gate, scaled = atomic_cost_scaling(params, scores[metric], **kw)
            candidate_score = float(np.atleast_1d(scaled)[0])
        elif target_ops is None and isinstance(metric, tuple) and metric[0] == -1:
            lam = metric[1]
            scaled_gate, scaled = atomic_cost_scaling(params, lam * scores[1] + (1 - lam) * scores[2], **kw)
            candidate_score = float(np.atleast_1d(scaled)[0])
        elif target_ops is None:
            continue
        else:
            base = G.conversion_gain_gate(*params)
            try:
                ks = monodromy_ks_of_reps(coverage_for(base, smush, device), reps, device)
            except (ValueError, RuntimeError):
                continue
            # the per-target sum, in target order, as the JAX loop adds it
            candidate_score = 0.0
            scaled_gate = None
            for k in ks:
                scaled_gate, scaled = atomic_cost_scaling(params, int(k), scaled_gate=scaled_gate, **kw)
                candidate_score += float(np.atleast_1d(scaled)[0])
        if winner_score is None or candidate_score < winner_score:
            winner, winner_score, winner_scaled = params, candidate_score, scaled_gate

    if winner is None:
        raise ValueError("no scorable candidates in DB (run collect_data)")
    winner_gate = G.conversion_gain_gate(*winner)
    logger.info("winner %s score %.4f", winner_gate, winner_score)
    return winner_gate, winner_scaled
