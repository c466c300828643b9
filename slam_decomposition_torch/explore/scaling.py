"""Duration scaling of candidate scores under speed-limit models (JAX
explore/scaling.py).

Bare (gate-count) scores become duration scores: scaled by the (possibly
speed-limited) 2Q gate cost, plus (k+1) * duration_1q for the interleaved
1Q layers, or re-scored by family extension. ``cost_scaling`` stores a
whole group's scaled scores in the port's database so that ``pick_winner``
is a lookup; ``load_scaled`` reads the port's file over the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE
from slam_decomposition_torch.explore import candidates
from slam_decomposition_torch.explore.speed_limit import SLFS, speed_limited_cost
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.models.gates import Gate


def scaled_gate_for(params: Sequence[float], speed_method: str) -> Gate:
    """The conversion-gain gate of ``params`` with its speed-limited
    duration."""
    p1, p2, gc, gg, t = params
    gate = G.conversion_gain_gate(p1, p2, gc, gg, t)
    slf = SLFS.get(speed_method)
    if slf is None:
        return gate
    return dataclasses.replace(gate, duration_override=speed_limited_cost(gc, gg, t, slf))


def atomic_cost_scaling(
    params: Sequence[float],
    scores,
    speed_method: str = "linear",
    duration_1q: float = 0.0,
    scaled_gate: Optional[Gate] = None,
    family_extension: bool = False,
    use_smush: bool = False,
    metric=None,
    device=DEFAULT_DEVICE,
) -> Tuple[Gate, np.ndarray]:
    """Bare scores -> (scaled gate, duration scores)."""
    gate = scaled_gate_for(params, speed_method) if scaled_gate is None else scaled_gate
    scores = np.asarray(scores, dtype=float)
    if "bare" in speed_method:
        scaled = scores.copy()
    else:
        # the speed-limited methods scale by the re-costed duration, linear
        # by the bare pi/2-normalized cost
        factor = gate.duration if speed_method in ("hardware", "mid", "squared") else gate.cost()
        scaled = scores * factor

    if family_extension:
        from slam_decomposition_torch.explore.family import coverage_for, recursive_sibling_check

        base = G.conversion_gain_gate(*params)
        cov = coverage_for(base, use_smush, device)
        if metric is None:
            targets, idxs = [G.CNOT.to_numpy(), G.SWAP.to_numpy()], [1, 2]
        elif metric == 0:
            raise NotImplementedError("family extension not defined for Haar")
        elif metric == 1:
            targets, idxs = [G.CNOT.to_numpy()], [None]
        elif metric == 2:
            targets, idxs = [G.SWAP.to_numpy()], [None]
        else:
            targets, idxs = [G.CNOT.to_numpy(), G.SWAP.to_numpy()], [1, 2]
        for tgt, idx in zip(targets, idxs):
            _, fam_cost = recursive_sibling_check(
                cov, base, tgt, cost_1q=duration_1q, basis_factor=gate.cost(), use_smush=use_smush, device=device
            )
            if idx is None:
                return gate, np.asarray(fam_cost)
            scaled[idx] = fam_cost
        return gate, scaled

    return gate, scaled + (scores + 1) * duration_1q  # the 1Q layers


def scaled_group_name(speed_method: str, duration_1q: float, family_extension: bool = False,
                      use_smush: bool = False) -> str:
    """The database group of cached scaled scores: ``get_group_name`` with
    ``_fam`` / ``_smush`` suffixes, so flag combinations never share a
    group."""
    name = candidates.get_group_name(speed_method, duration_1q)
    if family_extension:
        name += "_fam"
    if use_smush:
        name += "_smush"
    return name


def _pad5(v: np.ndarray) -> np.ndarray:
    out = np.full(5, np.nan)
    out[: len(v)] = v
    return out


def _family_extendable(params) -> bool:
    """Family extension is defined only for the iSwap (one coupling zero),
    CNOT (3:1) and B (equal) families."""
    gc, gg = params[2], params[3]
    if gc == 0 or gg == 0:
        return True
    if gg != 0 and gc / gg == 3 or gc != 0 and gg / gc == 3:
        return True
    return gc == gg


def cost_scaling(
    speed_method: str = "linear",
    duration_1q: float = 0.0,
    overwrite: bool = False,
    query_params=None,
    family_extension: bool = False,
    use_smush: bool = False,
    device=DEFAULT_DEVICE,
):
    """Scale every bare candidate score into the port's group
    ``scaled_group_name(...)``, skipping rows already there unless
    ``overwrite`` (a killed sweep resumes where it stopped). Returns the
    number of rows written, or ``(gate, scaled)`` of the candidate equal to
    ``query_params`` (KeyError if none is)."""
    import h5py

    group = scaled_group_name(speed_method, duration_1q, family_extension, use_smush)
    rows = candidates.load_candidates()
    candidates.H5_PATH.parent.mkdir(parents=True, exist_ok=True)
    written = 0
    with h5py.File(candidates.H5_PATH, "a", locking=False) as hf:
        g2 = hf.require_group(group)
        for params, scores in rows:
            if family_extension and not _family_extendable(params):
                continue
            if use_smush:
                from slam_decomposition_torch.explore.smush_volume import smush_scores

                s = smush_scores(params)
                if s is None:
                    continue  # extended sets exist for a few gates only
                scores = np.array(list(s) + [-1.0, -1.0])
            key = G.cg_hash(params[2], params[3], params[4])
            if query_params is not None and not np.allclose(params, query_params):
                continue
            if key in g2 and not overwrite and query_params is None:
                continue
            gate, scaled = atomic_cost_scaling(
                params=params,
                scores=np.asarray(scores, dtype=float)[:3],  # [haar, cnot, swap]; the rest is -1 padding
                speed_method=speed_method,
                duration_1q=duration_1q,
                family_extension=family_extension,
                use_smush=use_smush,
                device=device,
            )
            if query_params is not None:
                return gate, scaled
            if key in g2:
                del g2[key]
            g2.create_dataset(key, data=np.stack([np.asarray(params, dtype=float), _pad5(np.atleast_1d(scaled))]))
            written += 1
    if query_params is not None:
        raise KeyError(f"query_params {list(query_params)} not in the candidate DB for group {group!r}")
    return written


def load_scaled(speed_method: str, duration_1q: float, family_extension: bool = False, use_smush: bool = False):
    """Cached (params, scaled scores) rows of the group, the port's file
    over the JAX package's, or None where the group was never filled."""
    group = scaled_group_name(speed_method, duration_1q, family_extension, use_smush)
    out = [(row[0], row[1][~np.isnan(row[1])]) for row in candidates.read_group(group).values()]
    return out or None
