"""Parallel-drive ("smush") extended coverage (JAX explore/smush_volume.py).

For a named basis gate and each layer count k below its full-coverage
depth: the Weyl coordinates of random parallel-driven k-cycle circuits (one
batch on the device), extended by Adam descents toward the chamber's
vertices; the bare coverage polytope joined with the rationalized convex
hulls of that cloud (both mirror sides); its Haar volume, and whether CNOT,
SWAP and B lie inside.

Starts: ``sample_smush_coords`` and ``targeted_smush_coords`` draw the JAX
package's numbers, bit for bit (``ops.threefry.uniform``: jax.random's
generator in numpy), so their clouds, and the flags that hang on a single
descent reaching a vertex, are the JAX package's; ``coords_of_samples`` and
``targeted_coords_from`` take the draws themselves. The entry points run on
the card unless ``device`` names another; hulls, volumes and membership are
exact-rational host code.

Extended sets are read from the JAX package's data directory (in place,
never written) and then from the port's build directory
(``config.coverage_cache_dir()``), where ``extend_coverage(save=True)``
writes them with ``extended_results.json``.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, coverage_cache_dir, data_dir, resolve_device
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.ops import threefry

logger = logging.getLogger(__name__)

# gc, gg, t, full-coverage k
NAMED_GATES = {
    "iSwap": (np.pi / 2, 0.0, 1.0, 3),
    "sqiSwap": (np.pi / 2, 0.0, 0.5, 3),
    "CNOT": (np.pi / 4, np.pi / 4, 1.0, 3),
    "sqCNOT": (np.pi / 4, np.pi / 4, 0.5, 6),
    "B": (3 * np.pi / 8, np.pi / 8, 1.0, 2),
    "sqB": (3 * np.pi / 8, np.pi / 8, 0.5, 4),
}

DURATION_1Q = 0.25


def _smush_eval(gc: float, gg: float, t: float, k: int):
    """(eval_fn, n_params) of the k-cycle parallel-driven template: per
    cycle phi_c, phi_g, gx[n_slices], gy[n_slices], then the interior 1q
    layers between cycles (no exterior layers). eval_fn maps x (...,
    n_params) to (..., 4, 4)."""
    from slam_decomposition_torch.models.hamiltonians import smush_u
    from slam_decomposition_torch.models.templates import _layer_1q

    n_slices = max(int(round(t / DURATION_1Q)), 1)
    per_cycle = 2 + 2 * n_slices
    n_params = k * per_cycle + max(k - 1, 0) * 6

    def eval_fn(x):
        U = None
        for i in range(k):
            q = x[..., i * per_cycle : (i + 1) * per_cycle]
            Gm = smush_u(q[..., 0], q[..., 1], gc, gg, q[..., 2 : 2 + n_slices], q[..., 2 + n_slices :], t=t)
            if U is None:
                U = Gm
            else:
                off = k * per_cycle + (i - 1) * 6
                U = Gm @ (_layer_1q(x[..., off : off + 6], 2, False).to(U.dtype) @ U)
        return U

    return eval_fn, n_params


def coords_of_samples(gc: float, gg: float, t: float, k: int, xs, n_samples: int, device=DEFAULT_DEVICE) -> np.ndarray:
    """Weyl coordinates (n_samples, 3) of the k-cycle circuits at the
    parameter batches ``xs`` (one (per, n_params) array per drive scale),
    each batch one evaluation on ``device``, concatenated and cut."""
    from slam_decomposition_torch.ops import weyl

    dev = resolve_device(device)
    eval_fn, _ = _smush_eval(gc, gg, t, k)
    out = [weyl.c1c2c3(eval_fn(torch.as_tensor(x, dtype=torch.float64).to(dev))).cpu().numpy() for x in xs]
    return np.concatenate(out)[:n_samples]


def sample_smush_coords(
    gc: float,
    gg: float,
    t: float,
    k: int,
    n_samples: int = 3000,
    seed: int = 0,
    drive_bound=(np.pi, 2 * np.pi, 4 * np.pi),
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Weyl coordinates of n_samples random parallel-driven k-cycle
    circuits, (n_samples, 3). The budget splits evenly over the drive
    scales (a number or a tuple; the clouds union: one large bound aliases
    the drives modulo the slices and undersamples the frontier); the draws
    of scale i are uniform in [-b, b) at seed + 7919 i, the JAX package's."""
    bounds = np.atleast_1d(np.asarray(drive_bound, dtype=float))
    per = -(-n_samples // len(bounds))
    _, n_params = _smush_eval(gc, gg, t, k)
    xs = [threefry.uniform(seed + 7919 * i, (per, n_params), -b, b) for i, b in enumerate(bounds)]
    return coords_of_samples(gc, gg, t, k, xs, n_samples, device)


def _vertex_targets():
    """The targeted search's vertices: identity, CNOT, SWAP, iSwap and
    CAN(pi/4, pi/8, pi/8)."""
    return [
        np.eye(4, dtype=complex),
        G.CNOT.to_numpy(),
        G.SWAP.to_numpy(),
        G.ISWAP.to_numpy(),
        G.canonical(np.pi / 4, np.pi / 8, np.pi / 8).to_numpy(),
    ]


def targeted_coords_from(gc: float, gg: float, t: float, k: int, x0s, iters: int = 250, lr: float = 0.08) -> np.ndarray:
    """Weyl coordinates of every iterate of Adam descents toward the
    chamber's vertices from the starts x0s (n_vertices, R, n_params), on
    x0s's device: the Makhlin-distance objective (locally invariant, so no
    exterior layers are fitted), constant lr, the start and each update's
    point recorded. Returns (n_vertices * R * (iters + 1), 3), vertex-major
    then restart-major then iterate."""
    from slam_decomposition_torch.ops import weyl
    from slam_decomposition_torch.opt.costs import makhlin_euclidean_cost

    eval_fn, _ = _smush_eval(gc, gg, t, k)
    x = torch.as_tensor(x0s, dtype=torch.float64)
    V = torch.as_tensor(np.stack(_vertex_targets()), device=x.device)[:, None]  # (nv, 1, 4, 4)
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    xs = [x]
    for i in range(iters):
        xg = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(makhlin_euclidean_cost(eval_fn(xg), V).sum(), xg)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** (i + 1))
        vh = v / (1 - 0.999 ** (i + 1))
        x = x - lr * mh / (torch.sqrt(vh) + 1e-8)
        xs.append(x)
    with torch.no_grad():
        cs = weyl.c1c2c3(eval_fn(torch.stack(xs, dim=2)))  # (nv, R, iters + 1, 3)
    return cs.cpu().numpy().reshape(-1, 3)


def targeted_smush_coords(
    gc: float,
    gg: float,
    t: float,
    k: int,
    restarts: int = 6,
    iters: int = 250,
    seed: int = 0,
    lr: float = 0.08,
    drive_bound: float = 4 * np.pi,
    device=DEFAULT_DEVICE,
) -> np.ndarray:
    """Weyl coordinates of EVERY iterate of Adam descents toward the Weyl
    chamber vertices (identity, CNOT, SWAP, iSwap, CAN(pi/4, pi/8, pi/8)):
    random sampling concentrates in the chamber's interior, and descents
    toward the vertices drag trajectories through the frontier. All
    (vertex x restart) descents run as one batch; starts uniform in
    [-drive_bound, drive_bound) at ``seed``, the JAX package's. Returns
    (5 * restarts * (iters + 1), 3)."""
    _, n_params = _smush_eval(gc, gg, t, k)
    x0s = threefry.uniform(seed, (len(_vertex_targets()), restarts, n_params), -drive_bound, drive_bound)
    return targeted_coords_from(gc, gg, t, k, torch.as_tensor(x0s).to(resolve_device(device)), iters, lr)


def rational_hull(points: np.ndarray):
    """Exact-containment H-representation of the hull of a float point
    cloud: Qhull facets, rationalized (limit_denominator(10^4)), offsets
    relaxed outward past the worst hull vertex plus 1e-5, so every sample
    satisfies every row exactly. An upper estimate of the cloud's hull by
    the rationalization error. None where Qhull fails."""
    from scipy.spatial import ConvexHull, QhullError

    from slam_decomposition_torch.coverage.polytope import ConvexPolytope

    try:
        hull = ConvexHull(points, qhull_options="QJ")
    except QhullError:
        return None
    rows = []
    for eq in hull.equations:  # a.x + b <= 0
        a = eq[:3]
        b = eq[3]
        # -> (d, c1, c2, c3) with d + c.x >= 0: c = -a, d = -b
        c = [Fraction(float(x)).limit_denominator(10_000) for x in -a]
        d = Fraction(float(-b)).limit_denominator(10_000)
        vals = [
            d + sum(ci * Fraction(float(p)).limit_denominator(10_000) for ci, p in zip(c, pt))
            for pt in points[hull.vertices]
        ]
        worst = min(vals)
        d = d - min(worst, Fraction(0)) + Fraction(1, 10**5)
        rows.append((d, *c))
    return ConvexPolytope.make(ineqs=rows, name="smush-hull")


def _smush_name(gate) -> str:
    return f"polytope_coverage_['{G.cg_hash(*gate.params[2:])}']smush.pkl"


def extend_coverage(
    name: str,
    n_samples: int = 3000,
    seed: int = 7,
    save: bool = True,
    targeted: bool = True,
    device=DEFAULT_DEVICE,
) -> Dict[str, list]:
    """The pipeline for one named gate: per k, [base_vol, extended_vol,
    cnot, swap, b]. At k below the full-coverage depth the coverage is the
    bare k-layer polytope joined with the hulls of the cloud (sampled at
    seed + k, the targeted descents at seed + 100 + k, the clouds of all
    earlier k kept), mirrored over c1 <-> 1 - c1; its volume is the Haar
    Monte-Carlo volume, held at or above the exact base volume. With
    ``save`` the extended set (with its scores [haar, cnot, swap]) goes to
    the port's build directory, and the rows into its
    extended_results.json."""
    from slam_decomposition_torch.coverage.coverage import (
        IDENTITY_POLYTOPE,
        CircuitPolytope,
        gate_monodromy_reps,
        gate_set_to_coverage,
    )
    from slam_decomposition_torch.coverage.haar import mc_volume, normalized_volume
    from slam_decomposition_torch.coverage.polytope import Polytope
    from slam_decomposition_torch.ops import weyl

    dev = resolve_device(device)
    gc, gg, t, iters = NAMED_GATES[name]
    base_gate = G.cg_canonicalize(G.conversion_gain_gate(0, 0, gc, gg, t))
    bare_cov = gate_set_to_coverage(base_gate, max_layers=iters, device=dev)

    coverage = [CircuitPolytope(operations=[], cost=0.0, polytope=IDENTITY_POLYTOPE)]
    results: Dict[str, list] = {}
    cnot_reps = gate_monodromy_reps(G.CNOT, dev)
    swap_reps = gate_monodromy_reps(G.SWAP, dev)
    b_reps = gate_monodromy_reps(G.berkeley(), dev)
    running_vol = 0.0
    haar_score = 0.0
    cnot_score: Optional[int] = None
    swap_score: Optional[int] = None
    cloud: List[np.ndarray] = []  # coordinates stack up across k

    for k in range(1, iters + 1):
        if k == iters:
            extended = CircuitPolytope(
                operations=[name] * k, cost=float(k) * base_gate.cost(), polytope=bare_cov[-1].polytope
            )
            base_vol = ext_vol = 1.0
        else:
            cloud.append(sample_smush_coords(gc, gg, t, k, n_samples, seed + k, device=dev))
            if targeted:
                cloud.append(targeted_smush_coords(gc, gg, t, k, seed=seed + 100 + k, device=dev))
            coords = np.concatenate(cloud)
            left = coords.copy()
            left[:, 0] = np.minimum(coords[:, 0], 1 - coords[:, 0])
            right = coords.copy()
            right[:, 0] = np.maximum(coords[:, 0], 1 - coords[:, 0])
            subs = list(bare_cov[k].polytope.convex_subpolytopes) if k < len(bare_cov) else []
            for side in (left, right):
                # chamber units -> the monodromy alcove; the first three coordinates
                mc = weyl.positive_canonical_to_monodromy(side).numpy()
                hull = rational_hull(mc[:, :3])
                if hull is not None:
                    subs.append(hull)
            poly = Polytope(subs)
            base_vol = normalized_volume(bare_cov[k].polytope) if k < len(bare_cov) else 0.0
            # the extended set contains the bare one: Monte-Carlo noise below
            # the exact base volume is clamped to it
            ext_vol = max(mc_volume(poly, device=dev), base_vol)
            extended = CircuitPolytope(operations=[name] * k, cost=float(k) * base_gate.cost(), polytope=poly)
        unique = max(ext_vol - running_vol, 0.0)
        haar_score += k * unique
        running_vol += unique
        tol = Fraction(1, 10**6)
        cnot_b = extended.contains(cnot_reps, tol)
        swap_b = extended.contains(swap_reps, tol)
        b_b = extended.contains(b_reps, tol)
        if cnot_score is None and cnot_b:
            cnot_score = k
        if swap_score is None and swap_b:
            swap_score = k
        coverage.append(extended)
        results[str(k)] = [base_vol, ext_vol, bool(cnot_b), bool(swap_b), bool(b_b)]
        logger.info("%s k=%d: base %.4f extended %.4f", name, k, base_vol, ext_vol)

    if save:
        out_dir = coverage_cache_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / _smush_name(base_gate)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump((coverage, {str(base_gate): tuple(base_gate.params)}, [haar_score, cnot_score, swap_score]), f)
        os.replace(tmp, path)
        summary = out_dir / "extended_results.json"
        try:
            existing = json.loads(summary.read_text())
        except (OSError, json.JSONDecodeError):
            existing = {}
        existing[name] = results
        summary.write_text(json.dumps(existing, indent=1))
    return results


def _read_smush(gate):
    """(coverage, {name: params}, scores) of a canonical conversion-gain
    gate's extended set: the JAX package's file, else the port's build.
    None where neither exists."""
    from slam_decomposition_torch.convert import coverage_from_jax_pickle

    for path in (data_dir() / _smush_name(gate), coverage_cache_dir() / _smush_name(gate)):
        try:
            return coverage_from_jax_pickle(path)
        except (OSError, EOFError, pickle.PickleError):
            pass
    return None


def load_smush_coverage(gate):
    """The extended (parallel-drive) coverage set of a canonicalized
    conversion-gain gate; ValueError where ``extend_coverage`` has not
    produced it."""
    got = _read_smush(gate)
    if got is None:
        raise ValueError(f"Smush polytope not in memory for {gate}; run explore.smush_volume.extend_coverage first")
    return got[0]


def smush_scores(params) -> Optional[Tuple[float, int, int]]:
    """[haar, cnot, swap] scores of a smush-extended gate where its extended
    set exists, else None."""
    got = _read_smush(G.cg_canonicalize(G.conversion_gain_gate(*params)))
    return None if got is None else tuple(got[2])
