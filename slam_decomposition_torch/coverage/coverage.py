"""Coverage sets and k-assignment (JAX coverage/coverage.py:55-109,
332-374, 813-864).

``load_coverage(gate)`` reads the JAX package's cached coverage set for a
basis gate; ``monodromy_ks_batch`` assigns each target the application
count k of the cheapest layer whose polytope holds one of its two
monodromy representatives. Coordinates and membership run as batched f64
tensor ops on the targets' device.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from slam_decomposition_torch.config import data_dir, device_of
from slam_decomposition_torch.coverage.polytope import Polytope
from slam_decomposition_torch.ops import weyl

ROW_TOL = 1e-8  # membership tolerance, scaled per row by max(|row|, 1)
IDENTITY_TOL = 1e-9
# targets per batch: the main path's 100k fit in one (~50 MB of f64
# membership values for the sqiSwap set), and every batch costs the Jacobi
# sweeps' ~4000 small launches again
KS_CHUNK = 1 << 17


def _normalized_rows(rows) -> np.ndarray:
    """Rows as floats, L2-normalized over the coordinate columns, (m, 4)."""
    a = np.array([[float(c) for c in r] for r in rows], dtype=float).reshape(-1, 4)
    if len(a):
        a = a / np.maximum(np.sqrt((a[:, 1:] ** 2).sum(axis=1)), 1e-30)[:, None]
    return a


@dataclasses.dataclass
class CircuitPolytope:
    """A reachable set with its build recipe and cost."""

    operations: List[str]
    cost: float
    polytope: Polytope

    def float_rows(self):
        """[(ineq, eq)] per convex subpolytope, cached on the instance (the
        JAX package's ``contains_float`` row cache)."""
        rows = self.__dict__.get("_float_rows")
        if rows is None:
            rows = [
                (_normalized_rows(cp.inequalities), _normalized_rows(cp.equalities))
                for cp in self.polytope.convex_subpolytopes
            ]
            self.__dict__["_float_rows"] = rows
        return rows


def coverage_path(gate):
    """The JAX package's cache file name for a single-gate basis."""
    return data_dir() / f"polytope_coverage_{str([str(gate)])}.pkl"


def load_coverage(gate) -> List[CircuitPolytope]:
    """The cached coverage set of ``gate`` (identity first, then layers).

    The exact-rational engine that builds a missing set is not ported, so a
    gate without a cache file raises FileNotFoundError."""
    from slam_decomposition_torch.convert import coverage_from_jax_pickle

    path = coverage_path(gate)
    if not path.exists():
        raise FileNotFoundError(f"no cached coverage set for {gate}: {path}")
    return coverage_from_jax_pickle(path)


def _layer_tables(coverage, device):
    """Padded row tables over every convex subpolytope of every layer, in
    cost order: A_in (S, J, 4), A_eq (S, E, 4), their row tolerances, the
    (S, n_layers) one-hot of each subpolytope's layer, and k per layer.
    Padding rows are [1, 0, 0, 0] (always >= 0) and all-zero equalities."""
    layers = sorted([c for c in coverage if c.cost > 0], key=lambda c: c.cost)
    subs = [(li, ineq, eq) for li, cp in enumerate(layers) for ineq, eq in cp.float_rows()]
    jmax = max(max(len(s[1]) for s in subs), 1)
    emax = max(max(len(s[2]) for s in subs), 1)
    S = len(subs)
    A_in = np.tile(np.array([1.0, 0, 0, 0]), (S, jmax, 1))
    A_eq = np.zeros((S, emax, 4))
    onehot = np.zeros((S, len(layers)))
    for s, (li, ineq, eq) in enumerate(subs):
        A_in[s, : len(ineq)] = ineq
        A_eq[s, : len(eq)] = eq
        onehot[s, li] = 1.0
    tol_in = ROW_TOL * np.maximum(np.abs(A_in).max(axis=2), 1.0)
    tol_eq = ROW_TOL * np.maximum(np.abs(A_eq).max(axis=2), 1.0)
    ks = np.array([len(cp.operations) for cp in layers])
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return t(A_in), t(A_eq), t(tol_in), t(tol_eq), t(onehot), ks


def monodromy_ks_batch(coverage, targets, device=None) -> np.ndarray:
    """k per target: (N, 4, 4) complex numpy or tensor -> (N,) int64 numpy.

    0 for the identity class, otherwise the operation count of the
    cheapest covering layer. Runs on ``device`` (default: the targets'
    device, or the card for numpy input) in batches of KS_CHUNK targets,
    which bounds the (targets x reps x subpolytopes x rows) membership
    tensor."""
    device = device_of(targets, device)
    if isinstance(targets, np.ndarray):
        targets = torch.as_tensor(targets)
    if targets.ndim == 2:
        targets = targets[None]
    A_in, A_eq, tol_in, tol_eq, onehot, ks_of_layer = _layer_tables(coverage, device)
    out = []
    for s in range(0, targets.shape[0], KS_CHUNK):
        U = targets[s : s + KS_CHUNK].to(device=device, dtype=torch.complex128)
        reps = weyl.monodromy_coords(U)[..., :3]  # (n, 2, 3)
        vals = A_in[:, :, 0] + torch.einsum("nrk,sjk->nrsj", reps, A_in[:, :, 1:])
        ok = (vals >= -tol_in).all(-1)
        evals = A_eq[:, :, 0] + torch.einsum("nrk,sjk->nrsj", reps, A_eq[:, :, 1:])
        ok &= (evals.abs() <= tol_eq).all(-1)
        member = (ok.any(1).to(torch.float64) @ onehot) > 0  # (n, layers)
        first = torch.argmax(member.to(torch.int8), dim=1)
        covered = member.any(dim=1)
        is_id = (reps.abs() < IDENTITY_TOL).all(-1).any(-1)
        idx = torch.where(is_id, -1, torch.where(covered, first, -2))
        out.append(idx.cpu().numpy())
    idx = np.concatenate(out)
    if (idx == -2).any():
        raise ValueError("no coverage polytope contains some targets")
    return np.where(idx < 0, 0, ks_of_layer[np.maximum(idx, 0)])
