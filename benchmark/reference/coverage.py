"""The depth of each target from a cached coverage set, in plain NumPy.

The coverage set is the pickle that the JAX package ships in its data
directory, read here as a raw file: an unpickler of this module's own maps
its classes onto plain stand-ins and refuses any other. A set is a list of
entries (operations, cost, polytope); a polytope is a union of convex
polytopes, each a list of inequality rows d + c . a >= 0 and equality rows
d + c . a = 0 over the first three monodromy coordinates a.

A target's depth is the number of operations of the cheapest entry whose
polytope holds one of the target's two monodromy representatives (0 for
the identity class). Membership allows each row, normalised over its
coordinate columns, a slack of 1e-8 times its largest coefficient (at
least 1e-8): the tolerance the coverage sets are used with.
"""

from __future__ import annotations

import os
import pathlib
import pickle

import numpy as np

ROW_TOL = 1e-8
IDENTITY_TOL = 1e-9
_SQ2 = 1.0 / np.sqrt(2.0)
MAGIC = np.array([[_SQ2, 0, 0, 1j * _SQ2], [0, 1j * _SQ2, _SQ2, 0], [0, 1j * _SQ2, -_SQ2, 0], [_SQ2, 0, 0, -1j * _SQ2]])


class _Record:
    """Stand-in for the pickled coverage classes: their state as attributes."""


_CLASSES = {"CircuitPolytope", "Polytope", "ConvexPolytope"}
_MODULES = {"slam_decomposition_tpu.coverage.coverage", "slam_decomposition_tpu.coverage.polytope"}


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module in _MODULES and name in _CLASSES:
            return _Record
        if (module, name) == ("fractions", "Fraction"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def coverage_file(data_dir: pathlib.Path, spec: dict) -> pathlib.Path:
    """The cached set of a conversion-gain gate, by the file name the sets are saved under."""
    key = f"2QGate({spec['gc']:.8f}, {spec['gg']:.8f}, {spec['t']:.8f})"
    return data_dir / f"polytope_coverage_{[key]}.pkl"


def data_dir() -> pathlib.Path:
    """Where the cached sets lie: the JAX package's data directory of this
    checkout, read as raw files, or ``SLAM_DATA_DIR``, which moves it for
    the port too."""
    env = os.environ.get("SLAM_DATA_DIR")
    return pathlib.Path(env) if env else pathlib.Path(__file__).resolve().parents[2] / "slam_decomposition_tpu" / "data"


def config_coverage(config: dict) -> "Coverage":
    """The coverage set of a configuration (its coverage gate, else its basis)."""
    return Coverage(coverage_file(data_dir(), config.get("coverage_gate") or config["basis"]))


def _rows(rows) -> np.ndarray:
    a = np.array([[float(c) for c in r] for r in rows], dtype=float).reshape(-1, 4)
    if len(a):
        a = a / np.maximum(np.sqrt((a[:, 1:] ** 2).sum(axis=1)), 1e-30)[:, None]
    return a


class Coverage:
    """The layers of a cached set (entries of cost > 0, cheapest first), each
    as [(inequality rows, equality rows)] per convex polytope."""

    def __init__(self, path):
        with open(path, "rb") as f:
            entries = _Unpickler(f).load()
        layers = sorted((e for e in entries if e.cost > 0), key=lambda e: e.cost)
        self.depths = [len(e.operations) for e in layers]
        self.layers = [
            [(_rows(cp.inequalities), _rows(cp.equalities)) for cp in e.polytope.convex_subpolytopes] for e in layers
        ]

    def _holds(self, li: int, a: np.ndarray) -> np.ndarray:
        """(m,) whether layer li holds the points a (m, 3)."""
        out = np.zeros(len(a), dtype=bool)
        for ineq, eq in self.layers[li]:
            ok = np.ones(len(a), dtype=bool)
            if len(ineq):
                tol = ROW_TOL * np.maximum(np.abs(ineq).max(axis=1), 1.0)
                ok &= (ineq[:, 0] + a @ ineq[:, 1:].T >= -tol).all(axis=1)
            if len(eq):
                tol = ROW_TOL * np.maximum(np.abs(eq).max(axis=1), 1.0)
                ok &= (np.abs(eq[:, 0] + a @ eq[:, 1:].T) <= tol).all(axis=1)
            out |= ok
        return out

    def depth(self, U: np.ndarray) -> np.ndarray:
        """(m,) depth of each (m, 4, 4) target; -1 where no layer holds it."""
        reps = monodromy_reps(U)  # (m, 2, 4)
        out = np.full(len(U), -1, dtype=np.int64)
        todo = np.ones(len(U), dtype=bool)
        for li, k in enumerate(self.depths):
            if not todo.any():
                break
            idx = np.where(todo)[0]
            hit = self._holds(li, reps[idx, 0, :3]) | self._holds(li, reps[idx, 1, :3])
            out[idx[hit]] = k
            todo[idx[hit]] = False
        out[(np.abs(reps) < IDENTITY_TOL).all(axis=2).any(axis=1)] = 0
        return out


def _alcove(a: np.ndarray) -> np.ndarray:
    """Rows of 4 phases (units of 2 pi) whose sum is an integer -> the alcove
    point: descending, sum 0, by moving whole turns off the largest entry or
    onto the smallest."""
    a = -np.sort(-a, axis=1)
    s = np.round(a.sum(axis=1))
    for _ in range(4):
        down, up = s > 0.5, s < -0.5
        a[down, 0] -= 1.0
        a[up, 3] += 1.0
        s = s - down + up
        a = -np.sort(-a, axis=1)
    return a


def monodromy_reps(U: np.ndarray) -> np.ndarray:
    """(m, 4, 4) unitaries -> (m, 2, 4) both monodromy representatives: the
    eigenphases of m = M^T M, M = B^dag U_s B in the magic basis B, U_s = U
    scaled into SU(4), as alcove points; the second for the class of -U
    (every phase moved by half a turn). Computed in U's precision (the
    benchmark's control passes complex64)."""
    det = np.linalg.det(U)
    Us = U * (np.abs(det) ** -0.25 * np.exp(-1j * np.angle(det) / 4.0))[:, None, None]
    B = MAGIC.astype(U.dtype)
    M = B.conj().T @ Us @ B
    m = np.swapaxes(M, 1, 2) @ M
    a = np.angle(np.linalg.eigvals(m)) / (2.0 * np.pi)
    return np.stack([_alcove(a.copy()), _alcove(a + 0.5)], axis=1)
