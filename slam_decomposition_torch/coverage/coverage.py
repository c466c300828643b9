"""Coverage sets: which circuit shapes reach which 2Q gates, at what cost
(JAX coverage/coverage.py).

``gate_set_to_coverage(*gates)`` builds the coverage set of a basis gate
set with the exact-rational engine (``deduce.py`` over ``polytope.py``),
or reads it from a cache: the JAX package's pickles in ``config.data_dir()``
(read only), then the sets the port built itself in
``config.coverage_cache_dir()``, under the same file names.
``monodromy_ks_batch`` and ``monodromy_ranges_batch`` give each target the
cheapest layer whose polytope holds one of its two monodromy
representatives. Coordinates and membership run as batched f64 tensor ops on
one device.

Polytopes carry BOTH PU(4) center images of every reachable class, so
membership tests both target representatives (the JAX package's
convention).
"""

from __future__ import annotations

import dataclasses
import heapq
import os
import pickle
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, coverage_cache_dir, data_dir, device_of, resolve_device
from slam_decomposition_torch.coverage.deduce import deduce_qlr_consequences
from slam_decomposition_torch.coverage.polytope import ConvexPolytope, Polytope, _convex_subset, convex_subtract
from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.utils import profiling

ROW_TOL = 1e-8  # membership tolerance, scaled per row by max(|row|, 1)
IDENTITY_TOL = 1e-9
# targets per batch: the main path's 100k fit in one (~50 MB of f64
# membership values for the sqiSwap set), and every batch costs the Jacobi
# sweeps' ~4000 small launches again
KS_CHUNK = 1 << 17
MAX_LAYERS = 128  # the build's runaway guard when no cap is given
REP_DENOMINATOR = 10_000  # a gate's coordinates as Fractions: limit_denominator

IDENTITY_POLYTOPE = Polytope([ConvexPolytope.make(eqs=[[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], name="origin")])

# The full PU(4) alcove carrying both center images (the closure of any
# universal gate chain; equals the SU(4) alcove).
EVERYTHING_POLYTOPE = Polytope(
    [ConvexPolytope.make(ineqs=[[0, 1, -1, 0], [0, 0, 1, -1], [0, 1, 1, 2], [1, -2, -1, -1]], name="alcove")]
)


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

    def contains(self, reps, tol: Fraction = Fraction(1, 10**9)) -> bool:
        """Exact membership of any of ``reps`` (coordinate 3-vectors)."""
        return any(self.polytope.contains(r, tol) for r in reps)

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

    def contains_float(self, reps, tol: float = ROW_TOL) -> bool:
        """Float membership of any of ``reps`` (m, 3), each row's tolerance
        scaled by its largest coefficient: rows are L2-normalized over the
        coordinate columns, so the scale covers a large constant column (a
        target exactly on such a face has a residual ~|c0| eps). The batched
        paths use the same rule."""
        reps = np.atleast_2d(np.asarray(reps, dtype=float))
        for ineq, eq in self.float_rows():
            t_in = tol * np.maximum(np.abs(ineq).max(axis=1), 1.0) if len(ineq) else None
            t_eq = tol * np.maximum(np.abs(eq).max(axis=1), 1.0) if len(eq) else None
            for p in reps:
                if len(ineq) and (ineq[:, 0] + ineq[:, 1:] @ p < -t_in).any():
                    continue
                if len(eq) and (np.abs(eq[:, 0] + eq[:, 1:] @ p) > t_eq).any():
                    continue
                return True
        return False


def _as_batch(matrices, device):
    """(n, 4, 4) complex128 on ``device`` and whether one (4, 4) was given."""
    U = torch.as_tensor(matrices)
    single = U.ndim == 2
    if single:
        U = U[None]
    return U.to(device=device, dtype=torch.complex128), single


def monodromy_reps_float(matrices, device=None) -> np.ndarray:
    """Both monodromy representatives, (n, 2, 4) f64 numpy ((2, 4) for one
    (4, 4) matrix), computed on ``device`` (default: the tensor's own, the
    card for numpy input)."""
    device = device_of(matrices, device)
    U, single = _as_batch(matrices, device)
    reps = weyl.monodromy_coords(U).cpu().numpy()
    return reps[0] if single else reps


def weyl_coords_float(matrices, device=None) -> np.ndarray:
    """Canonical Weyl coordinates c1c2c3, (n, 3) f64 numpy ((3,) for one
    (4, 4) matrix), computed on ``device`` (default as above)."""
    device = device_of(matrices, device)
    U, single = _as_batch(matrices, device)
    c = weyl.c1c2c3(U).cpu().numpy()
    return c[0] if single else c


def gate_monodromy_reps(gate_or_matrix, device=DEFAULT_DEVICE) -> List[Tuple[Fraction, ...]]:
    """Both PU(4) representatives of a gate's monodromy coordinate, as exact
    fractions: each f64 coordinate through limit_denominator(10_000)."""
    U = gate_or_matrix.to_numpy() if isinstance(gate_or_matrix, Gate) else np.asarray(gate_or_matrix)
    reps = monodromy_reps_float(U, resolve_device(device))
    out = []
    for rep in reps:
        fr = tuple(Fraction(float(x)).limit_denominator(REP_DENOMINATOR) for x in rep[:3])
        if fr not in out:
            out.append(fr)
    return out


def exactly_polytope(reps: Sequence[Sequence[Fraction]]) -> Polytope:
    """Point polytope(s) at the given coordinate representatives."""
    subs = []
    for fr in reps:
        eqs = [(-fr[i],) + tuple(Fraction(int(j == i)) for j in range(3)) for i in range(3)]
        subs.append(ConvexPolytope.make(eqs=eqs, name=f"pt{tuple(map(str, fr))}"))
    return Polytope(subs)


def gate_polytope(gate_or_matrix, device=DEFAULT_DEVICE) -> Polytope:
    return exactly_polytope(gate_monodromy_reps(gate_or_matrix, device))


def _cache_name(gate_names: Sequence[str], smush: bool) -> str:
    """The JAX package's cache file name for a gate set."""
    return f"polytope_coverage_{list(gate_names)}{'smush' if smush else ''}.pkl"


def coverage_path(gate):
    """The JAX package's cache file of a single-gate basis."""
    return data_dir() / _cache_name([str(gate)], False)


def _read_cache(gate_names: Sequence[str], smush: bool) -> Optional[List[CircuitPolytope]]:
    """The cached set from the JAX package's data directory, else from the
    port's own builds, else None."""
    from slam_decomposition_torch.convert import coverage_from_jax_pickle

    name = _cache_name(gate_names, smush)
    for path in (data_dir() / name, coverage_cache_dir() / name):
        try:
            return coverage_from_jax_pickle(path)
        except (OSError, EOFError, pickle.PickleError):
            pass
    return None


def _write_cache(gate_names: Sequence[str], smush: bool, coverage: List[CircuitPolytope]) -> None:
    path = coverage_cache_dir() / _cache_name(gate_names, smush)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(coverage, f)
    os.replace(tmp, path)  # atomic: a concurrent reader sees a whole file


def load_coverage(gate) -> List[CircuitPolytope]:
    """The cached coverage set of a single-gate basis (identity first, then
    layers), without building: FileNotFoundError when no cache holds it."""
    cached = _read_cache([str(gate)], False)
    if cached is None:
        raise FileNotFoundError(f"no cached coverage set for {gate}: {coverage_path(gate)}")
    return cached


def gate_set_to_coverage(
    *gates: Gate,
    cost_1q: float = 0.0,
    bare_cost: bool = True,
    max_layers: Optional[int] = None,
    use_cache: bool = True,
    smush: bool = False,
    device=DEFAULT_DEVICE,
) -> List[CircuitPolytope]:
    """The coverage set of a basis gate set: the identity, then one layer
    per gate sequence in cheapest-first order.

    A cheapest-first frontier over gate sequences (a chain P_k =
    QLR(P_{k-1}, g) for one gate) grows until a layer's union covers the
    whole alcove (exactly, up to measure zero). ``max_layers=None`` builds
    until complete, with a 128-layer runaway guard; an explicit cap may
    return an incomplete set. Only complete sets are cached (in the port's
    build directory). On a cache hit a cap truncates the cached set to the
    identity and ``max_layers`` layers: the cache keeps the build order, so
    that equals the capped build. ``smush`` only names the cache file.
    The gates' coordinates are computed on ``device`` (the card unless the
    caller names another) when a set is built."""
    names = [str(g) for g in gates]
    if use_cache:
        cached = _read_cache(names, smush)
        if cached is not None:
            return cached if max_layers is None else cached[: max_layers + 1]

    device = resolve_device(device)
    if bare_cost:
        costs = {str(g): 1.0 for g in gates}
    else:
        costs = {str(g): g.cost() + cost_1q for g in gates}
    gate_polys = {str(g): gate_polytope(g, device) for g in gates}

    out = [CircuitPolytope(operations=[], cost=0.0, polytope=IDENTITY_POLYTOPE)]
    complete = False
    # frontier entries: (total cost, tie counter, gate sequence); the counter
    # keeps pushes of equal cost in push order
    frontier: List[Tuple[float, int, List[str]]] = []
    counter = 0
    for nm in names:
        heapq.heappush(frontier, (costs[nm], counter, [nm]))
        counter += 1
    built: Dict[Tuple[str, ...], Polytope] = {(): IDENTITY_POLYTOPE}
    cap = MAX_LAYERS if max_layers is None else max_layers
    while frontier and len(out) <= cap:
        cost, _, seq = heapq.heappop(frontier)
        parent = built.get(tuple(seq[:-1]))
        if parent is None:
            continue
        poly = deduce_qlr_consequences(parent, gate_polys[seq[-1]])
        built[tuple(seq)] = poly
        out.append(CircuitPolytope(operations=list(seq), cost=cost, polytope=poly))
        if _covers_everything(poly):
            complete = True
            break
        for nm in names:
            heapq.heappush(frontier, (cost + costs[nm], counter, seq + [nm]))
            counter += 1
    if complete:
        _write_cache(names, smush, out)
    return out


def circuit_to_polytope(ops, device=DEFAULT_DEVICE) -> Polytope:
    """Reachable-set polytope of a fixed 2Q gate sequence (Gates or (4, 4)
    unitaries): the classes that some choice of interleaved 1Q gates reaches
    with exactly this sequence."""
    poly = IDENTITY_POLYTOPE
    for g in ops:
        poly = deduce_qlr_consequences(poly, gate_polytope(g, device))
    return poly


def gate_set_to_haar_expectation(*gates: Gate, **kw) -> float:
    """Coverage and its Haar-expected cost in one call."""
    from slam_decomposition_torch.coverage.haar import expected_cost

    return expected_cost(gate_set_to_coverage(*gates, **kw))


def _covers_everything(poly: Polytope) -> bool:
    return all(
        any(_convex_subset(chunk, sub) for sub in poly.convex_subpolytopes) or _union_covers(chunk, poly)
        for chunk in EVERYTHING_POLYTOPE.convex_subpolytopes
    )


def _union_covers(chunk: ConvexPolytope, poly: Polytope) -> bool:
    """Whether ``chunk`` minus the union of ``poly`` has measure zero, by
    exact region subtraction: a worklist of convex remainders of the chunk
    shrinks by ``convex_subtract`` per subpolytope; covered iff it empties.
    Lower-dimensional slivers do not block completeness (a volume criterion);
    membership of boundary targets is decided per polytope, never here."""
    regions = [chunk]
    for sub in poly.convex_subpolytopes:
        if sub.equalities:
            # lower-dimensional subpolytope: measure-zero contribution
            red = sub.reduce()
            if red is None or red.equalities:
                continue
            sub = red
        regions = [piece for region in regions for piece in convex_subtract(region, sub)]
        if not regions:
            return True
    return not regions


def _layer_tables(layers, device):
    """Padded row tables over every convex subpolytope of ``layers``, in
    order: A_in (S, J, 4), A_eq (S, E, 4), their row tolerances and the
    (S, n_layers) one-hot of each subpolytope's layer. Padding rows are
    [1, 0, 0, 0] (always >= 0) and all-zero equalities."""
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
    t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
    return t(A_in), t(A_eq), t(tol_in), t(tol_eq), t(onehot)


def _index_of_reps(reps: torch.Tensor, tables) -> torch.Tensor:
    """The cheapest covering layer of each target from its monodromy
    representatives (n, 2, 3): its index, -1 for the identity class, -2
    where no layer covers it."""
    A_in, A_eq, tol_in, tol_eq, onehot = tables
    vals = A_in[:, :, 0] + torch.einsum("nrk,sjk->nrsj", reps, A_in[:, :, 1:])
    ok = (vals >= -tol_in).all(-1)
    evals = A_eq[:, :, 0] + torch.einsum("nrk,sjk->nrsj", reps, A_eq[:, :, 1:])
    ok &= (evals.abs() <= tol_eq).all(-1)
    member = (ok.any(1).to(torch.float64) @ onehot) > 0  # (n, layers)
    first = torch.argmax(member.to(torch.int8), dim=1)
    covered = member.any(dim=1)
    is_id = (reps.abs() < IDENTITY_TOL).all(-1).any(-1)
    return torch.where(is_id, -1, torch.where(covered, first, -2))


def _layers(coverage):
    return sorted([c for c in coverage if c.cost > 0], key=lambda c: c.cost)


def _checked(idx: np.ndarray) -> np.ndarray:
    if (idx == -2).any():
        raise ValueError("no coverage polytope contains some targets")
    return idx


def _layer_index(coverage, targets, device):
    """(index into the layers of the cheapest covering layer, -1 for the
    identity class, -2 for a target in no layer; (N,) int64 numpy) and the
    layers (every entry of cost > 0, by cost).

    Spans (``utils.profiling``): ``ks`` the call, ``ks.coords`` the
    monodromy coordinates, ``ks.member`` the membership test; the row
    tables and the wait for the device's answer stay in ``ks``'s own
    time."""
    with profiling.span("ks"):
        device = device_of(targets, device)
        targets = torch.as_tensor(targets)
        if targets.ndim == 2:
            targets = targets[None]
        layers = _layers(coverage)
        tables = _layer_tables(layers, device)
        out = []
        for s in range(0, targets.shape[0], KS_CHUNK):
            U = targets[s : s + KS_CHUNK].to(device=device, dtype=torch.complex128)
            with profiling.span("ks.coords"):
                reps = weyl.monodromy_coords(U)[..., :3]  # (n, 2, 3)
            with profiling.span("ks.member"):
                idx = _index_of_reps(reps, tables)
            out.append(idx.cpu().numpy())
        return np.concatenate(out), layers


def monodromy_ks_of_reps(coverage, reps, device=DEFAULT_DEVICE) -> np.ndarray:
    """``monodromy_ks_batch`` from the targets' monodromy representatives
    ((N, 2, 3) or ``monodromy_reps_float``'s (N, 2, 4)), so that one batch's
    coordinates serve many coverage sets. Runs on ``device`` (the card
    unless the caller names another)."""
    device = resolve_device(device)
    layers = _layers(coverage)
    tables = _layer_tables(layers, device)
    reps = torch.as_tensor(np.asarray(reps)[..., :3], dtype=torch.float64, device=device)
    idx = _checked(np.concatenate([
        _index_of_reps(reps[s : s + KS_CHUNK], tables).cpu().numpy() for s in range(0, reps.shape[0], KS_CHUNK)
    ]))
    ks_of_layer = np.array([len(cp.operations) for cp in layers])
    return np.where(idx < 0, 0, ks_of_layer[np.maximum(idx, 0)])


def monodromy_ks_batch(coverage, targets, device=None) -> np.ndarray:
    """k per target: (N, 4, 4) complex numpy or tensor -> (N,) int64 numpy.

    0 for the identity class, otherwise the operation count of the
    cheapest covering layer. Runs on ``device`` (default: the targets'
    device, or the card for numpy input) in batches of KS_CHUNK targets,
    which bounds the (targets x reps x subpolytopes x rows) membership
    tensor. Raises ValueError if a target lies in no coverage polytope."""
    ks = monodromy_ks_unchecked(coverage, targets, device)
    if (ks < 0).any():
        raise ValueError("no coverage polytope contains some targets")
    return ks


def monodromy_ks_unchecked(coverage, targets, device=None) -> np.ndarray:
    """``monodromy_ks_batch`` with -1 for a target in no coverage polytope,
    in place of the ValueError: for a caller that must finish a collective
    before it raises (``parallel.mesh.sharded_ks``)."""
    idx, layers = _layer_index(coverage, targets, device)
    ks_of_layer = np.array([len(cp.operations) for cp in layers])
    return np.where(idx == -2, -1, np.where(idx < 0, 0, ks_of_layer[np.maximum(idx, 0)]))


def monodromy_ranges_batch(coverage: Sequence[CircuitPolytope], targets, device=None) -> List[Tuple[int, CircuitPolytope]]:
    """(k, the cheapest covering CircuitPolytope) per target, batched as
    ``monodromy_ks_batch``; the identity class gives (0, coverage[0])."""
    idx, layers = _layer_index(coverage, targets, device)
    idx = _checked(idx)
    return [(0, coverage[0]) if i < 0 else (len(layers[i].operations), layers[i]) for i in idx.tolist()]


def monodromy_range_from_target(coverage: Sequence[CircuitPolytope], target_u, device=None) -> Tuple[int, CircuitPolytope]:
    """(k = number of operations, polytope) of the cheapest coverage
    polytope containing one target (4, 4)."""
    return monodromy_ranges_batch(coverage, target_u, device)[0]
