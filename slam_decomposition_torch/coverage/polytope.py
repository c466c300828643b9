"""Exact rational convex polytopes over Fraction arithmetic (JAX
coverage/polytope.py, which imports no jax).

A polytope in the reduced monodromy space (x1, x2, x3) is a union of convex
subpolytopes, each given by rows ``[d, c1, c2, c3]`` meaning
``d + c . x >= 0`` (inequalities) or ``= 0`` (equalities), with exact
``Fraction`` entries. The dataclasses keep the JAX package's field names,
so its cached coverage pickles load into them
(``convert.coverage_from_jax_pickle``).

Operations:
  * exact-rational simplex (feasibility / LP), in the C++ core
    (``coverage/native.py``) with this module's Fractions path where the core
    overflows int64
  * redundancy elimination and implied equalities, emptiness
  * Fourier-Motzkin variable elimination (for the QLR projection)
  * vertex enumeration (for hulls and volumes)
  * convex hull of points, and exact region subtraction

Row order is part of the answer: every step keeps the JAX package's order,
so the sets built here equal its cached ones row for row.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

from slam_decomposition_torch.coverage import native

Row = Tuple[Fraction, ...]


def _fr(x) -> Fraction:
    if isinstance(x, Fraction):
        return x
    if isinstance(x, float):
        return Fraction(x).limit_denominator(10_000)
    return Fraction(x)


def _normalize_row(row: Sequence) -> Row:
    r = tuple(_fr(x) for x in row)
    denom_lcm = 1
    for x in r:
        denom_lcm = denom_lcm * x.denominator // _gcd(denom_lcm, x.denominator)
    ints = [int(x * denom_lcm) for x in r]
    g = 0
    for v in ints:
        g = _gcd(g, abs(v))
    if g > 1:
        ints = [v // g for v in ints]
    return tuple(Fraction(v) for v in ints)


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


# ------------------------------------------------------------ exact simplex


def lp_max(
    objective: Sequence[Fraction],
    ineqs: Sequence[Row],
    eqs: Sequence[Row] = (),
) -> Tuple[str, Optional[Fraction]]:
    """Maximize c.x subject to d + A.x >= 0 rows (and equality rows).

    Returns (status, value) with status in {"optimal", "unbounded",
    "infeasible"}. The C++ core answers first (csrc/polytope_core.cpp); where
    it overflows int64, the Fractions two-phase simplex below does.
    """
    res = native.lp_max_native(list(objective), list(ineqs), list(eqs))
    if res is not None:
        return res
    n = len(objective)
    # convert: d + a.x >= 0  ->  -a.x <= d ; equality -> two ineqs
    A: List[List[Fraction]] = []
    b: List[Fraction] = []
    for row in ineqs:
        d, coefs = row[0], row[1:]
        A.append([-_fr(c) for c in coefs])
        b.append(_fr(d))
    for row in eqs:
        d, coefs = row[0], row[1:]
        A.append([-_fr(c) for c in coefs])
        b.append(_fr(d))
        A.append([_fr(c) for c in coefs])
        b.append(-_fr(d))
    m = len(A)
    if m == 0:
        if all(_fr(c) == 0 for c in objective):
            return "optimal", Fraction(0)
        return "unbounded", None

    if all(bi >= 0 for bi in b):
        ncols = 2 * n + m  # xp, xm, slacks (x = xp - xm for free vars)
        T = [[Fraction(0)] * (ncols + 1) for _ in range(m)]
        for i in range(m):
            for j in range(n):
                T[i][j] = A[i][j]
                T[i][n + j] = -A[i][j]
            T[i][2 * n + i] = Fraction(1)
            T[i][ncols] = b[i]
        basis = [2 * n + i for i in range(m)]
    else:
        status, _, T, basis, ncols = _phase1(A, b, n)
        if status == "infeasible":
            return "infeasible", None
        m = len(T)

    cost = [Fraction(0)] * (ncols + 1)
    for j in range(n):
        cost[j] = _fr(objective[j])
        cost[n + j] = -_fr(objective[j])
    return _simplex_core(T, basis, cost, ncols)


def _phase1(A, b, n):
    m = len(A)
    ncols = 2 * n + m + m  # xp, xm, slacks, artificials
    T = [[Fraction(0)] * (ncols + 1) for _ in range(m)]
    basis = []
    for i in range(m):
        sgn = 1 if b[i] >= 0 else -1
        for j in range(n):
            T[i][j] = sgn * A[i][j]
            T[i][n + j] = -sgn * A[i][j]
        T[i][2 * n + i] = Fraction(sgn)
        T[i][2 * n + m + i] = Fraction(1)
        T[i][ncols] = sgn * b[i]
        basis.append(2 * n + m + i)
    cost = [Fraction(0)] * (ncols + 1)
    for i in range(m):
        cost[2 * n + m + i] = Fraction(-1)
    status, val = _simplex_core(T, basis, cost, ncols)
    if status != "optimal" or val != 0:
        return "infeasible", None, None, None, None
    # drive artificials out of basis when possible; then drop them
    for i in range(m):
        if basis[i] >= 2 * n + m:
            for j in range(2 * n + m):
                if T[i][j] != 0:
                    _pivot(T, basis, i, j)
                    break
    keep = 2 * n + m
    T2 = [row[:keep] + [row[-1]] for row in T]
    basis2 = list(basis)
    rows_keep = [i for i in range(m) if basis2[i] < keep]
    T2 = [T2[i] for i in rows_keep]
    basis2 = [basis2[i] for i in rows_keep]
    return "feasible", Fraction(0), T2, basis2, keep


def _pivot(T, basis, r, c):
    piv = T[r][c]
    T[r] = [v / piv for v in T[r]]
    for i in range(len(T)):
        if i != r and T[i][c] != 0:
            f = T[i][c]
            T[i] = [a - f * b for a, b in zip(T[i], T[r])]
    basis[r] = c


def _simplex_core(T, basis, cost, ncols):
    """Maximize cost.x given tableau T with feasible basis. Bland's rule."""
    m = len(T)
    # reduced cost row
    z = list(cost)
    for i in range(m):
        cb = cost[basis[i]]
        if cb != 0:
            for j in range(ncols + 1):
                z[j] -= cb * T[i][j]
    it = 0
    while True:
        it += 1
        if it > 20000:
            raise RuntimeError("simplex iteration limit")
        # entering: Bland — smallest index with positive reduced cost
        e = -1
        for j in range(ncols):
            if z[j] > 0:
                e = j
                break
        if e == -1:
            return "optimal", -z[ncols]
        # ratio test
        r = -1
        best: Optional[Fraction] = None
        for i in range(m):
            if T[i][e] > 0:
                ratio = T[i][ncols] / T[i][e]
                if best is None or ratio < best or (
                    ratio == best and basis[i] < basis[r]
                ):
                    best = ratio
                    r = i
        if r == -1:
            return "unbounded", None
        _pivot(T, basis, r, e)
        cb = z[e]
        if cb != 0:
            z = [a - cb * bb for a, bb in zip(z, T[r])]


# ------------------------------------------------------------ convex body


@dataclass
class ConvexPolytope:
    """d + A.x >= 0 inequality rows, d + A.x = 0 equality rows."""

    inequalities: List[Row] = field(default_factory=list)
    equalities: List[Row] = field(default_factory=list)
    name: str = ""

    @classmethod
    def make(cls, ineqs=(), eqs=(), name=""):
        def keep(rows):
            out = []
            for r in rows:
                nr = _normalize_row(r)
                if any(c != 0 for c in nr):
                    out.append(nr)
            return out

        return cls(inequalities=keep(ineqs), equalities=keep(eqs), name=name)

    @property
    def dim(self) -> int:
        rows = self.inequalities + self.equalities
        return (len(rows[0]) - 1) if rows else 0

    def contains(self, point: Sequence, tol: Fraction = Fraction(0)) -> bool:
        p = [_fr(x) for x in point]
        for row in self.equalities:
            v = row[0] + sum(c * x for c, x in zip(row[1:], p))
            if v != 0 and abs(v) > tol:
                return False
        for row in self.inequalities:
            v = row[0] + sum(c * x for c, x in zip(row[1:], p))
            if v < -tol:
                return False
        return True

    def is_empty(self) -> bool:
        if not self.inequalities and not self.equalities:
            return False
        n = self.dim
        status, _ = lp_max([Fraction(0)] * n, self.inequalities, self.equalities)
        return status == "infeasible"

    def intersect(self, other: "ConvexPolytope") -> "ConvexPolytope":
        return ConvexPolytope(
            inequalities=self.inequalities + other.inequalities,
            equalities=self.equalities + other.equalities,
            name=f"{self.name}&{other.name}",
        )

    def reduce(self) -> Optional["ConvexPolytope"]:
        """Remove redundant inequalities and promote implied equalities
        (critical: downstream Fourier-Motzkin substitutes equalities instead
        of blowing up); None if empty. Exact LP per row."""
        # dedupe, drop trivial rows
        ineqs = [r for r in dict.fromkeys(self.inequalities) if any(c != 0 for c in r[1:])]
        eqs = [r for r in dict.fromkeys(self.equalities) if any(c != 0 for c in r[1:])]
        # both passes in the C++ core, or below where it overflows int64
        n = (len(ineqs[0]) - 1) if ineqs else (len(eqs[0]) - 1 if eqs else 0)
        res = native.reduce_native(ineqs, eqs, n) if n else None
        if res is not None:
            keep, eqf, empty = res
            if empty:
                return None
            new_eqs = eqs + [r for r, f in zip(ineqs, eqf) if f]
            kept = [r for r, k in zip(ineqs, keep) if k]
            return ConvexPolytope(
                inequalities=kept,
                equalities=list(dict.fromkeys(new_eqs)),
                name=self.name,
            )
        if self.is_empty():
            return None
        # pass 1: implied equalities — row d + a.x >= 0 is an equality iff
        # max (d + a.x) over the polytope is 0
        still: List[Row] = []
        for row in ineqs:
            status, val = lp_max(list(row[1:]), ineqs, eqs)
            if status == "optimal" and row[0] + val == 0:
                eqs.append(row)
            else:
                still.append(row)
        eqs = list(dict.fromkeys(eqs))
        ineqs = still
        # pass 2: drop inequalities now redundant
        kept: List[Row] = []
        for i, row in enumerate(ineqs):
            others = kept + ineqs[i + 1 :]
            # row redundant iff min of (d + a.x) over others/eqs >= 0
            obj = [-c for c in row[1:]]
            status, val = lp_max(obj, others, eqs)
            if status == "unbounded":
                kept.append(row)
                continue
            if status == "optimal" and row[0] - val >= 0:
                continue  # redundant
            kept.append(row)
        return ConvexPolytope(inequalities=kept, equalities=eqs, name=self.name)

    def vertices(self) -> List[Tuple[Fraction, ...]]:
        """Enumerate vertices: all basic feasible solutions. Fine for n<=3
        with few dozen rows."""
        n = self.dim
        verts = set()
        # rank of the equality system decides how many active ineqs are
        # needed at a vertex
        eq_rank = n - len(_nullspace([list(r[1:]) for r in self.equalities], n)) if self.equalities else 0
        need = max(n - eq_rank, 0)
        for combo in itertools.combinations(range(len(self.inequalities)), min(need, len(self.inequalities))):
            active = [self.inequalities[i] for i in combo] + self.equalities
            if len(active) < n:
                continue
            pt = _solve_square(active, n)
            if pt is None:
                continue
            if self.contains(pt):
                verts.add(tuple(pt))
        return sorted(verts)


def _solve_square(rows: List[Row], n: int):
    """Solve d + A.x = 0 for x via exact Gaussian elimination; None if
    singular/inconsistent/underdetermined."""
    M = [list(r[1:]) + [-r[0]] for r in rows]
    m = len(M)
    piv_cols = []
    r = 0
    for c in range(n):
        sel = None
        for i in range(r, m):
            if M[i][c] != 0:
                sel = i
                break
        if sel is None:
            continue
        M[r], M[sel] = M[sel], M[r]
        pv = M[r][c]
        M[r] = [v / pv for v in M[r]]
        for i in range(m):
            if i != r and M[i][c] != 0:
                f = M[i][c]
                M[i] = [a - f * b for a, b in zip(M[i], M[r])]
        piv_cols.append(c)
        r += 1
        if r == m:
            break
    if len(piv_cols) < n:
        return None
    # check consistency of remaining rows
    for i in range(r, m):
        if all(v == 0 for v in M[i][:n]) and M[i][n] != 0:
            return None
    x = [Fraction(0)] * n
    for i, c in enumerate(piv_cols):
        x[c] = M[i][n]
    return x


def fourier_motzkin(
    ineqs: List[Row], eqs: List[Row], eliminate: Sequence[int], total_vars: int
) -> Tuple[List[Row], List[Row]]:
    """Eliminate the given variable indices (0-based into the coefficient
    part) from the system. Equalities are used for substitution first;
    remaining eliminations use FM with redundancy pruning."""
    ineqs = [tuple(r) for r in ineqs]
    eqs = [tuple(r) for r in eqs]
    elim = sorted(eliminate, reverse=True)
    keep_mask = [True] * total_vars

    def drop_col(rows, var):
        return [tuple(v for i, v in enumerate(r) if i != var + 1) for r in rows]

    for var in elim:
        col = var + 1
        # try substitution via an equality with nonzero coef
        sub = None
        for e in eqs:
            if e[col] != 0:
                sub = e
                break
        if sub is not None:
            eqs = [
                _normalize_row(
                    tuple(
                        r[i] - r[col] * sub[i] / sub[col]
                        for i in range(len(r))
                    )
                )
                for r in eqs
                if r is not sub
            ]
            ineqs = [
                _normalize_row(
                    tuple(
                        r[i] - r[col] * sub[i] / sub[col]
                        for i in range(len(r))
                    )
                )
                for r in ineqs
            ]
            eqs = drop_col(eqs, var)
            ineqs = drop_col(ineqs, var)
            continue
        pos = [r for r in ineqs if r[col] > 0]
        neg = [r for r in ineqs if r[col] < 0]
        zero = [r for r in ineqs if r[col] == 0]
        new = list(zero)
        for rp in pos:
            for rn in neg:
                comb = tuple(
                    rp[i] * (-rn[col]) + rn[i] * rp[col] for i in range(len(rp))
                )
                comb = _normalize_row(comb)
                if all(c == 0 for c in comb[1:]):
                    if comb[0] < 0:
                        # infeasible marker: keep a trivially false row
                        new.append(comb)
                    continue
                new.append(comb)
        ineqs = drop_col(new, var)
        eqs = drop_col(eqs, var)
        # prune duplicates cheaply
        ineqs = list(dict.fromkeys(ineqs))
    return ineqs, eqs


@dataclass
class Polytope:
    """Union of convex subpolytopes (the PU(4) center-shift structure)."""

    convex_subpolytopes: List[ConvexPolytope] = field(default_factory=list)

    def contains(self, point, tol: Fraction = Fraction(0)) -> bool:
        return any(c.contains(point, tol) for c in self.convex_subpolytopes)

    def reduce(self) -> "Polytope":
        out = []
        for c in self.convex_subpolytopes:
            r = c.reduce()
            if r is not None:
                out.append(r)
        # drop subpolytopes contained in another (cheap pairwise check)
        final = []
        for i, c in enumerate(out):
            dominated = False
            for j, d in enumerate(out):
                if i != j and not dominated:
                    if _convex_subset(c, d) and not (
                        j < i and _convex_subset(d, c)
                    ):
                        dominated = True
            if not dominated:
                final.append(c)
        return Polytope(final)

    def is_empty(self) -> bool:
        return all(c.is_empty() for c in self.convex_subpolytopes)


def _convex_subset(a: ConvexPolytope, b: ConvexPolytope) -> bool:
    """a subset of b: every vertex... exact check: max violation of each b-row
    over a is <= 0."""
    for row in b.equalities:
        # need d + c.x == 0 across all of a: max and min both equal -d
        obj = list(row[1:])
        st1, v1 = lp_max(obj, a.inequalities, a.equalities)
        st2, v2 = lp_max([-c for c in obj], a.inequalities, a.equalities)
        if st1 == "infeasible":
            return True  # a empty
        if st1 != "optimal" or st2 != "optimal":
            return False
        if row[0] + v1 != 0 or row[0] - v2 != 0:
            return False
    for row in b.inequalities:
        # need min over a of (d + c.x) >= 0  <=> max of -(c.x) <= d
        obj = [-c for c in row[1:]]
        status, val = lp_max(obj, a.inequalities, a.equalities)
        if status == "unbounded":
            return False
        if status == "infeasible":
            return True  # a empty
        if val > row[0]:
            return False
    return True


def convex_subtract(
    region: ConvexPolytope, sub: ConvexPolytope
) -> List[ConvexPolytope]:
    """Full-dimensional convex pieces of ``region \\ sub``, exact.

    Subtracting a convex S = intersect_i {row_i >= 0} from a convex region
    R yields the union over i of R & {row_1>=0,...,row_{i-1}>=0,
    row_i <= 0} — a DISJOINT decomposition (up to measure-zero boundary)
    because piece i requires the first i-1 rows to hold and the i-th to
    fail. Pieces that reduce() to empty or lower-dimensional sets are
    dropped. Shared by the coverage completeness check
    (coverage._union_covers) and the exact Haar union volumes
    (haar.disjoint_pieces).
    """
    if _convex_subset(region, sub):
        return []
    out: List[ConvexPolytope] = []
    prefix: List = []
    for row in sub.inequalities:
        neg = tuple(-c for c in row)
        piece = ConvexPolytope(
            inequalities=list(region.inequalities) + prefix + [neg],
            equalities=list(region.equalities),
            name=region.name,
        )
        red = piece.reduce()
        if red is not None and not red.equalities:
            out.append(red)
        prefix.append(row)
    return out


def convex_hull(points: Sequence[Sequence]) -> ConvexPolytope:
    """Exact H-representation of the hull of rational points in R^3 (or R^n,
    n<=3 used here). Facet enumeration over affinely independent subsets."""
    pts = [tuple(_fr(x) for x in p) for p in points]
    pts = list(dict.fromkeys(pts))
    n = len(pts[0])
    if len(pts) == 1:
        eqs = []
        for i in range(n):
            row = [pts[0][i]] + [Fraction(0)] * n
            row[1 + i] = Fraction(-1)
            eqs.append(tuple(row))
        return ConvexPolytope.make(eqs=eqs, name="hull-point")

    # affine hull: find equalities satisfied by all points
    eqs: List[Row] = []
    base = pts[0]
    diffs = [[p[i] - base[i] for i in range(n)] for p in pts[1:]]
    # nullspace of diffs
    ns = _nullspace(diffs, n)
    for v in ns:
        d = -sum(vi * bi for vi, bi in zip(v, base))
        eqs.append(_normalize_row((d, *v)))

    ineqs: List[Row] = []
    affdim = n - len(ns)
    # candidate facets: subsets of affdim points spanning a hyperplane within
    # the affine hull
    for combo in itertools.combinations(range(len(pts)), max(affdim, 1)):
        sel = [pts[i] for i in combo]
        normal_rows = [[sel[j][i] - sel[0][i] for i in range(n)] for j in range(1, len(sel))]
        normal_rows += [list(v) for v in ns]
        cand = _nullspace(normal_rows, n)
        for v in cand:
            d0 = -sum(vi * si for vi, si in zip(v, sel[0]))
            vals = [d0 + sum(vi * pi for vi, pi in zip(v, p)) for p in pts]
            if all(x >= 0 for x in vals):
                ineqs.append(_normalize_row((d0, *v)))
            elif all(x <= 0 for x in vals):
                ineqs.append(_normalize_row((-d0, *[-x for x in v])))
    hull = ConvexPolytope(
        inequalities=list(dict.fromkeys(ineqs)),
        equalities=list(dict.fromkeys(eqs)),
        name="hull",
    )
    r = hull.reduce()
    return r if r is not None else hull


def _nullspace(rows: List[List[Fraction]], n: int) -> List[Tuple[Fraction, ...]]:
    """Rational nullspace basis of a row matrix acting on R^n."""
    M = [list(r) for r in rows if any(x != 0 for x in r)]
    m = len(M)
    piv = []
    r = 0
    for c in range(n):
        sel = None
        for i in range(r, m):
            if M[i][c] != 0:
                sel = i
                break
        if sel is None:
            continue
        M[r], M[sel] = M[sel], M[r]
        pv = M[r][c]
        M[r] = [v / pv for v in M[r]]
        for i in range(m):
            if i != r and M[i][c] != 0:
                f = M[i][c]
                M[i] = [a - f * b for a, b in zip(M[i], M[r])]
        piv.append(c)
        r += 1
    free = [c for c in range(n) if c not in piv]
    basis = []
    for fc in free:
        v = [Fraction(0)] * n
        v[fc] = Fraction(1)
        for i, pc in enumerate(piv):
            v[pc] = -M[i][fc]
        basis.append(tuple(v))
    return basis
