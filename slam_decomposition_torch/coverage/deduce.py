"""deduce_qlr_consequences: project the Agnihotri-Woodward polytope.

Given polytopes for the monodromy coordinates of A and B, compute the
polytope of coordinates of C = A.B (up to local gates). This is the engine
behind coverage construction (JAX coverage/deduce.py, which imports no
jax; the row order of every step is kept, so the sets built here equal the
JAX package's row for row).

Pipeline per (subpolytope_A, subpolytope_B) pair:
  1. assemble the joint system over (a1..a3, b1..b3, c1..c3) — input rows,
     alcove constraints for all three factors, and the 72 QLR inequalities
     (with gamma(C^-1) written in terms of c);
  2. drop clearly-redundant rows with a fast float LP (scipy HiGHS) —
     conservative slack threshold, keeps anything borderline;
  3. Fourier-Motzkin eliminate the 6 (a, b) variables, float-pruning
     between steps;
  4. exact-rational reduction of the final c-system.

The result is the union over pairs (this is where the PU(4) center-shift
subpolytopes proliferate and then get pruned).
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Sequence

import numpy as np

from slam_decomposition_torch.coverage.polytope import (
    ConvexPolytope,
    Polytope,
    Row,
    fourier_motzkin,
)
from slam_decomposition_torch.coverage.qlr import qlr_inequalities

NV = 9  # a1..a3, b1..b3, c1..c3


def _alcove_rows(offset: int) -> List[Row]:
    """Alcove constraints for a factor whose 3 reduced coords start at
    ``offset``: v1>=v2>=v3>=v4=-(v1+v2+v3), v1-v4<=1."""
    rows = []

    def row(d, coefs):
        r = [Fraction(d)] + [Fraction(0)] * NV
        for idx, c in coefs:
            r[1 + offset + idx] = Fraction(c)
        return tuple(r)

    rows.append(row(0, [(0, 1), (1, -1)]))  # v1 - v2 >= 0
    rows.append(row(0, [(1, 1), (2, -1)]))  # v2 - v3 >= 0
    rows.append(row(0, [(0, 1), (1, 1), (2, 2)]))  # v3 - v4 >= 0
    rows.append(row(1, [(0, -2), (1, -1), (2, -1)]))  # v1 - v4 <= 1
    return rows


def _gamma_c_coeffs():
    """gamma(C^{-1})_k in terms of (c1, c2, c3) of C=AB:
    gamma1 = c1+c2+c3, gamma2 = -c3, gamma3 = -c2, gamma4 = -c1."""
    return {
        1: [(0, 1), (1, 1), (2, 1)],
        2: [(2, -1)],
        3: [(1, -1)],
        4: [(0, -1)],
    }


def _qlr_rows() -> List[Row]:
    rows = []
    gc = _gamma_c_coeffs()
    for d, I, J, K in qlr_inequalities():
        r = [Fraction(d)] + [Fraction(0)] * NV
        for i in I:  # a_i with a4 = -(a1+a2+a3)
            if i <= 3:
                r[1 + (i - 1)] -= 1
            else:
                r[1] += 1
                r[2] += 1
                r[3] += 1
        for j in J:
            if j <= 3:
                r[4 + (j - 1)] -= 1
            else:
                r[4] += 1
                r[5] += 1
                r[6] += 1
        for k in K:
            for idx, c in gc[k]:
                r[7 + idx] -= c
        rows.append(tuple(r))
    return rows


_QLR_ROWS = None


def _lift_rows(rows: Sequence[Row], offset: int) -> List[Row]:
    out = []
    for r in rows:
        nr = [r[0]] + [Fraction(0)] * NV
        for i, c in enumerate(r[1:]):
            nr[1 + offset + i] = c
        out.append(tuple(nr))
    return out


def _float_prune(ineqs: List[Row], eqs: List[Row], tol: float = 1e-9):
    """Drop rows whose minimum slack over the rest is >= -tol (redundant,
    INCLUDING touching ties — keeping ties is what makes Fourier-Motzkin
    output explode), via scipy HiGHS on unit-normalized rows. The final
    exact reduce() re-verifies the small surviving system, so a borderline
    float misjudgment here only risks keeping noise, never unsoundness of
    the exact endpoint.
    """
    ineqs = list(dict.fromkeys(ineqs))
    if len(ineqs) < 8:
        return ineqs
    from scipy.optimize import linprog

    def as_np(rows):
        A = np.array([[float(c) for c in r[1:]] for r in rows], dtype=float)
        d = np.array([float(r[0]) for r in rows], dtype=float)
        nrm = np.maximum(np.sqrt((A * A).sum(axis=1)), 1e-30)
        return A / nrm[:, None], d / nrm

    A, d = as_np(ineqs)
    if eqs:
        Ae, de = as_np(eqs)
    else:
        Ae, de = None, None
    n = A.shape[1]
    # fast vectorized pre-filter: a row strictly dominated by another
    # identical-direction row with larger offset is redundant
    mask = np.ones(len(ineqs), bool)
    order = np.lexsort(np.round(A.T * 1e12, 0))
    for a_idx in range(len(order) - 1):
        i, j = order[a_idx], order[a_idx + 1]
        if np.allclose(A[i], A[j], atol=1e-12):
            if d[i] >= d[j]:
                mask[i] = False
            else:
                mask[j] = False
    keep = []
    for i in range(len(ineqs)):
        if not mask[i]:
            continue
        mask[i] = False
        rest = mask.copy()
        for k in keep:
            rest[k] = True
        res = linprog(
            A[i],
            A_ub=-A[rest],
            b_ub=d[rest],
            A_eq=Ae,
            b_eq=-de if de is not None else None,
            bounds=[(None, None)] * n,
            method="highs",
        )
        redundant = res.status == 0 and (d[i] + res.fun) > -tol
        if not redundant:
            keep.append(i)
            mask[i] = True
    return [ineqs[i] for i in keep]


def deduce_qlr_consequences(a_poly: Polytope, b_poly: Polytope) -> Polytope:
    """Polytope of monodromy coordinates of A.B."""
    global _QLR_ROWS
    if _QLR_ROWS is None:
        _QLR_ROWS = _qlr_rows()

    base_ineqs = list(_QLR_ROWS) + _alcove_rows(0) + _alcove_rows(3) + _alcove_rows(6)
    out_subs: List[ConvexPolytope] = []
    for sa in a_poly.convex_subpolytopes:
        for sb in b_poly.convex_subpolytopes:
            ineqs = (
                base_ineqs
                + _lift_rows(sa.inequalities, 0)
                + _lift_rows(sb.inequalities, 3)
            )
            eqs = _lift_rows(sa.equalities, 0) + _lift_rows(sb.equalities, 3)
            cur_i, cur_e = ineqs, eqs
            total = NV
            # substitute equality-backed variables first (cheap, no blowup),
            # then float-prune once before the genuine FM eliminations
            order = [5, 4, 3, 2, 1, 0]
            subst = [
                v for v in order if any(e[1 + v] != 0 for e in cur_e)
            ]
            rest = [v for v in order if v not in subst]
            for var in sorted(subst, reverse=True):
                cur_i, cur_e = fourier_motzkin(cur_i, cur_e, [var], total)
                total -= 1
                # renumber remaining elimination targets above var
                rest = [v - 1 if v > var else v for v in rest]
            cur_i = _float_prune(cur_i, cur_e)
            for var in sorted(rest, reverse=True):
                cur_i, cur_e = fourier_motzkin(cur_i, cur_e, [var], total)
                total -= 1
                cur_i = _float_prune(cur_i, cur_e)
            # detect infeasible marker rows (0 >= positive const violated)
            infeasible = any(
                all(c == 0 for c in r[1:]) and r[0] < 0 for r in cur_i
            )
            if infeasible:
                continue
            cur_i = [r for r in cur_i if any(c != 0 for c in r[1:]) or r[0] != 0]
            sub = ConvexPolytope(
                inequalities=list(dict.fromkeys(cur_i)),
                equalities=list(dict.fromkeys(cur_e)),
                name=f"({sa.name})*({sb.name})",
            )
            red = sub.reduce()
            if red is not None:
                out_subs.append(red)
    return Polytope(out_subs).reduce()
