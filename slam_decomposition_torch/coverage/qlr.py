"""Quantum Littlewood-Richardson coefficients and the Agnihotri-Woodward
monodromy inequalities for SU(4), computed from first principles (a copy
of the JAX package's coverage/qlr.py, which imports no jax).

The external ``monodromy`` package ships a precomputed qLR table; here the
table is generated: classical LR coefficients by direct tableau counting,
quantum reduction via the n-core abacus (beta-numbers) with sign
(-1)^{inversions + d(r-1)} (validated against known QH*(Gr(r,4)) products:
sigma_2 * sigma_11 = q, sigma_2 * sigma_2 = sigma_22,
sigma_21 * sigma_21 = q(sigma_2 + sigma_11), and full S3 symmetry of the
Gromov-Witten invariants).

Inequalities (Agnihotri-Woodward / Belkale): for SU(n) elements with
A B C = 1 and alcove coordinates a, b, c (sorted descending, sum 0,
a1 - an <= 1), for every r, d and partition triple with GW invariant
<sigma_lam, sigma_mu, sigma_rho>_d = 1:

    sum_{i in I(lam)} a_i + sum_{j in I(mu)} b_j + sum_{k in I(rho)} c_k <= d

with I(lam) = { (n-r) + s - lam_s : s = 1..r } (1-indexed row positions).
"""

from __future__ import annotations

import itertools
from functools import lru_cache
from typing import Dict, List, Tuple

N = 4  # SU(4)

Partition = Tuple[int, ...]


def _pad(p: Partition, r: int) -> Partition:
    return tuple(list(p) + [0] * (r - len(p)))[:r]


@lru_cache(maxsize=None)
def lr_coefficient(lam: Partition, mu: Partition, nu: Partition) -> int:
    """Classical LR coefficient c^nu_{lam mu}: LR skew tableaux of shape
    nu/lam and weight mu (column-strict, row-weak, reverse-reading lattice
    word)."""
    if sum(nu) != sum(lam) + sum(mu):
        return 0
    rows = len(nu)
    lam = _pad(lam, rows)
    if any(nu[i] < lam[i] for i in range(rows)):
        return 0
    # cells to fill, in reading order: top-to-bottom rows, RIGHT-to-left
    cells = []
    for i in range(rows):
        for j in range(nu[i] - 1, lam[i] - 1, -1):
            cells.append((i, j))

    mu = tuple(mu)
    count = 0
    grid: Dict[Tuple[int, int], int] = {}

    def backtrack(idx: int, weight: List[int], word_counts: List[int]):
        nonlocal count
        if idx == len(cells):
            if tuple(weight) == tuple(mu + (0,) * (len(weight) - len(mu))):
                count += 1
            return
        i, j = cells[idx]
        for v in range(1, len(mu) + 1):
            # weight bound
            if weight[v - 1] + 1 > (mu[v - 1] if v - 1 < len(mu) else 0):
                continue
            # lattice: after placing v, #v <= #(v-1)
            if v > 1 and word_counts[v - 1] + 1 > word_counts[v - 2]:
                continue
            # row weakly increasing left-to-right: cell to the right (j+1)
            right = grid.get((i, j + 1))
            if right is not None and v > right:
                continue
            # column strictly increasing downward: cell above (i-1, j);
            # a cell of lam (absent from grid) imposes no constraint
            if i > 0:
                above = grid.get((i - 1, j))
                if above is not None and v <= above:
                    continue
            grid[(i, j)] = v
            weight[v - 1] += 1
            word_counts[v - 1] += 1
            backtrack(idx + 1, weight, word_counts)
            word_counts[v - 1] -= 1
            weight[v - 1] -= 1
            del grid[(i, j)]

    backtrack(0, [0] * len(mu), [0] * len(mu))
    return count


def partitions_in_box(r: int, c: int):
    """All partitions fitting in an r x c box."""
    out = []

    def rec(prefix, maxpart):
        if len(prefix) == r:
            out.append(tuple(prefix))
            return
        for p in range(min(maxpart, c), -1, -1):
            rec(prefix + [p], p)

    rec([], c)
    return [tuple(x for x in p if x > 0) for p in out]


def _partitions_rows_sum(r: int, total: int, maxpart: int):
    """Partitions with <= r rows summing to total, parts <= maxpart."""
    out = []

    def rec(prefix, remaining, mx):
        if len(prefix) == r:
            if remaining == 0:
                out.append(tuple(prefix))
            return
        for p in range(min(mx, remaining), -1, -1):
            rec(prefix + [p], remaining - p, p)

    rec([], total, maxpart)
    return [tuple(x for x in p if x > 0) for p in out]


def quantum_reduce(nu_prime: Partition, r: int, n: int = N):
    """Abacus reduction of an r-row partition modulo n-rim-hooks.

    Returns (nu, d, sign) or None if the coefficient vanishes
    (beta-residue collision)."""
    beta = [(_pad(nu_prime, r)[i] + r - 1 - i) for i in range(r)]
    residues = [b % n for b in beta]
    if len(set(residues)) < r:
        return None
    d = sum((b - (b % n)) // n for b in beta)
    reduced = residues
    # sort descending, count inversions of the sorting permutation
    order = sorted(range(r), key=lambda i: -reduced[i])
    inversions = 0
    for x in range(r):
        for y in range(x + 1, r):
            if order[x] > order[y]:
                inversions += 1
    sorted_beta = [reduced[i] for i in order]
    nu = tuple(sorted_beta[i] - (r - 1 - i) for i in range(r))
    if any(x < 0 for x in nu):
        return None
    sign = (-1) ** (inversions + d * (r - 1))
    return tuple(x for x in nu if x > 0), d, sign


@lru_cache(maxsize=None)
def quantum_lr(lam: Partition, mu: Partition, r: int, n: int = N) -> Dict:
    """Quantum product sigma_lam * sigma_mu in QH*(Gr(r, n)): returns
    {(nu, d): coefficient}."""
    total = sum(lam) + sum(mu)
    out: Dict[Tuple[Partition, int], int] = {}
    for nu_prime in _partitions_rows_sum(r, total, total):
        c = lr_coefficient(lam, mu, nu_prime)
        if c == 0:
            continue
        red = quantum_reduce(nu_prime, r, n)
        if red is None:
            continue
        nu, d, sign = red
        if _pad(nu, r)[0] > n - r:
            continue
        key = (nu, d)
        out[key] = out.get(key, 0) + sign * c
    return {k: v for k, v in out.items() if v != 0}


def complement(p: Partition, r: int, c: int) -> Partition:
    """Complement in the r x c box (Poincare dual)."""
    pp = _pad(p, r)
    return tuple(x for x in (c - pp[r - 1 - i] for i in range(r)) if x > 0)


@lru_cache(maxsize=None)
def gw_invariant(lam: Partition, mu: Partition, rho: Partition, d: int, r: int, n: int = N) -> int:
    """<sigma_lam, sigma_mu, sigma_rho>_d = coefficient of q^d sigma_{rho^c}
    in sigma_lam * sigma_mu."""
    prod = quantum_lr(lam, mu, r, n)
    return prod.get((complement(rho, r, n - r), d), 0)


def index_set(lam: Partition, r: int, n: int = N) -> Tuple[int, ...]:
    """I(lam) = { (n-r) + s - lam_s } (1-indexed, strictly increasing)."""
    lp = _pad(lam, r)
    return tuple((n - r) + s - lp[s - 1] for s in range(1, r + 1))


@lru_cache(maxsize=None)
def qlr_inequalities(n: int = N) -> List[Tuple[int, Tuple[int, ...], Tuple[int, ...], Tuple[int, ...]]]:
    """The master list: (d, I, J, K) with the inequality

        sum_{i in I} a_i + sum_{j in J} b_j + sum_{k in K} c_k <= d

    for alcove coordinates of A, B, C with A B C = 1. Only GW = 1 triples
    (Belkale: these suffice and are irredundant)."""
    out = []
    for r in range(1, n):
        box = partitions_in_box(r, n - r)
        dim = r * (n - r)
        for lam, mu, rho in itertools.product(box, repeat=3):
            tot = sum(lam) + sum(mu) + sum(rho)
            if (tot - dim) % n != 0:
                continue
            d = (tot - dim) // n
            if d < 0:
                continue
            if gw_invariant(lam, mu, rho, d, r, n) == 1:
                out.append(
                    (d, index_set(lam, r, n), index_set(mu, r, n), index_set(rho, r, n))
                )
    return out
