"""Haar volumes and expected costs over monodromy polytopes, in closed form
(JAX coverage/haar.py; the numerics are carried over unchanged).

The magic-basis KAK is the AI symmetric space U(4)/O(4) (gamma = M M^T is
symmetric unitary), whose radial part has root multiplicity 1, so the Haar
pushforward density on alcove coordinates is

    rho(a)  proportional to  prod_{i<j} sin(pi (a_i - a_j))

(strictly positive in the alcove interior; the sqiSwap k=2 volume is
0.7901).

Volumes are computed in closed form, with the exponential expansion that
this density natively has:

* the sine product expands into <= 64 complex exponentials
  sum_m c_m e^{i pi m . x} with INTEGER frequency vectors m and rational
  coefficients c_m (``_density_terms``);
* over a 3-simplex, int_D e^{w.x} dx = 3! vol(D) * exp[z0,z1,z2,z3],
  the third divided difference of exp at the nodes z_j = w . v_j —
  evaluated branch-free and confluent-safe via the Opitz identity
  (divided difference = corner entry of expm of the bidiagonal node
  matrix, ``_expm_dd``). No quadrature truncation anywhere; the only
  error is float rounding of the closed form (~1e-14).
* unions decompose into DISJOINT convex pieces by exact region
  subtraction (polytope.convex_subtract, the machinery of the coverage
  completeness check), linear in the pieces produced.

Normalization: volume(EVERYTHING_POLYTOPE) == 1.
"""

from __future__ import annotations

import itertools
from fractions import Fraction
from typing import List, Sequence

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.coverage.polytope import (
    ConvexPolytope,
    Polytope,
    convex_subtract,
)
from slam_decomposition_torch.opt.samplers import haar_sample

# ---------------------------------------------------------------------------
# density as a finite exponential sum
# ---------------------------------------------------------------------------

# reduced-coordinate frequency of (a_i - a_j) for the 6 pairs i<j, with
# a = (x1, x2, x3, -(x1+x2+x3)):
_M_PAIRS = np.array(
    [
        [1, -1, 0],  # a1 - a2
        [1, 0, -1],  # a1 - a3
        [2, 1, 1],  # a1 - a4
        [0, 1, -1],  # a2 - a3
        [1, 2, 1],  # a2 - a4
        [1, 1, 2],  # a3 - a4
    ]
)

_DENSITY_TERMS = None


def _density_terms():
    """rho(x) = sum_m c_m e^{i pi m.x}: merged frequency/coefficient table.

    sin t = sum_{s=+-1} s e^{i s t} / (2i), so the 6-factor product is
    (2i)^-6 sum over sign patterns; (2i)^6 = -64, all coefficients are
    rational (multiples of -1/64) and merge across patterns with equal
    total frequency. Returns (M (T,3) int, C (T,) float)."""
    global _DENSITY_TERMS
    if _DENSITY_TERMS is None:
        acc = {}
        for signs in itertools.product((1, -1), repeat=6):
            m = tuple(int(v) for v in (np.array(signs) @ _M_PAIRS))
            prod = 1
            for s in signs:
                prod *= s
            acc[m] = acc.get(m, Fraction(0)) + Fraction(prod, -64)
        items = [(m, c) for m, c in acc.items() if c != 0]
        M = np.array([m for m, _ in items], dtype=np.int64)
        C = np.array([float(c) for _, c in items])
        _DENSITY_TERMS = (M, C)
    return _DENSITY_TERMS


def haar_density(pts3: np.ndarray) -> np.ndarray:
    """rho at reduced coordinates (..., 3); unnormalized."""
    a = np.concatenate([pts3, -pts3.sum(axis=-1, keepdims=True)], axis=-1)
    p = np.ones(a.shape[:-1])
    for i in range(4):
        for j in range(i + 1, 4):
            p = p * np.sin(np.pi * (a[..., i] - a[..., j]))
    return np.abs(p)


# ---------------------------------------------------------------------------
# closed-form simplex integrals
# ---------------------------------------------------------------------------


def _expm_dd(z: np.ndarray) -> np.ndarray:
    """Third divided difference of exp at nodes z (..., 4) — the Opitz
    identity: exp[z0..z3] = expm(Z)[0, 3] for the upper-bidiagonal node
    matrix Z, which is exact under node confluence (no distinct-node
    branch needed). Batched scaling-and-squaring Taylor; nodes here are
    purely imaginary with |z| <= ~8 pi, so the scaled series converges to
    machine precision in < 20 terms."""
    z = np.asarray(z, dtype=complex)
    Z = np.zeros(z.shape[:-1] + (4, 4), dtype=complex)
    idx = np.arange(4)
    Z[..., idx, idx] = z
    Z[..., idx[:-1], idx[:-1] + 1] = 1.0
    nrm = float(np.abs(z).max()) + 1.0 if z.size else 1.0
    s = max(0, int(np.ceil(np.log2(nrm))) + 1)
    A = Z / (2.0**s)
    eye = np.zeros_like(A)
    eye[..., idx, idx] = 1.0
    term = eye.copy()
    out = eye.copy()
    for k in range(1, 21):
        term = term @ A / k
        out = out + term
    for _ in range(s):
        out = out @ out
    return out[..., 0, 3]


def _facet_fan(cp: ConvexPolytope, verts: List[tuple]) -> np.ndarray:
    """(S, 4, 3) simplices coning the centroid over fan-triangulated
    facets — the exact-arithmetic fallback when Qhull rejects the vertex
    set (degenerate/flat configurations). Facet membership is decided in
    exact rationals; only the angular ordering within each (convex) facet
    polygon uses floats, which cannot change the triangulation's union."""
    pts = np.array([[float(x) for x in v] for v in verts])
    apex = pts.mean(axis=0)
    simplices = []
    seen = set()
    for row in cp.inequalities:
        on = [
            i
            for i, v in enumerate(verts)
            if row[0] + sum(c * x for c, x in zip(row[1:], v)) == 0
        ]
        key = frozenset(on)
        if len(on) < 3 or key in seen:
            continue
        seen.add(key)
        fp = pts[on]
        c = fp.mean(axis=0)
        nrm = np.array([float(x) for x in row[1:]])
        b1 = fp[0] - c
        b1n = np.linalg.norm(b1)
        if b1n < 1e-300:
            continue
        b1 = b1 / b1n
        b2 = np.cross(nrm, b1)
        b2n = np.linalg.norm(b2)
        if b2n < 1e-300:
            continue
        b2 = b2 / b2n
        ang = np.arctan2((fp - c) @ b2, (fp - c) @ b1)
        order = np.argsort(ang)
        f0 = fp[order[0]]
        for a, b in zip(order[1:-1], order[2:]):
            simplices.append(np.stack([apex, f0, fp[a], fp[b]]))
    if not simplices:
        return np.zeros((0, 4, 3))
    return np.stack(simplices)


def _triangulate(cp: ConvexPolytope) -> np.ndarray:
    """(S, 4, 3) simplex decomposition of a full-dimensional convex piece."""
    verts = cp.vertices()
    if len(verts) < 4:
        return np.zeros((0, 4, 3))
    pts = np.array([[float(x) for x in v] for v in verts])
    try:
        from scipy.spatial import Delaunay

        tri = Delaunay(pts)
        return pts[tri.simplices]
    except Exception:
        # Qhull precision rejection on near-degenerate sets: exact fan
        return _facet_fan(cp, verts)


def convex_volume(cp: ConvexPolytope) -> float:
    """Haar-weighted (unnormalized) volume of one convex piece, closed
    form. The density's sign is constant on any convex subset of the
    alcove (each sine factor vanishes only on alcove walls), so the
    per-piece absolute value recovers |rho| exactly."""
    simplices = _triangulate(cp)
    if len(simplices) == 0:
        return 0.0
    v0 = simplices[:, 0]
    edges = simplices[:, 1:] - v0[:, None, :]
    vol6 = np.abs(np.linalg.det(edges))  # (S,) == 6 * euclidean volume
    keep = vol6 > 1e-300
    if not keep.any():
        return 0.0
    simplices, vol6 = simplices[keep], vol6[keep]
    M, C = _density_terms()
    # nodes z[t, s, j] = i pi m_t . v_{s,j}
    z = 1j * np.pi * np.einsum("ti,svi->tsv", M, simplices)
    dd = _expm_dd(z)  # (T, S)
    total = np.einsum("t,ts,s->", C, dd, vol6)
    return float(abs(total.real) + 0.0)


def convex_volume_cubature(cp: ConvexPolytope, order: int = 14) -> float:
    """Gauss-Legendre cubature cross-check of :func:`convex_volume` (the
    round-2 production path, retained as an independent test oracle)."""
    gx, gw = np.polynomial.legendre.leggauss(order)
    gx = (gx + 1) / 2
    gw = gw / 2
    simplices = _triangulate(cp)
    total = 0.0
    for verts in simplices:
        v0, v1, v2, v3 = verts
        vol6 = abs(np.linalg.det(np.stack([v1 - v0, v2 - v0, v3 - v0])))
        if vol6 < 1e-300:
            continue
        u1, u2, u3 = np.meshgrid(gx, gx, gx, indexing="ij")
        w = gw[:, None, None] * gw[None, :, None] * gw[None, None, :] * (u1**2) * u2
        t1, t2, t3 = u1, u1 * u2, u1 * u2 * u3
        x = (
            v0[None, None, None, :] * (1 - t1)[..., None]
            + v1 * (t1 - t2)[..., None]
            + v2 * (t2 - t3)[..., None]
            + v3 * t3[..., None]
        )
        total += float(vol6 * (w * haar_density(x)).sum())
    return total


def disjoint_pieces(p: Polytope) -> List[ConvexPolytope]:
    """Decompose a union of convex subpolytopes into DISJOINT
    full-dimensional convex pieces (exact region subtraction): piece set
    of sub_i minus union(sub_1..sub_{i-1})."""
    pieces: List[ConvexPolytope] = []
    prior: List[ConvexPolytope] = []
    for sub in p.convex_subpolytopes:
        red = sub.reduce()
        if red is None or red.equalities:
            continue
        regions = [red]
        for prev in prior:
            regions = [
                piece
                for region in regions
                for piece in convex_subtract(region, prev)
            ]
            if not regions:
                break
        pieces.extend(regions)
        prior.append(red)
    return pieces


def polytope_volume(p: Polytope) -> float:
    """Union volume: sum of closed-form volumes over the disjoint convex
    decomposition."""
    return sum(convex_volume(piece) for piece in disjoint_pieces(p))


_EVERYTHING_VOLUME = None


def normalized_volume(p: Polytope) -> float:
    """Haar probability mass of p (both-center-image convention)."""
    global _EVERYTHING_VOLUME
    if _EVERYTHING_VOLUME is None:
        from slam_decomposition_torch.coverage.coverage import EVERYTHING_POLYTOPE

        _EVERYTHING_VOLUME = polytope_volume(EVERYTHING_POLYTOPE)
    return polytope_volume(p) / _EVERYTHING_VOLUME


_HAAR_COORD_CACHE = {}


def haar_monodromy_samples(n: int = 200_000, seed: int = 0, device=None) -> np.ndarray:
    """(n, 2, 3) reduced monodromy coordinates (both center images) of Haar
    2Q unitaries, for Monte-Carlo volumes of polytopes too facet-rich for
    exact integration: haar_sample(20000, seed=seed + s) per chunk starting
    at s (the JAX package's draws), coordinates in f64 on ``device`` (the
    card unless the caller names another)."""
    from slam_decomposition_torch.coverage.coverage import monodromy_reps_float

    device = resolve_device(DEFAULT_DEVICE if device is None else device)
    key = (n, seed, str(device))
    if key not in _HAAR_COORD_CACHE:
        chunk = 20_000
        out = [
            monodromy_reps_float(haar_sample(min(chunk, n - s), seed=seed + s), device)[:, :, :3]
            for s in range(0, n, chunk)
        ]
        _HAAR_COORD_CACHE[key] = np.concatenate(out)
    return _HAAR_COORD_CACHE[key]


def mc_volume(polytope: Polytope, n: int = 200_000, seed: int = 0, tol=1e-9, device=None) -> float:
    """Haar mass of a polytope by direct Haar Monte-Carlo: fraction of
    samples with EITHER center image inside (float row evaluation)."""
    samples = haar_monodromy_samples(n, seed, device)
    member = np.zeros(len(samples), dtype=bool)
    for cp in polytope.convex_subpolytopes:
        rows = np.array(
            [[float(c) for c in r] for r in cp.inequalities], dtype=float
        )
        eqs = np.array(
            [[float(c) for c in r] for r in cp.equalities], dtype=float
        )
        for img in range(2):
            pts = samples[:, img, :]
            ok = np.ones(len(pts), dtype=bool)
            for r in rows:
                ok &= (r[0] + pts @ r[1:]) >= -tol
            for r in eqs:
                ok &= np.abs(r[0] + pts @ r[1:]) <= tol
            member |= ok
    return float(member.mean())


def expected_cost(coverage: Sequence, chatty: bool = False) -> float:
    """Haar-expected synthesis cost of a coverage set: sum over layers of
    cost_k * (V_k - V_{k-1}) assuming nested layers (the construction is
    monotone)."""
    layers = sorted(coverage, key=lambda c: c.cost)
    total = 0.0
    prev = 0.0
    for cp in layers:
        if cp.cost == 0:
            continue
        v = normalized_volume(cp.polytope)
        v = min(max(v, prev), 1.0)
        total += cp.cost * (v - prev)
        if chatty:
            print(f"  cost {cp.cost}: volume {v:.6f} (+{v - prev:.6f})")
        prev = v
    if prev < 1.0 - 1e-6:
        raise ValueError(
            f"coverage set incomplete: total volume {prev:.6f} < 1 "
            "(gate set cannot span the chamber)"
        )
    return total
