"""Deterministic KAK (Cartan) decomposition and analytic sqrt(iSwap)
synthesis (JAX transpile/kak.py, host numpy, unchanged). This exact
per-block routine is the contract the batched synthesis
(transpile/batch_synth.py) is held to, and its fallback.

Replaces the reference's randomized-retry KAK (weyl_decompose.py:207-330,
"FIXME: this randomized algorithm is horrendous") with Cardoso joint
diagonalization, an exact phase-lift, and explicit tracked Weyl moves.

Key conventions (derived in ops/weyl.py): in the magic basis, CAN(t) =
expm(i (tx XX + ty YY + tz ZZ)) is diag(e^{i V_k . t}) — and since the V_k
rows span the zero-sum subspace, ANY zero-sum phase vector is exactly some
CAN(t): no eigenvalue-slot matching is ever needed.

The sqrt(iSwap) 2-application region and interleaving rotations follow
Huang et al. (arXiv:2105.06074; reference weyl_decompose.py:343-410). The
3-application canonicalization is derived fresh: one SQiSW splits off
EXACTLY via CAN(t) = CAN(t - (pi/8, pi/8, 0)) . SQiSW (commuting
generators), searching tracked Weyl variants until the remainder lies in
the 2-application region. (The reference's own canonicalize,
weyl_decompose.py:412-449, does not satisfy its composition identity — it
was only ever used for gate counting.)
"""

from __future__ import annotations

import cmath
import itertools
from typing import List, Tuple

import numpy as np

from slam_decomposition_torch.ops.weyl import MAGIC

_B = MAGIC
PI = np.pi
PI2 = np.pi / 2
PI4 = np.pi / 4
PI8 = np.pi / 8

_PAULI = {
    0: np.array([[0, 1], [1, 0]], dtype=complex),
    1: np.array([[0, -1j], [1j, 0]]),
    2: np.diag([1.0 + 0j, -1.0]),
}
_I2 = np.eye(2, dtype=complex)
_V_ROWS = np.array([[1, -1, 1], [1, 1, -1], [-1, -1, -1], [-1, 1, 1]], dtype=float)


def can_matrix(a, b, c):
    """CAN(a,b,c) = expm(i(a XX + b YY + c ZZ)) via the magic-diagonal form."""
    t = np.array([a, b, c], dtype=float)
    ph = np.exp(1j * (_V_ROWS @ t))
    return _B @ np.diag(ph) @ _B.conj().T


SQISWAP_M = can_matrix(PI8, PI8, 0)


def _joint_diag_np(X: np.ndarray, Y: np.ndarray, sweeps: int = 16):
    n = X.shape[0]
    V = np.eye(n)
    X = X.copy()
    Y = Y.copy()
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                ux, vx = X[p, q], 0.5 * (X[p, p] - X[q, q])
                uy, vy = Y[p, q], 0.5 * (Y[p, p] - Y[q, q])
                num = 2.0 * (ux * vx + uy * vy)
                den = vx * vx + vy * vy - ux * ux - uy * uy
                th = 0.25 * np.arctan2(num, den)
                c, s = np.cos(th), np.sin(th)
                G = np.eye(n)
                G[p, p] = c
                G[p, q] = s
                G[q, p] = -s
                G[q, q] = c
                X = G @ X @ G.T
                Y = G @ Y @ G.T
                V = V @ G.T
    return np.diagonal(X), np.diagonal(Y), V


def decompose_product_gate(K: np.ndarray):
    """Split a product gate: K = e^{i phase} kron(l, r), l, r in SU(2)."""
    R = K.reshape(2, 2, 2, 2).transpose(0, 2, 1, 3).reshape(4, 4)
    u, s, vh = np.linalg.svd(R)
    l = u[:, 0].reshape(2, 2) * np.sqrt(2)
    r = vh[0].reshape(2, 2) * np.sqrt(2)
    l = l / np.sqrt(np.linalg.det(l) + 0j)
    r = r / np.sqrt(np.linalg.det(r) + 0j)
    rec = np.kron(l, r)
    idx = np.unravel_index(np.argmax(np.abs(rec)), rec.shape)
    phase = cmath.phase(K[idx] / rec[idx])
    return l, r, phase


class CanForm:
    """Tracked form  U = e^{i phase} (l1 ox r1) CAN(t) (l2 ox r2)  with all
    Weyl-chamber moves as explicit exact local identities."""

    def __init__(self, t, l1=None, r1=None, l2=None, r2=None, phase=0.0):
        self.t = np.array(t, dtype=float)
        self.l1 = _I2.copy() if l1 is None else l1
        self.r1 = _I2.copy() if r1 is None else r1
        self.l2 = _I2.copy() if l2 is None else l2
        self.r2 = _I2.copy() if r2 is None else r2
        self.phase = phase

    def matrix(self):
        return (
            np.exp(1j * self.phase)
            * np.kron(self.l1, self.r1)
            @ can_matrix(*self.t)
            @ np.kron(self.l2, self.r2)
        )

    # -- exact moves ---------------------------------------------------
    def shift(self, i: int, k: int):
        """t[i] += k*pi/2; CAN(t_old) = CAN(t_new) (-i P_i ox P_i)^k."""
        if k == 0:
            return self
        self.t[i] += k * PI2
        P = _PAULI[i]
        # fold (-i P ox P)^k into the right locals: (P^k into each side,
        # scalar (-i)^k * (sign from P^2=I) into phase)
        kk = k % 4
        for _ in range(kk):
            self.l2 = P @ self.l2
            self.r2 = P @ self.r2
            self.phase -= PI2  # factor (-i)
        # P^2 = I contributes nothing further; (-i)^k handled above;
        # note (P ox P)^2 = I so matrix part cycles with period 2
        return self

    def swap(self, i: int, j: int):
        """Swap axes i,j of t via L = R_k(pi/2) ox R_k(pi/2)."""
        k = 3 - i - j
        P = _PAULI[k]
        R = np.cos(PI4) * _I2 - 1j * np.sin(PI4) * P
        Rd = R.conj().T
        self.l1 = self.l1 @ Rd
        self.r1 = self.r1 @ Rd
        self.l2 = R @ self.l2
        self.r2 = R @ self.r2
        self.t[[i, j]] = self.t[[j, i]]
        return self

    def pair_flip(self, i: int, j: int):
        """Negate t[i], t[j] via P_k ox I on both sides."""
        k = 3 - i - j
        P = _PAULI[k]
        self.l1 = self.l1 @ P
        self.l2 = P @ self.l2
        self.t[i] = -self.t[i]
        self.t[j] = -self.t[j]
        return self

    def canonicalize(self):
        """Drive t into the chamber pi/4 >= t0 >= t1 >= |t2|."""
        for i in range(3):
            self.shift(i, -int(np.floor(self.t[i] / PI2)))
        for _ in range(6):
            order = np.argsort(-self.t)
            if order[0] != 0:
                self.swap(0, int(order[0]))
            if self.t[1] < self.t[2]:
                self.swap(1, 2)
            if self.t[0] + self.t[1] > PI2 + 1e-14:
                self.pair_flip(0, 1)
                self.shift(0, 1)
                self.shift(1, 1)
                self.swap(0, 1)
                for i in range(3):
                    self.shift(i, -int(np.floor(self.t[i] / PI2)))
            else:
                break
        if self.t[0] > PI4 + 1e-14:
            self.pair_flip(0, 2)
            self.shift(0, 1)
            if self.t[1] < self.t[2]:
                self.swap(1, 2)
        # on the t0 = pi/4 face, (pi/4, b, c) ~ (pi/4, b, -c): fix c >= 0
        if abs(self.t[0] - PI4) < 1e-9 and self.t[2] < 0:
            self.pair_flip(0, 2)
            self.shift(0, 1)
        return self


def kak(U: np.ndarray):
    """U(4) -> (phase, (a,b,c), K1l, K1r, K2l, K2r) with
    U = e^{i phase} (K1l ox K1r) CAN(a,b,c) (K2l ox K2r),
    pi/4 >= a >= b >= |c|."""
    form = kak_form(U)
    return (
        form.phase,
        (float(form.t[0]), float(form.t[1]), float(form.t[2])),
        form.l1,
        form.r1,
        form.l2,
        form.r2,
    )


def kak_form(U: np.ndarray) -> CanForm:
    U = np.asarray(U, dtype=complex)
    det = np.linalg.det(U)
    Us = U * det ** (-0.25)
    phase = cmath.phase(det) / 4

    M = _B.conj().T @ Us @ _B
    m = M.T @ M
    x, y, P = _joint_diag_np(m.real, m.imag)
    if np.linalg.det(P) < 0:
        P = P.copy()
        P[:, -1] = -P[:, -1]
    theta = np.arctan2(y, x)
    d = -theta / 2.0
    n = int(round(d.sum() / PI))
    d[0] -= PI * n  # exact lift: sum(d)=0, e^{2id}=e^{-i theta}

    K1 = _B @ (M @ P @ np.diag(np.exp(1j * d))) @ _B.conj().T
    K2 = _B @ P.T @ _B.conj().T
    t = -(_V_ROWS.T @ d) / 4.0
    l1, r1, p1 = decompose_product_gate(K1)
    l2, r2, p2 = decompose_product_gate(K2)
    form = CanForm(t, l1, r1, l2, r2, phase + p1 + p2)
    form.canonicalize()
    return form


# ------------------------------------------------- sqrt(iSwap) synthesis


def _in_2region(t, tol=1e-12) -> bool:
    return (
        PI4 + tol >= t[0] >= t[1] - tol >= abs(t[2]) - tol
        and abs(t[2]) <= t[0] - t[1] + tol
    )


def _rz(t):
    return np.diag([np.exp(-1j * t / 2), np.exp(1j * t / 2)])


def _rx(t):
    c, s = np.cos(t / 2), np.sin(t / 2)
    return np.array([[c, -1j * s], [-1j * s, c]])


def _makhlin(U: np.ndarray):
    """Makhlin invariants (g1, g2, g3) — fast trace closed form."""
    det = np.linalg.det(U)
    Us = U * det ** (-0.25)
    M = _B.conj().T @ Us @ _B
    m = M.T @ M
    tr = np.trace(m)
    g12 = tr * tr / 16.0
    g3 = (tr * tr - np.trace(m @ m)) / 4.0
    return np.array([g12.real, g12.imag, g3.real])


def _interleave_candidates(x, y, z):
    """Closed-form (alpha, beta, gamma) candidates for the interleaving
    solve — derived from first principles in THIS framework's conventions
    (see interleaving_rotations).

    With u = cos(alpha), v = cos(beta), s2 = sin^2(gamma),
    p = (1+u)(1+v), q = (1-u)(1-v), the invariant match reduces to

        (I)   s2 * p               = 4 K1,   K1 = cos2x cos2y cos2z
        (II)  q * (p - 4 K1)       = 4 K2^2, K2 = sin2x sin2y sin2z
        (III) (s2 p)^2 + 4 s2 p (Pr - S) + 2 S^2 - 4 Pr^2 = 4 K3,
              K3 = cos4x cos4y cos4z,  S = u+v,  Pr = u v

    and eliminating p via (II) turns (III) into the quartic

        q^4/4 - 2(K1+1) q^3 + (2 + 2K3 + 6K2^2 - 4K1^2) q^2
            + 8 K2^2 (K1 - 1) q + 4 K2^4 = 0.

    sign(cos gamma) = sign(z). The z = 0 boundary degenerates (q -> 0) and
    has two analytic branches: alpha = 0 (interior) with
    v = 1 - sqrt(2 - 2K3 + 8K1^2 - 8K1), and beta = pi (x = pi/4 wall,
    where gamma drops out of all invariants) with u = -1 + sqrt(2 - 2K3).
    """
    ld = np.longdouble
    x, y, z = ld(x), ld(y), ld(z)
    K1 = float(np.cos(2 * x) * np.cos(2 * y) * np.cos(2 * z))
    K2 = float(np.sin(2 * x) * np.sin(2 * y) * np.sin(2 * z))
    K3 = float(np.cos(4 * x) * np.cos(4 * y) * np.cos(4 * z))
    cands = []

    def push(u, v, s2, sgn):
        # generous bounds: values are clamped below and candidates are
        # screened by exact invariant residual afterwards, so rounding that
        # nudges a boundary solution marginally out of range must not
        # discard it (seen: s2 = 1 + 2e-9 at near-identity z = 0)
        if not (-1 - 1e-6 <= u <= 1 + 1e-6 and -1 - 1e-6 <= v <= 1 + 1e-6):
            return
        if not (-1e-6 <= s2 <= 1 + 1e-6):
            return
        a = float(np.arccos(np.clip(u, -1, 1)))
        b = float(np.arccos(np.clip(v, -1, 1)))
        s2c = float(np.clip(s2, 0, 1))
        g = float(np.arctan2(np.sqrt(s2c), sgn * np.sqrt(1 - s2c)))
        cands.append((a, b, g))
        cands.append((b, a, g))

    # --- z = 0 boundary branches (K2 == 0 exactly or numerically)
    if abs(K2) < 1e-14:
        # branch alpha = 0: the discriminant 2 - 2K3 + 8K1^2 - 8K1 factors
        # exactly as 16 (cos^2 x - cos^2 y)^2, so cos(beta) is computed
        # with NO cancellation (naive evaluation loses ~8 digits at the
        # near-identity targets produced by QFT's smallest controlled
        # phases, pi/2^15):
        v = float(1 - 2 * abs(np.cos(2 * x) - np.cos(2 * y)))
        if 1 + v > 1e-12:
            push(1.0, v, 2 * K1 / (1 + v), 1.0)
        # branch beta = pi (x = pi/4 wall; gamma drops out of all
        # invariants there). 1 - K3 via the telescoped stable form.
        one_m_K3 = float(
            2 * np.sin(2 * x) ** 2
            + np.cos(4 * x) * 2 * np.sin(2 * y) ** 2
            + np.cos(4 * x) * np.cos(4 * y) * 2 * np.sin(2 * z) ** 2
        )
        u = -1 + np.sqrt(max(2 * one_m_K3, 0.0))
        push(u, -1.0, 0.0, 1.0)
        return cands

    # --- general path: quartic in q (longdouble Ferrari via companion +
    # two Newton polish steps per root)
    coeffs = np.array(
        [
            0.25,
            -2 * (K1 + 1),
            2 + 2 * K3 + 6 * K2 * K2 - 4 * K1 * K1,
            8 * K2 * K2 * (K1 - 1),
            4 * K2 ** 4,
        ],
        dtype=np.longdouble,
    )
    roots = np.roots(coeffs.astype(float))
    dcoeffs = coeffs[:-1] * np.array([4, 3, 2, 1], dtype=np.longdouble)
    sgn = 1.0 if z > 0 else -1.0
    for r in roots:
        # on the region boundary |z| = x - y the physical root is a double
        # root; np.roots then returns a conjugate pair with O(1e-8) imag.
        # Accept generously and let the 80-bit Newton polish land it.
        if abs(r.imag) > 1e-4 * max(1.0, abs(r.real)):
            continue
        q = ld(r.real)
        best_q, best_f = q, abs(np.polyval(coeffs, q))
        for _ in range(3):  # Newton polish in 80-bit (guarded: double
            # roots have f' -> 0 and an unguarded step diverges)
            df = np.polyval(dcoeffs, q)
            if df == 0:
                break
            q = q - np.polyval(coeffs, q) / df
            f = abs(np.polyval(coeffs, q))
            if f < best_f:
                best_q, best_f = q, f
            else:
                break
        q = float(best_q)
        if not (1e-18 < q <= 4 + 1e-6):
            continue
        p = 4 * K1 + 4 * K2 * K2 / q
        if not (1e-18 < p <= 4 + 1e-6):
            continue
        S = (p - q) / 2.0
        Pr = (p + q) / 2.0 - 1.0
        disc = S * S / 4.0 - Pr
        if disc < -1e-6:  # boundary double roots give u == v, disc -> 0^-
            continue
        rr = np.sqrt(max(disc, 0.0))
        push(S / 2 + rr, S / 2 - rr, 4 * K1 / p, sgn)
    return cands


def _polish_angles(angles, target, make, iters: int = 8):
    """Deterministic damped Gauss-Newton on the 3 Makhlin-invariant
    residuals (central-difference Jacobian, pure numpy) — cleans up the
    clamping noise of degenerate closed-form roots; seeded at the closed
    form, so convergence is quadratic and there is no multi-start."""
    p = np.array(angles, dtype=float)
    resid = lambda a: _makhlin(make(*a)) - target
    best_p, best_r = p.copy(), float(np.abs(resid(p)).max())
    h = 1e-7
    for _ in range(iters):
        if best_r < 1e-15:
            break
        r0 = resid(p)
        J = np.empty((3, 3))
        for j in range(3):
            dp = np.zeros(3)
            dp[j] = h
            J[:, j] = (resid(p + dp) - resid(p - dp)) / (2 * h)
        try:
            step = np.linalg.lstsq(J, -r0, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        for damp in (1.0, 0.5, 0.25, 0.1):
            cand = p + damp * step
            rc = float(np.abs(resid(cand)).max())
            if rc < best_r:
                best_p, best_r = cand.copy(), rc
                p = cand
                break
        else:
            break
    return best_p, best_r


def interleaving_rotations(x, y, z):
    """(C1, C2) with SQiSW (C1 ox C2) SQiSW locally equivalent to
    CAN(x,y,z), for (x,y,z) in the 2-application region |z| <= x - y.

    The 1Q ansatz C1 = Rz(g) Rx(a) Rz(g), C2 = Rx(b) is Huang et al.'s
    (arXiv:2105.06074; reference transcription weyl_decompose.py:389-410,
    whose published formulas do NOT transcribe into this convention). The
    angles here are CLOSED FORM, derived from scratch: in the magic basis
    only the central 2x2 block of the SO(4) image of C1 ox C2 enters
    tr(m), giving three polynomial invariant equations whose resultant is
    a quartic (see _interleave_candidates). Candidate roots are screened
    by exact Makhlin-invariant residual; no iterative optimizer, no
    randomness.
    """
    target = _makhlin(can_matrix(x, y, z))

    def make(a, b, g):
        return SQISWAP_M @ np.kron(_rz(g) @ _rx(a) @ _rz(g), _rx(b)) @ SQISWAP_M

    best = None
    for a, b, g in _interleave_candidates(x, y, z):
        res = float(np.abs(_makhlin(make(a, b, g)) - target).max())
        if best is None or res < best[0]:
            best = (res, (a, b, g))
    if best is None:
        raise RuntimeError(f"interleaving closed form failed for t=({x},{y},{z})")
    if best[0] > 1e-15:
        angles, res = _polish_angles(best[1], target, make)
        if res < best[0]:
            best = (res, tuple(angles))
    if best[0] > 1e-11:
        raise RuntimeError(
            f"interleaving closed form failed for t=({x},{y},{z}): "
            f"residual {best[0]}"
        )
    a, b, g = best[1]
    return _rz(g) @ _rx(a) @ _rz(g), _rx(b)


def split_one_sqiswap(t) -> Tuple[CanForm, np.ndarray]:
    """Find a tracked form with CAN(t) = e^{i ph} (l1 ox r1) CAN(t'')
    (l2 ox r2) SQiSW (l3 ox r3), t'' in the 2-application region.

    Uses CAN(s) = CAN(s - (pi/8, pi/8, 0)) SQiSW exactly, over tracked Weyl
    variants of t until the remainder canonicalizes into the region."""
    for perm in itertools.permutations(range(3)):
        for flip in [None, (0, 1), (0, 2), (1, 2)]:
            for extra_shift in (0, -1):
                form = CanForm(t)
                # apply permutation as a sequence of swaps
                cur = list(perm)
                if cur[0] != 0:
                    j = cur.index(0)
                    form.swap(0, j)
                    cur[0], cur[j] = cur[j], cur[0]
                if cur[1] != 1:
                    form.swap(1, 2)
                    cur[1], cur[2] = cur[2], cur[1]
                if flip is not None:
                    form.pair_flip(*flip)
                if extra_shift:
                    form.shift(2, extra_shift)
                # split: CAN(tv) = CAN(tv - s) SQiSW
                inner = CanForm(form.t - np.array([PI8, PI8, 0.0]))
                inner.canonicalize()
                if _in_2region(inner.t):
                    # CAN(t) = ph_form (f.l1) [ CAN(form.t) ] (f.l2)
                    #        = ... (f.1) [ e^{i ph_i}(i.1) CAN(t'') (i.2) SQ ] (f.2)
                    out = CanForm(
                        inner.t,
                        form.l1 @ inner.l1,
                        form.r1 @ inner.r1,
                        inner.l2,
                        inner.r2,
                        form.phase + inner.phase,
                    )
                    tail = np.kron(form.l2, form.r2)
                    return out, tail
    raise RuntimeError(f"no sqiswap split found for t={t}")


def sqiswap_decompose(U: np.ndarray):
    """Decompose U(4) into 2 or 3 SQiSW + interleaved 1Q layers.

    Returns (steps, n) with steps a first-applied-first list of
    ("sqiswap", None) / ("1q", (l, r)) / ("phase", phi) entries.
    Reference counterpart: riswapWeylDecomp (weyl_decompose.py:343-387).
    """
    form = kak_form(U)
    t = form.t

    def two_app(t2):
        """Steps realizing CAN(t2) as e^{i ph} locals SQ (C) SQ locals."""
        C1, C2 = interleaving_rotations(*t2)
        V = SQISWAP_M @ np.kron(C1, C2) @ SQISWAP_M
        vf = kak_form(V)
        # V = e^{i vp} (v1) CAN(t2') (v2); t2' == t2 by construction
        # => CAN(t2) = e^{-i vp} (v1)^dag V (v2)^dag
        pre = (vf.l2.conj().T, vf.r2.conj().T)  # applied first
        post = (vf.l1.conj().T, vf.r1.conj().T)
        return [
            ("1q", pre),
            ("sqiswap", None),
            ("1q", (C1, C2)),
            ("sqiswap", None),
            ("1q", post),
            ("phase", -vf.phase),
        ], vf.t

    steps: List = [("phase", form.phase)]
    if np.abs(t).max() < 1e-8:
        # local gate: no sqiswaps needed
        steps += [("1q", (form.l2, form.r2)), ("1q", (form.l1, form.r1))]
        return _merge_1q(steps), 0
    if np.abs(t - np.array([PI8, PI8, 0.0])).max() < 1e-9:
        # exactly the sqiswap class: single application
        steps += [("1q", (form.l2, form.r2)), ("sqiswap", None),
                  ("1q", (form.l1, form.r1))]
        return _merge_1q(steps), 1
    if _in_2region(t):
        inner, t_chk = two_app(t)
        steps += [("1q", (form.l2, form.r2))]
        steps += inner
        steps += [("1q", (form.l1, form.r1))]
        n = 2
    else:
        split, tail = split_one_sqiswap(t)
        tl, tr, tp = decompose_product_gate(tail)
        inner, t_chk = two_app(split.t)
        # U = ph (f1) CAN(t) (f2)
        #   = ph (f1) [ sp (s1) CAN(t'') (s2) SQ (tail) ] (f2)
        steps += [("phase", split.phase + tp)]
        steps += [("1q", (tl @ form.l2, tr @ form.r2))]
        steps += [("sqiswap", None)]
        steps += [("1q", (split.l2, split.r2))]
        steps += inner
        steps += [("1q", (form.l1 @ split.l1, form.r1 @ split.r1))]
        n = 3
    steps = _merge_1q(steps)
    # certify: the emitted steps must reproduce U to high fidelity (the
    # coordinate-space asserts are too twitchy at chamber boundaries where
    # Makhlin -> coordinate sensitivity blows up)
    V = steps_to_matrix(steps)
    infid = 1 - abs(np.trace(V.conj().T @ U)) / 4
    if infid > 1e-10:
        raise RuntimeError(f"sqiswap synthesis infidelity {infid:.2e} for t={t}")
    return steps, n


def _merge_1q(steps):
    """Fuse adjacent 1q layers and fold phases."""
    out = []
    phase = 0.0
    for kind, payload in steps:
        if kind == "phase":
            phase += payload
        elif kind == "1q":
            if out and out[-1][0] == "1q":
                l0, r0 = out[-1][1]
                out[-1] = ("1q", (payload[0] @ l0, payload[1] @ r0))
            else:
                out.append(("1q", payload))
        else:
            out.append((kind, payload))
    out.append(("phase", phase))
    return out


def steps_to_matrix(steps):
    U = np.eye(4, dtype=complex)
    for kind, payload in steps:
        if kind == "sqiswap":
            U = SQISWAP_M @ U
        elif kind == "1q":
            l, r = payload
            U = np.kron(l, r) @ U
        else:
            U = np.exp(1j * payload) * U
    return U


def steps_to_circuit(steps, qubits=(0, 1), circ=None):
    """Emit steps into a transpile.ir.Circuit."""
    from slam_decomposition_torch.transpile.ir import Circuit

    if circ is None:
        circ = Circuit(max(qubits) + 1)
    for kind, payload in steps:
        if kind == "sqiswap":
            circ.append("riswap", qubits, params=(0.5,), duration=0.5)
        elif kind == "1q":
            l, r = payload
            circ.unitary(l, (qubits[0],), name="u1q")
            circ.unitary(r, (qubits[1],), name="u1q")
    return circ
