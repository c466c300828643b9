"""Batched, branch-free analytic sqrt(iSwap) synthesis in f64 (JAX
ops/kak_batch.py).

The host KAK + 2/3-application synthesis (transpile/kak.py) emits an exact
decomposition one target at a time. This module runs the same pipeline as
torch ops over a batch dimension and returns the ansatz parameter vector
(the u3-layer layout of models/templates.build_ansatz) directly:

    U  ~locally~  L_k SQiSW ... L_1 SQiSW L_0        (k = 2 or 3)

The pieces, all over the whole batch at once:
  * joint diagonalization of (Re m, Im m) by the fixed-sweep Jacobi of
    ops/eig.joint_diag;
  * Weyl-chamber canonicalization as masked select moves (the branches of
    kak.py:158-186);
  * the interleaving quartic (kak.py:262-376) by Durand-Kerner iteration,
    all four roots at once, with the two z=0 boundary branches always
    evaluated; 12 candidates, each polished by damped Gauss-Newton on the
    Makhlin invariants, the winner chosen by residual;
  * the 3-application split (kak.py:452-491) over all 48 tracked variants
    with a masked first-valid select.

Everything is f64 on the device the init is built for. The JAX package ran
this in f32 on the TPU and kept a second f64 tier on the CPU for the lanes
f32 cannot resolve (near-identity classes, where the quartic's roots merge);
with native f64 there is one tier. The result is a warm start for the f64
LM polish (ops/chain_kernels.polish_chain) and lands at trace infidelity
~1e-16 on Haar targets. A candidate whose residual is NaN never wins a
select here (the JAX argmin would pick it); a lane that still comes out
non-finite fails certification downstream.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.ops.eig import joint_diag
from slam_decomposition_torch.ops.weyl import MAGIC, det4

PI = math.pi
PI2 = math.pi / 2
PI4 = math.pi / 4
PI8 = math.pi / 8
# CAN(t) = B diag(exp(i V_ROWS @ t)) B^dag (kak.py:41-55)
V_ROWS = np.array([[1, -1, 1], [1, 1, -1], [-1, -1, -1], [-1, 1, 1]], dtype=float)
PAULI = np.stack(
    [np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]]), np.diag([1.0, -1.0])]
).astype(complex)
DK_ITERS = 48  # Durand-Kerner iterations on the interleave quartic
GN_ITERS, GN_WINNER_ITERS = 8, 24  # Gauss-Newton on every candidate / the winner
GN_DAMPS = (1e-6, 1e-3, 1e-1)
REGION_TOL = 1e-6  # 2-application region test of the 3-split variants
# 48 static split variants (kak.py:458-474): 6 perms x 4 flips x 2 shifts
VARIANTS = [
    (perm, flip, extra)
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))
    for flip in (None, (0, 1), (0, 2), (1, 2))
    for extra in (0, -1)
]


class _Consts:
    """Complex128 constants on one device."""

    def __init__(self, device):
        self.device = torch.device(device)
        c = lambda a: torch.as_tensor(a, dtype=torch.complex128, device=self.device)  # noqa: E731
        self.B = c(MAGIC)
        self.Bd = self.B.conj().T
        self.V = torch.as_tensor(V_ROWS, dtype=torch.float64, device=self.device)
        self.P = c(PAULI)
        self.eye2 = c(np.eye(2))
        c4 = np.cos(PI4)
        # R_k(pi/2) of the axis swaps (kak.py:135-146)
        self.R = c4 * self.eye2 - 1j * c4 * self.P
        self.SQ = can_matrix(torch.tensor([[PI8, PI8, 0.0]], dtype=torch.float64, device=self.device), self)[0]
        # M = B^dag SQ K SQ B of the interleave residual = ML K MR
        self.ML = self.Bd @ self.SQ
        self.MR = self.SQ @ self.B


def can_matrix(t: torch.Tensor, C: _Consts) -> torch.Tensor:
    """CAN(t) for t (N, 3) -> (N, 4, 4) complex128."""
    ph = torch.exp(1j * (t @ C.V.T).to(torch.complex128))
    return _mm(C.B * ph[:, None, :], C.Bd)


def _mm(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched matrix product as a broadcast multiply and sum. cuBLAS runs a
    batch of 2x2 or 4x4 complex128 products one padded tile per matrix, in
    launches of at most 65535 matrices (~0.94 ms per launch of 4x4 on the
    H100, PERF.md), so these small products stay elementwise."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ab,...cd->...acbd", A, B).reshape(*A.shape[:-2], 4, 4)


def _det2(W: torch.Tensor) -> torch.Tensor:
    return W[..., 0, 0] * W[..., 1, 1] - W[..., 0, 1] * W[..., 1, 0]


def _where(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.where with a per-lane cond broadcast over a's trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


# ------------------------------------------------------------------ KAK core


def _split_product(K: torch.Tensor):
    """K = e^{i phase} kron(l, r) -> (l, r) in SU(2), phase dropped. Closed
    form via the rank-1 rearrangement R = vec(l) vec(r)^T: its dominant row
    is r, and R r^* / |r|^2 is l."""
    N = K.shape[0]
    R = K.reshape(N, 2, 2, 2, 2).permute(0, 1, 3, 2, 4).reshape(N, 4, 4)
    norms = (R.abs() ** 2).sum(-1)
    i0 = torch.argmax(norms, dim=1)
    ar = torch.arange(N, device=K.device)
    rvec = R[ar, i0]
    nmax = torch.clamp_min(norms[ar, i0], torch.finfo(torch.float64).tiny)
    lvec = (R * rvec.conj()[:, None, :]).sum(-1) / nmax[:, None]
    l = lvec.reshape(N, 2, 2)
    r = rvec.reshape(N, 2, 2)
    return l / torch.sqrt(_det2(l))[:, None, None], r / torch.sqrt(_det2(r))[:, None, None]


# Tracked canonical moves on the state (t (N, 3), l1, r1, l2, r2 (N, 2, 2)):
# U ~ (l1 ox r1) CAN(t) (l2 ox r2) up to a global phase, which is never
# tracked (every dropped factor is a scalar). ``cond`` (N,) masks a move.
# A state whose locals are None moves t alone, with the same arithmetic.


def _shift(st, i, k, C):
    """t[i] += k pi/2, folding (P_i ox P_i)^k into the right locals
    (kak.py:118-133; the (-i)^k scalar is dropped). k is (N,) or a number."""
    t, l1, r1, l2, r2 = st
    t = t.clone()
    t[:, i] = t[:, i] + k * PI2
    if l2 is None:
        return (t, l1, r1, l2, r2)
    if isinstance(k, torch.Tensor):
        odd = torch.remainder(k, 2.0) > 0.5
        return (t, l1, r1, _where(odd, _mm(C.P[i], l2), l2), _where(odd, _mm(C.P[i], r2), r2))
    if k % 2:
        return (t, l1, r1, _mm(C.P[i], l2), _mm(C.P[i], r2))
    return (t, l1, r1, l2, r2)


def _masked(new, old, cond):
    if cond is None:
        return new
    return tuple(a if a is None else _where(cond, a, b) for a, b in zip(new, old))


def _swap(st, i, j, C, cond=None):
    """Swap t[i], t[j] via R_k(pi/2) ox R_k(pi/2) (kak.py:135-146)."""
    t, l1, r1, l2, r2 = st
    R = C.R[3 - i - j]
    Rd = R.conj().T
    tn = t.clone()
    tn[:, i], tn[:, j] = t[:, j], t[:, i]
    if l1 is None:
        return _masked((tn, None, None, None, None), st, cond)
    return _masked((tn, _mm(l1, Rd), _mm(r1, Rd), _mm(R, l2), _mm(R, r2)), st, cond)


def _pair_flip(st, i, j, C, cond=None):
    """Negate t[i], t[j] via P_k ox I on both sides (kak.py:148-156)."""
    t, l1, r1, l2, r2 = st
    P = C.P[3 - i - j]
    tn = t.clone()
    tn[:, i], tn[:, j] = -t[:, i], -t[:, j]
    if l1 is None:
        return _masked((tn, None, None, None, None), st, cond)
    return _masked((tn, _mm(l1, P), r1, _mm(P, l2), r2), st, cond)


def _shift_floor_all(st, C, cond=None):
    for i in range(3):
        k = -torch.floor(st[0][:, i] / PI2)
        if cond is not None:
            k = torch.where(cond, k, 0.0)
        st = _shift(st, i, k, C)
    return st


def _canonicalize(st, C):
    """Drive t into the chamber pi/4 >= t0 >= t1 >= |t2| with tracked
    locals: the masked-select form of kak.py:158-186."""
    st = _shift_floor_all(st, C)
    for _ in range(4):  # the host loop never needs more in practice
        st = _swap(st, 0, 1, C, cond=st[0][:, 1] > st[0][:, 0])
        st = _swap(st, 0, 2, C, cond=st[0][:, 2] > st[0][:, 0])
        st = _swap(st, 1, 2, C, cond=st[0][:, 2] > st[0][:, 1])
        t = st[0]
        c = t[:, 0] + t[:, 1] > PI2
        one = c.to(torch.float64)
        st = _pair_flip(st, 0, 1, C, cond=c)
        st = _shift(st, 0, one, C)
        st = _shift(st, 1, one, C)
        st = _swap(st, 0, 1, C, cond=c)
        st = _shift_floor_all(st, C, cond=c)
    c = st[0][:, 0] > PI4
    st = _pair_flip(st, 0, 2, C, cond=c)
    st = _shift(st, 0, c.to(torch.float64), C)
    st = _swap(st, 1, 2, C, cond=st[0][:, 2] > st[0][:, 1])
    # pi/4-face sign fix (kak.py:183-185)
    t = st[0]
    c = ((t[:, 0] - PI4).abs() < 1e-6) & (t[:, 2] < 0)
    st = _pair_flip(st, 0, 2, C, cond=c)
    return _shift(st, 0, c.to(torch.float64), C)


def _kak_state(U: torch.Tensor, C: _Consts):
    """Phase-free tracked KAK of (N, 4, 4) complex128: the canonical state
    (t, l1, r1, l2, r2) (kak.py:204-228)."""
    det = det4(U)
    Us = U * torch.polar(det.abs() ** -0.25, -torch.angle(det) / 4)[:, None, None]
    M = _mm(_mm(C.Bd, Us), C.B)
    m = _mm(M.transpose(-2, -1), M)
    x, y, Pv = joint_diag(m.real, m.imag)
    Pv[:, :, -1] = Pv[:, :, -1] * torch.sign(det4(Pv))[:, None]
    d = -torch.atan2(y, x) / 2.0
    n = torch.round(d.sum(-1) / PI)
    d[:, 0] = d[:, 0] - PI * n
    Pc = Pv.to(torch.complex128)
    # M Pc diag(e^{i d}): the diagonal scales columns
    MPd = _mm(M, Pc) * torch.exp(1j * d.to(torch.complex128))[:, None, :]
    K1 = _mm(_mm(C.B, MPd), C.Bd)
    K2 = _mm(_mm(C.B, Pc.transpose(-2, -1)), C.Bd)
    t = -(d @ C.V) / 4.0
    l1, r1 = _split_product(K1)
    l2, r2 = _split_product(K2)
    return _canonicalize((t, l1, r1, l2, r2), C)


# ------------------------------------------------- interleaving rotations


def _makhlin_magic(M: torch.Tensor):
    """(Re g1g2, Im g1g2, g3) (kak.py:250-259) from M = B^dag U B of a U with
    det 1 analytically (CAN(t), and SQ (C1 ox C2) SQ), so no normalization;
    also tr(m) and P = M M^T. The traces of m = M^T M need no m:
    tr(m) = sum(M o M) and tr(m^2) = sum(P o P)."""
    P = _mm(M, M.transpose(-2, -1))
    tr = (M * M).sum((-2, -1))
    tr2 = (P * P).sum((-2, -1))
    g12 = tr * tr / 16.0
    g3 = (tr * tr - tr2) / 4.0
    return torch.stack([g12.real, g12.imag, g3.real], dim=-1), tr, P


def _rz(t: torch.Tensor) -> torch.Tensor:
    e = torch.exp(-0.5j * t.to(torch.complex128))
    z = torch.zeros_like(e)
    return torch.stack([torch.stack([e, z], -1), torch.stack([z, 1.0 / e], -1)], -2)


def _rx(t: torch.Tensor) -> torch.Tensor:
    ch = torch.cos(t / 2).to(torch.complex128)
    sh = torch.sin(t / 2).to(torch.complex128)
    return torch.stack([torch.stack([ch, -1j * sh], -1), torch.stack([-1j * sh, ch], -1)], -2)


def _drx(t: torch.Tensor) -> torch.Tensor:
    """d Rx(t) / dt."""
    ch = (torch.cos(t / 2) / 2).to(torch.complex128)
    sh = (torch.sin(t / 2) / 2).to(torch.complex128)
    return torch.stack([torch.stack([-sh, -1j * ch], -1), torch.stack([-1j * ch, -sh], -1)], -2)


def _interleave_locals(abg: torch.Tensor):
    """C1 = Rz(g) Rx(a) Rz(g), C2 = Rx(b) for abg (..., 3)."""
    a, b, g = abg.unbind(-1)
    Rg = _rz(g)
    return _mm(_mm(Rg, _rx(a)), Rg), _rx(b)


def _interleave_resid(abg: torch.Tensor, target: torch.Tensor, C: _Consts, jac: bool = False):
    """Makhlin residual of SQ (C1 ox C2) SQ against target (N, 3), and with
    ``jac`` its (N, 3, 3) Jacobian in (a, b, g), derived by hand from
    ``_makhlin_magic``'s traces: d tr(m) = 2 sum(M o dM) and
    d tr(m^2) = 4 sum(dM o P M)."""
    a, b, g = abg.unbind(-1)
    Rg, Rxa, C2 = _rz(g), _rx(a), _rx(b)
    C1 = _mm(_mm(Rg, Rxa), Rg)
    M = _mm(_mm(C.ML, _kron(C1, C2)), C.MR)
    inv, tr, P = _makhlin_magic(M)
    r = inv - target
    if not jac:
        return r
    dRg = Rg * torch.tensor([-0.5j, 0.5j], dtype=torch.complex128, device=abg.device)[:, None]
    dK = torch.stack(
        [
            _kron(_mm(_mm(Rg, _drx(a)), Rg), C2),
            _kron(C1, _drx(b)),
            _kron(_mm(_mm(dRg, Rxa), Rg) + _mm(_mm(Rg, Rxa), dRg), C2),
        ],
        dim=1,
    )  # (N, 3, 4, 4)
    dM = _mm(_mm(C.ML, dK), C.MR)
    dtr = 2.0 * (M[:, None] * dM).sum((-2, -1))
    dtr2 = 4.0 * (_mm(P, M)[:, None] * dM).sum((-2, -1))
    dg12 = tr[:, None] * dtr / 8.0
    dg3 = (2.0 * tr[:, None] * dtr - dtr2) / 4.0
    J = torch.stack([dg12.real, dg12.imag, dg3.real], dim=1)  # (N, 3 resid, 3 params)
    return r, J


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 solve via the adjugate (Cramer); the systems
    are damped SPD normal equations."""
    a, bb, c = A[:, 0, 0], A[:, 0, 1], A[:, 0, 2]
    d, e, f = A[:, 1, 0], A[:, 1, 1], A[:, 1, 2]
    g, h, i = A[:, 2, 0], A[:, 2, 1], A[:, 2, 2]
    co00 = e * i - f * h
    co01 = f * g - d * i
    co02 = d * h - e * g
    det = a * co00 + bb * co01 + c * co02
    det = torch.where(det.abs() < 1e-30, 1e-30, det)
    x0 = co00 * b[:, 0] + (c * h - bb * i) * b[:, 1] + (bb * f - c * e) * b[:, 2]
    x1 = co01 * b[:, 0] + (a * i - c * g) * b[:, 1] + (c * d - a * f) * b[:, 2]
    x2 = co02 * b[:, 0] + (bb * g - a * h) * b[:, 1] + (a * e - bb * d) * b[:, 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[:, None]


def _argmin_finite(r: torch.Tensor) -> torch.Tensor:
    """argmin over the last dim, first on ties, NaN ranked last."""
    return torch.argmin(torch.nan_to_num(r, nan=torch.inf), dim=-1)


def _gn_polish(p: torch.Tensor, target: torch.Tensor, iters: int, C: _Consts) -> torch.Tensor:
    """Damped Gauss-Newton on the 3 invariant residuals, (N, 3) -> (N, 3)
    (the batched counterpart of kak.py:379-410). Each step tries three
    dampings and keeps the best of them and the current point. Any residual
    zero is a valid interleave: _two_app_layers re-KAKs the result."""
    N = p.shape[0]
    ar = torch.arange(N, device=p.device)
    eye3 = torch.eye(3, dtype=torch.float64, device=p.device)
    damps = torch.tensor(GN_DAMPS, dtype=torch.float64, device=p.device)
    for _ in range(iters):
        r, J = _interleave_resid(p, target, C, jac=True)
        Jt = J.transpose(-2, -1)
        JtJ = _mm(Jt, J)
        g = (Jt * r[:, None, :]).sum(-1)
        A = JtJ[:, None] + damps[None, :, None, None] * eye3  # (N, 3 damps, 3, 3)
        steps = _solve3(A.reshape(-1, 3, 3), (-g).repeat_interleave(3, 0)).reshape(N, 3, 3)
        trial = p[:, None] + steps
        rt = _interleave_resid(trial.reshape(-1, 3), target.repeat_interleave(3, 0), C)
        allp = torch.cat([trial, p[:, None]], dim=1)
        allr = torch.cat([rt.abs().amax(-1).reshape(N, 3), r.abs().amax(-1)[:, None]], dim=1)
        p = allp[ar, _argmin_finite(allr)]
    return p


def _durand_kerner(coeffs: torch.Tensor, iters: int = DK_ITERS) -> torch.Tensor:
    """All four roots of per-lane quartics, coeffs (N, 5) real, highest power
    first -> (N, 4) complex. Simultaneous (Jacobi-style) updates."""
    c = coeffs.to(torch.complex128)
    c = c / c[:, :1]

    def poly(z):
        return (((z + c[:, 1]) * z + c[:, 2]) * z + c[:, 3]) * z + c[:, 4]

    bound = 1.0 + c[:, 1:].abs().amax(-1)
    w = 0.4 + 0.9j
    z = bound[:, None] * torch.tensor([w, w * w, w * w * w, w * w * w * w], dtype=torch.complex128, device=c.device)
    zs = list(z.unbind(-1))
    for _ in range(iters):
        out = []
        for i in range(4):
            prod = torch.ones_like(zs[i])
            for j in range(4):
                if j != i:
                    prod = prod * (zs[i] - zs[j])
            prod = torch.where(prod.abs() < 1e-12, 1e-12 + 0j, prod)
            out.append(zs[i] - poly(zs[i]) / prod)
        zs = out
    return torch.stack(zs, dim=-1)


def _polyval(coeffs: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Horner over per-lane coefficients (N, d), highest power first."""
    y = torch.zeros_like(q)
    for j in range(coeffs.shape[1]):
        y = y * q + coeffs[:, j]
    return y


def _interleave_angles(t: torch.Tensor, C: _Consts) -> torch.Tensor:
    """(alpha, beta, gamma) (N, 3) with SQiSW (C1 ox C2) SQiSW ~ CAN(t) for
    t in the 2-application region: the quartic in q by Durand-Kerner, the
    two z=0 boundary branches, Gauss-Newton on every candidate and the
    winner by Makhlin residual against CAN(t) (kak.py:262-376)."""
    N = t.shape[0]
    x, y, z = t.unbind(-1)
    K1 = torch.cos(2 * x) * torch.cos(2 * y) * torch.cos(2 * z)
    K2 = torch.sin(2 * x) * torch.sin(2 * y) * torch.sin(2 * z)
    K3 = torch.cos(4 * x) * torch.cos(4 * y) * torch.cos(4 * z)
    coeffs = torch.stack(
        [
            torch.full_like(K1, 0.25),
            -2 * (K1 + 1),
            2 + 2 * K3 + 6 * K2 * K2 - 4 * K1 * K1,
            8 * K2 * K2 * (K1 - 1),
            4 * K2**4,
        ],
        dim=-1,
    )
    roots = _durand_kerner(coeffs)
    dcoeffs = coeffs[:, :-1] * torch.tensor([4.0, 3.0, 2.0, 1.0], dtype=torch.float64, device=t.device)

    def newton(q):
        # a step is kept only where it lowers |f|, as the host's guarded
        # polish does (kak.py:351-362): on the region boundary a double root
        # can split by rounding into a complex pair, whose real part sits
        # where f' ~ 0 and an unguarded step is thrown far away
        f = _polyval(coeffs, q)
        for _ in range(2):
            df = _polyval(dcoeffs, q)
            qn = q - f / torch.where(df.abs() < 1e-20, 1e-20, df)
            fn = _polyval(coeffs, qn)
            better = fn.abs() < f.abs()
            q = torch.where(better, qn, q)
            f = torch.where(better, fn, f)
        return q

    sgn = torch.where(z >= 0, 1.0, -1.0)
    ones = torch.ones_like(K1)
    cands = []  # (u, v, s2, sign of cos gamma), each pushed in both orders

    def push(u, v, s2, sg):
        cands.append(torch.stack([u, v, s2, sg], dim=-1))
        cands.append(torch.stack([v, u, s2, sg], dim=-1))

    for i in range(4):
        q = newton(roots[:, i].real)
        p = 4 * K1 + 4 * K2 * K2 / torch.where(q.abs() < 1e-18, 1e-18, q)
        S = (p - q) / 2.0
        Pr = (p + q) / 2.0 - 1.0
        rr = torch.sqrt(torch.clamp_min(S * S / 4.0 - Pr, 0.0))
        s2 = 4 * K1 / torch.where(p.abs() < 1e-18, 1e-18, p)
        push(S / 2 + rr, S / 2 - rr, s2, sgn)
    # z = 0 boundary branches (kak.py:308-327), always evaluated: the
    # quartic degenerates there and residual screening arbitrates
    v0 = 1 - 2 * (torch.cos(2 * x) - torch.cos(2 * y)).abs()
    push(ones, v0, 2 * K1 / torch.clamp_min(1 + v0, 1e-12), ones)
    one_m_K3 = (
        2 * torch.sin(2 * x) ** 2
        + torch.cos(4 * x) * 2 * torch.sin(2 * y) ** 2
        + torch.cos(4 * x) * torch.cos(4 * y) * 2 * torch.sin(2 * z) ** 2
    )
    push(-1 + torch.sqrt(torch.clamp_min(2 * one_m_K3, 0.0)), -ones, 0 * ones, ones)
    Cd = torch.stack(cands, dim=1)  # (N, 12, 4)

    u = torch.clamp(Cd[..., 0], -1.0, 1.0)
    v = torch.clamp(Cd[..., 1], -1.0, 1.0)
    s2 = torch.clamp(Cd[..., 2], 0.0, 1.0)
    abg = torch.stack(
        [torch.arccos(u), torch.arccos(v), torch.atan2(torch.sqrt(s2), Cd[..., 3] * torch.sqrt(1.0 - s2))],
        dim=-1,
    )
    target = _makhlin_magic(_mm(_mm(C.Bd, can_matrix(t, C)), C.B))[0]
    n_c = abg.shape[1]
    abg = _gn_polish(abg.reshape(-1, 3), target.repeat_interleave(n_c, 0), GN_ITERS, C).reshape(N, n_c, 3)
    res = _interleave_resid(abg.reshape(-1, 3), target.repeat_interleave(n_c, 0), C).abs().amax(-1)
    best = _argmin_finite(res.reshape(N, n_c))
    return _gn_polish(abg[torch.arange(N, device=t.device), best], target, GN_WINNER_ITERS, C)


# ------------------------------------------------------------ synthesis


def _u3_angles(W: torch.Tensor) -> torch.Tensor:
    """(theta, phi, lam) (N, 3) with su2.u3(theta, phi, lam) == W up to a
    global phase, for unitary W (N, 2, 2) (qiskit convention).

    After SU(2) normalization W = [[a, -b*], [b, a*]], phi = ang(W11) +
    ang(W10) and lam = ang(W11) - ang(W10): at theta ~ 0 the noise angle of
    the off-diagonal cancels out of phi + lam (the only combination that
    survives), and at theta ~ pi the diagonal's cancels out of phi - lam."""
    det = _det2(W)
    W = W * (torch.exp(-0.5j * torch.angle(det).to(torch.complex128)) / torch.sqrt(det.abs()))[:, None, None]
    theta = 2.0 * torch.atan2(W[:, 1, 0].abs(), W[:, 0, 0].abs())
    a11 = torch.angle(W[:, 1, 1])
    a10 = torch.angle(W[:, 1, 0])
    return torch.stack([theta, a11 + a10, a11 - a10], dim=-1)


def _dag(W: torch.Tensor) -> torch.Tensor:
    return W.conj().transpose(-2, -1)


def _two_app_layers(t, l1, r1, l2, r2, C):
    """Layers [(l, r)] x 3, first applied first, for U ~ (l1 ox r1) CAN(t)
    (l2 ox r2) with t in the 2-region (kak.py:504-520):
    CAN(t) = vf1^dag [SQ (C1 ox C2) SQ] vf2^dag."""
    C1, C2 = _interleave_locals(_interleave_angles(t, C))
    V = _mm(_mm(C.SQ, _kron(C1, C2)), C.SQ)
    _, vl1, vr1, vl2, vr2 = _kak_state(V, C)
    return [(_mm(_dag(vl2), l2), _mm(_dag(vr2), r2)), (C1, C2), (_mm(l1, _dag(vl1)), _mm(r1, _dag(vr1)))]


def _region_violation(t: torch.Tensor) -> torch.Tensor:
    """0 where t is inside the 2-application region |t2| <= t0 - t1 of the
    canonical chamber (kak.py:234-238); positive outside."""
    v = torch.clamp_min(t[..., 0] - PI4, 0.0)
    v = torch.maximum(v, t[..., 1] - t[..., 0])
    v = torch.maximum(v, t[..., 2].abs() - t[..., 1])
    return torch.maximum(v, t[..., 2].abs() - (t[..., 0] - t[..., 1]))


def _three_app_layers(t, l1, r1, l2, r2, C):
    """Layers for canonical t outside the 2-region: split one SQiSW via
    CAN(s) = CAN(s - (pi/8, pi/8, 0)) SQiSW over the 48 tracked variants,
    first valid variant wins (kak.py:452-491 + 539-549)."""
    N = t.shape[0]
    eye = C.eye2.expand(N, 2, 2)
    shift_vec = torch.tensor([PI8, PI8, 0.0], dtype=torch.float64, device=t.device)
    outer = []
    for perm, flip, extra in VARIANTS:
        st = (t, eye, eye, eye, eye)
        cur = list(perm)
        if cur[0] != 0:
            j = cur.index(0)
            st = _swap(st, 0, j, C)
            cur[0], cur[j] = cur[j], cur[0]
        if cur[1] != 1:
            st = _swap(st, 1, 2, C)
        if flip is not None:
            st = _pair_flip(st, flip[0], flip[1], C)
        if extra:
            st = _shift(st, 2, extra, C)
        outer.append(st)
    nv = len(VARIANTS)
    # (N, nv, ...) of the variants' outer states; every inner remainder's t
    # canonicalized in one batch of N * nv lanes, then only the selected
    # variant's with its locals
    var = [torch.stack([st[f] for st in outer], dim=1) for f in range(5)]
    inner_t = _canonicalize((var[0].reshape(-1, 3) - shift_vec, None, None, None, None), C)[0]
    viol = _region_violation(inner_t.reshape(N, nv, 3))
    rank = torch.where(viol <= REGION_TOL, torch.arange(nv, dtype=viol.dtype, device=t.device), 1e9) + viol
    idx = torch.argmin(rank, dim=1)
    ar = torch.arange(N, device=t.device)
    var_t, var_l1, var_r1, var_l2, var_r2 = (f[ar, idx] for f in var)
    in_t, in_l1, in_r1, in_l2, in_r2 = _canonicalize((var_t - shift_vec, eye, eye, eye, eye), C)
    two = _two_app_layers(in_t, _mm(var_l1, in_l1), _mm(var_r1, in_r1), in_l2, in_r2, C)
    # U = (l1) CAN(t) (l2); CAN(t) = (var1 . inner1) CAN(t'') (inner2) SQ (var2)
    return [(_mm(var_l2, l2), _mm(var_r2, r2)), two[0], two[1], (_mm(l1, two[2][0]), _mm(r1, two[2][1]))]


def make_analytic_init(k: int, device=DEFAULT_DEVICE):
    """Build init(U) -> x: U (B, 4, 4) complex tensor or numpy array, x (B,
    6(k+1)) f64 on ``device``, the analytic warm start in build_ansatz's
    parameter layout for the k-application sqrt(iSwap) template. Targets
    must be in the k-application class (samplers.sqiswap_count_batch);
    out-of-class rows give an x that fails certification. Runs on the card
    unless ``device`` names another."""
    if k not in (2, 3):
        raise ValueError(f"analytic init supports k in (2, 3), got {k}")
    C = _Consts(resolve_device(device))
    layers_of = _two_app_layers if k == 2 else _three_app_layers

    def init(U) -> torch.Tensor:
        U = torch.as_tensor(U).to(device=C.device, dtype=torch.complex128)
        layers = layers_of(*_kak_state(U, C), C)
        return torch.cat([torch.cat([_u3_angles(l), _u3_angles(r)], dim=-1) for l, r in layers], dim=-1)

    return init
