"""Monodromy and Weyl-chamber coordinates of 2Q unitaries (JAX
ops/weyl.py:46-170, 205-261), all in f64 on native complex128
tensors (the trace-only invariants in the dtype they are given).

Conventions are the JAX package's: magic basis
B = (1/sqrt2)[[1,0,0,i],[0,i,1,0],[0,i,-1,0],[1,0,0,-i]], m = M^T M with
M = B^dag U_s B for the SU(4) representative U_s, and the alcove
coordinates a with eigenvalues of m equal to e^{2 pi i a_k}. The f32 and
mixed-precision tiers of the JAX package (``weyl.py:172-202``) exist only
because f64 is emulated on the TPU and are not ported.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from slam_decomposition_torch.ops.eig import joint_diag

_SQ2 = 1.0 / np.sqrt(2.0)
# sign vectors: eigenphase_k of CAN(t) = V_SIGNS[k] . t
V_SIGNS = np.array([[1, -1, 1], [1, 1, -1], [-1, -1, -1], [-1, 1, 1]], dtype=float)
MAGIC = np.array(
    [
        [_SQ2, 0, 0, 1j * _SQ2],
        [0, 1j * _SQ2, _SQ2, 0],
        [0, 1j * _SQ2, -_SQ2, 0],
        [_SQ2, 0, 0, -1j * _SQ2],
    ]
)


def det4(U: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 4, 4) complex matrices by Laplace expansion over
    the 2x2 minors of the first two rows (the JAX package's cplx.det4)."""

    def minor2(r0, r1, c0, c1):
        return U[..., r0, c0] * U[..., r1, c1] - U[..., r0, c1] * U[..., r1, c0]

    total = torch.zeros(U.shape[:-2], dtype=U.dtype, device=U.device)
    cols = [0, 1, 2, 3]
    for c0, c1 in itertools.combinations(cols, 2):
        rest = [c for c in cols if c not in (c0, c1)]
        perm = (c0, c1, rest[0], rest[1])
        inv = sum(1 for a in range(4) for b in range(a + 1, 4) if perm[a] > perm[b])
        sign = -1.0 if inv % 2 else 1.0
        total = total + sign * minor2(0, 1, c0, c1) * minor2(2, 3, rest[0], rest[1])
    return total


def su4_normalize(U: torch.Tensor):
    """Scale U(4) -> SU(4) via det^{-1/4} (principal branch).

    Returns (U_s, global_phase) with U = e^{i phase} U_s."""
    det = det4(U)
    phase = torch.atan2(det.imag, det.real) / 4.0
    mag = (det.real**2 + det.imag**2) ** (-0.125)
    sc = torch.polar(mag, -phase)
    return U * sc[..., None, None], phase


def to_magic(U: torch.Tensor) -> torch.Tensor:
    """B^dag U B."""
    B = torch.as_tensor(MAGIC, dtype=U.dtype, device=U.device)
    return B.conj().transpose(-2, -1) @ (U @ B)


def gamma_eigenphases(U: torch.Tensor) -> torch.Tensor:
    """Eigenphases (4, unsorted, in (-pi, pi]) of m = M^T M for U in U(4)."""
    Us, _ = su4_normalize(U)
    M = to_magic(Us)
    m = M.transpose(-2, -1) @ M
    x, y, _ = joint_diag(m.real, m.imag)
    # m is unitary symmetric: eigenvalue_k = x_k + i y_k on the unit circle
    return torch.atan2(y, x)


def _sort_desc(a: torch.Tensor) -> torch.Tensor:
    return torch.sort(a, dim=-1, descending=True).values


def _phases_to_reps(th: torch.Tensor) -> torch.Tensor:
    """Eigenphases -> both alcove representatives, (..., 2, 4)."""
    a = th / (2.0 * np.pi)

    def reduce_alcove(a):
        # sort desc; enforce sum == 0 by integer shifts on sorted entries
        a = _sort_desc(a)
        s = torch.round(a.sum(dim=-1))
        for _ in range(2):
            down = (s > 0.5).to(a.dtype)
            a = torch.cat([(a[..., 0] - down)[..., None], a[..., 1:]], dim=-1)
            s = s - down
            a = _sort_desc(a)
            up = (s < -0.5).to(a.dtype)
            a = torch.cat([a[..., :3], (a[..., 3] + up)[..., None]], dim=-1)
            s = s + up
            a = _sort_desc(a)
        return a

    return torch.stack([reduce_alcove(a), reduce_alcove(a + 0.5)], dim=-2)


def monodromy_coords(U: torch.Tensor) -> torch.Tensor:
    """Both monodromy (alcove) representatives of gamma(U), (..., 2, 4):
    a1 >= a2 >= a3 >= a4, sum(a) = 0, a1 - a4 <= 1. The second is
    shift(a + 1/2), the class of -U."""
    return _phases_to_reps(gamma_eigenphases(U))


def _canonicalize_c(c: torch.Tensor) -> torch.Tensor:
    """Map coordinate triples (units of pi/2, any real values) into the Weyl
    chamber {c1 >= c2 >= c3 >= 0, c1 + c2 <= 1}. Branch-free (JAX
    weyl.py:86-106)."""
    c = torch.remainder(c, 1.0)
    for _ in range(3):
        c = _sort_desc(c)
        cond = (c[..., 0] + c[..., 1]) > 1.0
        folded = torch.stack([1.0 - c[..., 1], 1.0 - c[..., 0], c[..., 2]], dim=-1)
        c = torch.where(cond[..., None], torch.remainder(folded, 1.0), c)
    c = _sort_desc(c)
    # on the c3 = 0 plane, (c1, c2, 0) ~ (1 - c1, c2, 0): take the left side
    boundary = (c[..., 2] < 1e-7) & (c[..., 0] > 0.5)
    folded = torch.stack([1.0 - c[..., 0], c[..., 1], c[..., 2]], dim=-1)
    return _sort_desc(torch.where(boundary[..., None], folded, c))


def _phases_to_c(th: torch.Tensor) -> torch.Tensor:
    """Eigenphases -> canonical Weyl-chamber c1c2c3. The fourth phase is
    re-lifted so the sum is exactly 0; the pairs (v_k + v_3)/2 form a signed
    permutation with an odd number of sign flips, hence the negation."""
    t3 = -(th[..., 0] + th[..., 1] + th[..., 2])
    ctil = (th[..., :3] + t3[..., None]) / 4.0
    return _canonicalize_c(-ctil / (np.pi / 2.0))


def c1c2c3(U: torch.Tensor) -> torch.Tensor:
    """Weyl chamber coordinates (..., 3) in the weylchamber package's units
    and convention: CNOT = (1/2, 0, 0), iSwap = (1/2, 1/2, 0), SWAP =
    (1/2, 1/2, 1/2), B = (1/2, 1/4, 0)."""
    return _phases_to_c(gamma_eigenphases(U))


def g1g2g3(U: torch.Tensor) -> torch.Tensor:
    """Makhlin invariants (g1, g2, g3), (..., 3) real, from traces alone:
    identity (1, 0, 3), CNOT (0, 0, 1), iSwap (0, 0, -1), SWAP (-1, 0, -3)."""
    Us, _ = su4_normalize(U)
    M = to_magic(Us)
    m = M.transpose(-2, -1) @ M
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    tr2 = (m * m.transpose(-2, -1)).sum(dim=(-2, -1))  # tr(m m)
    g12 = tr * tr
    return torch.stack([g12.real / 16.0, g12.imag / 16.0, (g12.real - tr2.real) / 4.0], dim=-1)


def canonical_gate(c: torch.Tensor) -> torch.Tensor:
    """CAN((pi/2) c) = expm(i (pi/2)(c1 XX + c2 YY + c3 ZZ)) for c (..., 3)
    real -> (..., 4, 4) complex, from its diagonal form in the magic basis."""
    cdt = torch.complex64 if c.dtype == torch.float32 else torch.complex128
    v = torch.as_tensor(V_SIGNS, dtype=c.dtype, device=c.device)
    mu = (np.pi / 2.0) * (c[..., None, :] * v).sum(-1)  # (..., 4)
    ph = torch.complex(torch.cos(mu), torch.sin(mu))
    B = torch.as_tensor(MAGIC, dtype=cdt, device=c.device)
    return (B * ph[..., None, :]) @ B.conj().T


def positive_canonical_to_monodromy(c) -> torch.Tensor:
    """Chamber coordinates (..., 3) in units of pi/2 -> one monodromy
    representative (..., 4), descending (JAX ops/weyl.py:253-261). Points of
    the chamber need no alcove reduction."""
    c = torch.as_tensor(c, dtype=torch.float64)
    x, y, z = c[..., 0] / 2.0, c[..., 1] / 2.0, c[..., 2] / 2.0
    a = torch.stack([x + y - z, x - y + z, -x + y + z, -x - y - z], dim=-1)
    return torch.sort(a, dim=-1, descending=True).values
