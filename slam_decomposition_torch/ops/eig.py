"""Fixed-sweep Jacobi eigensolvers (JAX ops/eig.py), batched.

``torch.linalg.eig`` is kept off the main path: on CUDA it synchronises
with the host, is slow on 100k batched 4x4 matrices, and gives no ordering
or degeneracy guarantee; ``torch.linalg.eigh``'s gradient is NaN at the
repeated eigenvalues that density matrices of pure states have. The
fixed-sweep rotations below are branch-free and deterministic.

* ``jacobi_eigh``: one real symmetric matrix.
* ``joint_diag``: two commuting real symmetric matrices
  (Cardoso-Souloumiac; resolves degeneracies of either matrix alone). It
  rotates in place on copies of its inputs, or out of place (each rotation
  a product with a Givens matrix) where autograd must see the rotations.
* ``eigh_hermitian``: complex Hermitian, by complex Givens rotations.
* ``eig_unitary``: a unitary matrix, by joint rotations of its commuting
  Hermitian and anti-Hermitian parts.
"""

from __future__ import annotations

import torch


def _pairs(n: int):
    return [(p, q) for p in range(n) for q in range(p + 1, n)]


def _givens_apply_(A, p, q, c, s):
    """A <- G A G^T in place, G = [[c, s], [-s, c]] on rows/cols (p, q)."""
    c = c[..., None]
    s = s[..., None]
    Ap = A[..., p, :] * c + A[..., q, :] * s
    Aq = -A[..., p, :] * s + A[..., q, :] * c
    A[..., p, :] = Ap
    A[..., q, :] = Aq
    Ap = A[..., :, p] * c + A[..., :, q] * s
    Aq = -A[..., :, p] * s + A[..., :, q] * c
    A[..., :, p] = Ap
    A[..., :, q] = Aq


def _rot_apply_right_(V, p, q, c, s):
    """V <- V G^T in place."""
    c = c[..., None]
    s = s[..., None]
    Vp = V[..., :, p] * c + V[..., :, q] * s
    Vq = -V[..., :, p] * s + V[..., :, q] * c
    V[..., :, p] = Vp
    V[..., :, q] = Vq


def _joint_angle(X, Y, p, q):
    """cos, sin of the rotation on (p, q) that minimizes the summed squared
    off-diagonals of both matrices (with G A G^T: 4 theta =
    atan2(2 <u, v>, <v, v> - <u, u>))."""
    ux = X[..., p, q]
    vx = 0.5 * (X[..., p, p] - X[..., q, q])
    uy = Y[..., p, q]
    vy = 0.5 * (Y[..., p, p] - Y[..., q, q])
    num = 2.0 * (ux * vx + uy * vy)
    den = vx * vx + vy * vy - ux * ux - uy * uy
    theta = 0.25 * torch.atan2(num, den)
    return torch.cos(theta), torch.sin(theta)


def _givens(n, p, q, c, s):
    """The (..., n, n) matrix G: identity but G[p,p] = G[q,q] = c, G[p,q] = s,
    G[q,p] = -conj(s). Its entries are c, s, 0 and 1 exactly, so a product
    with it repeats the in-place rotation's arithmetic."""
    D = torch.zeros(n, n, dtype=c.dtype, device=c.device)
    D[p, p] = D[q, q] = 1.0
    Epq = torch.zeros(n, n, dtype=s.dtype, device=s.device)
    Epq[p, q] = 1.0
    eye = torch.eye(n, dtype=c.dtype, device=c.device)
    return (eye - D) + c[..., None, None] * D + s[..., None, None] * Epq - s.conj()[..., None, None] * Epq.T


def _joint_diag_out_of_place(X, Y, sweeps):
    """joint_diag by products with Givens matrices, which autograd can
    differentiate."""
    n = X.shape[-1]
    V = torch.eye(n, dtype=X.dtype, device=X.device).expand(X.shape)
    for _ in range(sweeps):
        for p, q in _pairs(n):
            G = _givens(n, p, q, *_joint_angle(X, Y, p, q))
            Gt = G.transpose(-2, -1)
            X = G @ X @ Gt
            Y = G @ Y @ Gt
            V = V @ Gt
    return torch.diagonal(X, dim1=-2, dim2=-1), torch.diagonal(Y, dim1=-2, dim2=-1), V


def _joint_diag_in_place(X, Y, sweeps):
    """joint_diag by rotations in place on copies of the inputs (cheaper)."""
    n = X.shape[-1]
    X = X.clone()
    Y = Y.clone()
    V = torch.eye(n, dtype=X.dtype, device=X.device).expand(X.shape).clone()
    for _ in range(sweeps):
        for p, q in _pairs(n):
            c, s = _joint_angle(X, Y, p, q)
            _givens_apply_(X, p, q, c, s)
            _givens_apply_(Y, p, q, c, s)
            _rot_apply_right_(V, p, q, c, s)
    return torch.diagonal(X, dim1=-2, dim2=-1), torch.diagonal(Y, dim1=-2, dim2=-1), V


def joint_diag(X: torch.Tensor, Y: torch.Tensor, sweeps: int = 12):
    """Jointly diagonalize commuting real symmetric (..., n, n) matrices.

    Returns (x, y, V) with X = V diag(x) V^T and Y = V diag(y) V^T. The
    inputs are not modified. Where an input requires grad the rotations are
    made out of place, so that autograd sees them; else in place."""
    if torch.is_grad_enabled() and (X.requires_grad or Y.requires_grad):
        return _joint_diag_out_of_place(X, Y, sweeps)
    return _joint_diag_in_place(X, Y, sweeps)


_HALF_PI = 1.5707963267948966


def _fold_angle(theta):
    """Wrap a zeroing angle into [-pi/4, pi/4] (the rotation shifted by
    pi/2 also zeroes the pivot but swaps the diagonal entries; bounded
    angles keep Jacobi's quadratic convergence)."""
    return theta - _HALF_PI * torch.round(theta / _HALF_PI)


def jacobi_eigh(A: torch.Tensor, sweeps: int = 10):
    """Real symmetric eigendecomposition of (..., n, n) -> (w, V) with
    A = V diag(w) V^T, w ascending (JAX ops/eig.jacobi_eigh): fixed sweeps
    of Givens rotations, each zeroing its pivot (tan 2 theta = 2 a_pq /
    (a_pp - a_qq), theta folded into [-pi/4, pi/4]), on copies of A."""
    n = A.shape[-1]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for p, q in _pairs(n):
            theta = _fold_angle(0.5 * torch.atan2(2.0 * A[..., p, q], A[..., p, p] - A[..., q, q]))
            c, s = torch.cos(theta), torch.sin(theta)
            _givens_apply_(A, p, q, c, s)
            _rot_apply_right_(V, p, q, c, s)
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return torch.gather(w, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def _hermitian_rotation(n, p, q, h, dd):
    """The complex Givens matrix J that zeroes the pivot h = H[p, q] of a
    Hermitian H with dd = H[p,p] - H[q,q] under H <- J^dag H J:
    tan(2 theta) = 2 |h| / dd, s = -sin(theta) e^{i arg h}."""
    mag = torch.sqrt(h.real * h.real + h.imag * h.imag)
    phi = torch.atan2(h.imag, h.real)
    theta = _fold_angle(0.5 * torch.atan2(2.0 * mag, dd))
    c = torch.cos(theta)
    s = torch.polar(-torch.sin(theta), phi)
    return _givens(n, p, q, c.to(s.dtype), s)


def eigh_hermitian(H: torch.Tensor, sweeps: int = 10):
    """Complex Hermitian eigendecomposition of (..., n, n) -> (w, V) with
    H = V diag(w) V^dag, w real ascending (JAX ops/eig.eigh_hermitian)."""
    n = H.shape[-1]
    V = torch.eye(n, dtype=H.dtype, device=H.device).expand(H.shape)
    for _ in range(sweeps):
        for p, q in _pairs(n):
            J = _hermitian_rotation(n, p, q, H[..., p, q], H[..., p, p].real - H[..., q, q].real)
            H = J.conj().transpose(-2, -1) @ H @ J
            V = V @ J
    w = torch.diagonal(H, dim1=-2, dim2=-1).real
    order = torch.argsort(w, dim=-1)
    return torch.gather(w, -1, order), torch.gather(V, -1, order[..., None, :].expand(V.shape))


def eig_unitary(U: torch.Tensor, sweeps: int = 12):
    """(theta, V) with U = V diag(e^{i theta}) V^dag for (..., n, n) unitary
    U (JAX ops/eig.eig_unitary): A = (U + U^dag)/2 and B = (U - U^dag)/(2i)
    are commuting Hermitian matrices; each rotation zeroes the pivot of
    whichever of the two has the larger one, applied to both."""
    n = U.shape[-1]
    Ud = U.conj().transpose(-2, -1)
    A = 0.5 * (U + Ud)
    B = -0.5j * (U - Ud)
    V = torch.eye(n, dtype=U.dtype, device=U.device).expand(U.shape)
    for _ in range(sweeps):
        for p, q in _pairs(n):
            ha, hb = A[..., p, q], B[..., p, q]
            use_a = (ha.real**2 + ha.imag**2) >= (hb.real**2 + hb.imag**2)
            h = torch.where(use_a, ha, hb)
            dd = torch.where(use_a, A[..., p, p].real - A[..., q, q].real, B[..., p, p].real - B[..., q, q].real)
            J = _hermitian_rotation(n, p, q, h, dd)
            Jd = J.conj().transpose(-2, -1)
            A = Jd @ A @ J
            B = Jd @ B @ J
            V = V @ J
    a = torch.diagonal(A, dim1=-2, dim2=-1).real
    b = torch.diagonal(B, dim1=-2, dim2=-1).real
    return torch.atan2(b, a), V
