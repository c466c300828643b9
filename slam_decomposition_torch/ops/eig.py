"""Fixed-sweep joint Jacobi diagonalization (JAX ops/eig.py:98), batched f64.

``torch.linalg.eig`` is kept off the main path: on CUDA it synchronises
with the host, is slow on 100k batched 4x4 matrices, and gives no ordering
or degeneracy guarantee. The fixed-sweep Cardoso-Souloumiac rotation below
is branch-free and deterministic, and resolves degeneracies of either
matrix alone.
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


def joint_diag(X: torch.Tensor, Y: torch.Tensor, sweeps: int = 12):
    """Jointly diagonalize commuting real symmetric (..., n, n) matrices.

    Returns (x, y, V) with X = V diag(x) V^T and Y = V diag(y) V^T. The
    inputs are not modified."""
    n = X.shape[-1]
    X = X.clone()
    Y = Y.clone()
    V = torch.eye(n, dtype=X.dtype, device=X.device).expand(X.shape).clone()
    for _ in range(sweeps):
        for p, q in _pairs(n):
            ux = X[..., p, q]
            vx = 0.5 * (X[..., p, p] - X[..., q, q])
            uy = Y[..., p, q]
            vy = 0.5 * (Y[..., p, p] - Y[..., q, q])
            num = 2.0 * (ux * vx + uy * vy)
            den = vx * vx + vy * vy - ux * ux - uy * uy
            theta = 0.25 * torch.atan2(num, den)
            c = torch.cos(theta)
            s = torch.sin(theta)
            _givens_apply_(X, p, q, c, s)
            _givens_apply_(Y, p, q, c, s)
            _rot_apply_right_(V, p, q, c, s)
    x = torch.diagonal(X, dim1=-2, dim2=-1)
    y = torch.diagonal(Y, dim1=-2, dim2=-1)
    return x, y, V
