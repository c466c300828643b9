"""Haar-random U(4) targets: the generator of the `haar` traffic mixes.

Frozen copy of the method of `slam_decomposition_torch/opt/samplers.py`
`haar_sample` (complex Ginibre matrices, QR, the phase of R's diagonal
moved into Q), made on the device from a `torch.Generator`: the Q of a QR
whose R has a positive real diagonal is what Gram-Schmidt gives on the
columns, which `orthonormalize` computes in a few batched tensor
operations. `benchmark/tests/test_perfbench_copies.py` holds it equal to
`haar_sample` on the same Ginibre draw.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1 << 20  # targets made at once (bounds the temporaries)


def orthonormalize(z: torch.Tensor) -> torch.Tensor:
    """(..., d, d) complex -> Q of z = Q R with R's diagonal real and positive
    (modified Gram-Schmidt over the columns)."""
    q = z.clone()
    d = z.shape[-1]
    for j in range(d):
        v = q[..., :, j]
        for i in range(j):
            u = q[..., :, i]
            v = v - (u.conj() * v).sum(-1, keepdim=True) * u
        q[..., :, j] = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return q


def ginibre(n: int, gen: torch.Generator, device, d: int = 4) -> torch.Tensor:
    """(n, d, d) complex128 with independent standard complex normal entries."""
    re_im = torch.randn((n, d, d, 2), generator=gen, device=device, dtype=torch.float64)
    return torch.complex(re_im[..., 0], re_im[..., 1]) / math.sqrt(2.0)


def pool(n: int, seed: int, device) -> torch.Tensor:
    """(n, 4, 4) complex128 Haar-random targets on ``device``, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty((n, 4, 4), dtype=torch.complex128, device=device)
    for s in range(0, n, BLOCK):
        m = min(BLOCK, n - s)
        out[s : s + m] = orthonormalize(ginibre(m, gen, device))
    return out
