"""Single-qubit gates as complex torch tensors (JAX ops/su2.py:10)."""

from __future__ import annotations

import torch


def u3(theta: torch.Tensor, phi: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """qiskit-convention U gate on broadcastable real angles -> (..., 2, 2)
    complex (complex64 for float32 angles, complex128 for float64)."""
    ct = torch.cos(theta / 2.0)
    st = torch.sin(theta / 2.0)
    zero = torch.zeros_like(ct)
    re = torch.stack(
        [
            torch.stack([ct, -torch.cos(lam) * st], dim=-1),
            torch.stack([torch.cos(phi) * st, torch.cos(phi + lam) * ct], dim=-1),
        ],
        dim=-2,
    )
    im = torch.stack(
        [
            torch.stack([zero, -torch.sin(lam) * st], dim=-1),
            torch.stack([torch.sin(phi) * st, torch.sin(phi + lam) * ct], dim=-1),
        ],
        dim=-2,
    )
    return torch.complex(re, im)
