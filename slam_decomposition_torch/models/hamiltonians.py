"""The conversion-gain Hamiltonian and its propagator (JAX
models/hamiltonians.py:64-100), batched over broadcastable parameters.

Operator conventions are the JAX package's: raising operator
cr = [[0, 0], [1, 0]], big-endian tensor order A = kron(cr, I),
B = kron(I, cr). Only what the parameterized templates use is here; the
smush (Trotter) products, fsim, the circulator and the delta gates are not
ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.ops.expm import expm_taylor

_CR = np.array([[0.0, 0.0], [1.0, 0.0]])
_A2 = np.kron(_CR, np.eye(2))
_B2 = np.kron(np.eye(2), _CR)
K_CONV = _A2 @ _B2.T  # A B^dag (conversion / hopping)
K_GAIN = _A2 @ _B2  # A B (gain / two-mode squeeze)


def _real(v, dtype, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=dtype, device=device)


def _param_device(*params):
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def _phased(K: np.ndarray, g: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """g (e^{i phi} K + e^{-i phi} K^dag) for a real generator K."""
    Kt = torch.as_tensor(K, dtype=g.dtype, device=g.device)
    re = (torch.cos(phi) * g)[..., None, None] * (Kt + Kt.T)
    im = (torch.sin(phi) * g)[..., None, None] * (Kt - Kt.T)
    return torch.complex(re, im)


def conversion_gain_h(gc, gg, phi_c=0.0, phi_g=0.0, dtype=torch.float64) -> torch.Tensor:
    """H = gc (e^{i phi_c} A B^dag + h.c.) + gg (e^{i phi_g} A B + h.c.),
    (..., 4, 4) complex over the broadcast of its parameters (numbers or
    real tensors; the result lies on the tensors' device)."""
    dev = _param_device(gc, gg, phi_c, phi_g)
    gc, gg, phi_c, phi_g = torch.broadcast_tensors(*(_real(v, dtype, dev) for v in (gc, gg, phi_c, phi_g)))
    return _phased(K_CONV, gc, phi_c) + _phased(K_GAIN, gg, phi_g)


def conversion_gain_u(gc, gg, phi_c=0.0, phi_g=0.0, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """U = expm(-i t H) of ``conversion_gain_h``."""
    H = conversion_gain_h(gc, gg, phi_c, phi_g, dtype=dtype)
    t = _real(t, dtype, H.device)
    return expm_taylor(-1j * t[..., None, None] * H)


def snail_effective_u(geff, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """The iSwap family: conversion alone (gain = 0)."""
    return conversion_gain_u(geff, 0.0, t=t, dtype=dtype)
