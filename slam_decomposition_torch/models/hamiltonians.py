"""Parameterized 2Q / 3Q Hamiltonians and their propagators (JAX
models/hamiltonians.py), batched over broadcastable parameters.

Operator conventions are the JAX package's: raising operator
cr = [[0, 0], [1, 0]], big-endian tensor order A = kron(cr, I),
B = kron(I, cr) (and C = kron(I, I, cr) on three qubits). Each Hamiltonian
is a function of numbers or real tensors returning a (..., d, d) complex
tensor on the tensors' device (the CPU for plain numbers); a propagator is
``expm_taylor`` of -i t H.

The smush (Trotter) products multiply the slices' propagators from the
left, the later slice on the left, as the JAX package does. Every slice's
Hamiltonian and propagator is built in one batched call over the slice
axis; only the product runs slice by slice.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.ops.expm import expm_taylor

_CR = np.array([[0.0, 0.0], [1.0, 0.0]])
_I2 = np.eye(2)


def _kron(*ms):
    out = ms[0]
    for m in ms[1:]:
        out = np.kron(out, m)
    return out


# 2Q generators (4x4, real)
_A2 = _kron(_CR, _I2)
_B2 = _kron(_I2, _CR)
K_CONV = _A2 @ _B2.T  # A B^dag (conversion / hopping)
K_GAIN = _A2 @ _B2  # A B (gain / two-mode squeeze)
K_X = _A2  # drive on qubit 0: gx (A + A^dag)
K_Y = _B2  # drive on qubit 1
K_Z1 = _A2.T @ _A2  # number operator of qubit 0
K_Z2 = _B2.T @ _B2

# 3Q generators (8x8)
_A3 = _kron(_CR, _I2, _I2)
_B3 = _kron(_I2, _CR, _I2)
_C3 = _kron(_I2, _I2, _CR)
K_AB = _A3 @ _B3.T
K_AC = _A3 @ _C3.T
K_BC = _B3 @ _C3.T
K_AB_G = _A3 @ _B3
K_AC_G = _A3 @ _C3
K_BC_G = _B3 @ _C3

# FSim generators
_SP = np.array([[0.0, 1.0], [0.0, 0.0]])
_SZ = np.diag([1.0, -1.0])
K_HOP = _kron(_SP, _I2) @ _kron(_I2, _SP).T + _kron(_SP, _I2).T @ _kron(_I2, _SP)
K_ZZ = _kron(_SZ, _SZ)


def _param_device(*params):
    for p in params:
        if isinstance(p, torch.Tensor):
            return p.device
    return torch.device("cpu")


def _reals(dtype, *params):
    """The parameters as real tensors of ``dtype`` on the first tensor's
    device (the CPU for plain numbers)."""
    dev = _param_device(*params)
    return [torch.as_tensor(v, dtype=dtype, device=dev) for v in params]


def _complex(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _phased(K: np.ndarray, g: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """g (e^{i phi} K + e^{-i phi} K^dag) for a real generator K."""
    Kt = torch.as_tensor(K, dtype=g.dtype, device=g.device)
    re = (torch.cos(phi) * g)[..., None, None] * (Kt + Kt.T)
    im = (torch.sin(phi) * g)[..., None, None] * (Kt - Kt.T)
    return torch.complex(re, im)


def _propagator(H: torch.Tensor, t) -> torch.Tensor:
    """expm(-i t H) for a duration t: a number, or a tensor batched like
    H's leading axes."""
    t = torch.as_tensor(t, dtype=H.real.dtype, device=H.device)
    return expm_taylor(-1j * (t[..., None, None] * H))


def conversion_gain_h(gc, gg, phi_c=0.0, phi_g=0.0, dtype=torch.float64) -> torch.Tensor:
    """H = gc (e^{i phi_c} A B^dag + h.c.) + gg (e^{i phi_g} A B + h.c.),
    (..., 4, 4) complex over the broadcast of its parameters."""
    gc, gg, phi_c, phi_g = torch.broadcast_tensors(*_reals(dtype, gc, gg, phi_c, phi_g))
    return _phased(K_CONV, gc, phi_c) + _phased(K_GAIN, gg, phi_g)


def conversion_gain_u(gc, gg, phi_c=0.0, phi_g=0.0, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """U = expm(-i t H) of ``conversion_gain_h``; ``t`` may be batched like
    the other parameters."""
    H = conversion_gain_h(gc, gg, phi_c, phi_g, dtype=dtype)
    t = torch.as_tensor(t, dtype=dtype, device=H.device)
    return expm_taylor(-1j * t[..., None, None] * H)


def snail_effective_u(geff, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """The iSwap family: conversion alone (gain = 0)."""
    return conversion_gain_u(geff, 0.0, t=t, dtype=dtype)


def smush_h(phi_c, phi_g, gc, gg, gx, gy, dtype=torch.float64) -> torch.Tensor:
    """Conversion + gain plus simultaneous 1Q drives gx (A + A^dag) and
    gy (B + B^dag), (..., 4, 4) over the broadcast of the parameters."""
    phi_c, phi_g, gc, gg, gx, gy = _reals(dtype, phi_c, phi_g, gc, gg, gx, gy)
    zero = torch.zeros_like(gx)
    return conversion_gain_h(gc, gg, phi_c, phi_g, dtype=dtype) + _phased(K_X, gx, zero) + _phased(K_Y, gy, zero)


def _per_slice(*params):
    """Coupling parameters batched like a drive vector (..., n): a trailing
    slice axis of length 1."""
    return [p[..., None] for p in params]


def smush_slices(phi_c, phi_g, gc, gg, gx_vec, gy_vec, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """The (..., n, 4, 4) propagators expm(-i dt H(gx_i, gy_i)), dt = t / n,
    of a pulse's n drive slices: one batched expm. ``t`` is a number or a
    tensor batched like the drive vectors' leading axes (a duration per
    pulse)."""
    phi_c, phi_g, gc, gg, gx, gy = _reals(dtype, phi_c, phi_g, gc, gg, gx_vec, gy_vec)
    H = smush_h(*_per_slice(phi_c, phi_g, gc, gg), gx, gy, dtype=dtype)
    dt = torch.as_tensor(t, dtype=dtype, device=gx.device) / gx.shape[-1]
    return _propagator(H, dt[..., None])


def ordered_product(Us: torch.Tensor) -> torch.Tensor:
    """U_n ... U_2 U_1 of (..., n, d, d) slices: each later slice
    multiplies from the left."""
    U = Us[..., 0, :, :]
    for i in range(1, Us.shape[-3]):
        U = Us[..., i, :, :] @ U
    return U


def smush_u(phi_c, phi_g, gc, gg, gx_vec, gy_vec, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """Trotter product over piecewise-constant 1Q drive slices:
    U = prod_i expm(-i dt H(gx_i, gy_i)), dt = t / n, the later slice on
    the left (JAX hamiltonians.py:116-156). The coupling parameters and
    ``t`` (a number, or a duration per pulse as a tensor) batch like the
    drive vectors' leading axes."""
    return ordered_product(smush_slices(phi_c, phi_g, gc, gg, gx_vec, gy_vec, t, dtype))


def smush_1q_phase_u(
    phi_a, phi_b, phi_c, phi_g, gc, gg, gz1, gz2, gx_vec, gy_vec, t=1.0, dtype=torch.float64,
) -> torch.Tensor:
    """Smush with per-qubit drive phases phi_a, phi_b and detunings gz1 Z1 +
    gz2 Z2 (number operators; JAX hamiltonians.py:159-192)."""
    phi_a, phi_b, phi_c, phi_g, gc, gg, gz1, gz2, gx, gy = _reals(
        dtype, phi_a, phi_b, phi_c, phi_g, gc, gg, gz1, gz2, gx_vec, gy_vec
    )
    phi_a, phi_b, phi_c, phi_g, gc, gg, gz1, gz2 = _per_slice(phi_a, phi_b, phi_c, phi_g, gc, gg, gz1, gz2)
    z1 = torch.as_tensor(K_Z1, dtype=dtype, device=gx.device)
    z2 = torch.as_tensor(K_Z2, dtype=dtype, device=gx.device)
    Hz = gz1[..., None, None] * z1 + gz2[..., None, None] * z2
    H = (
        conversion_gain_h(gc, gg, phi_c, phi_g, dtype=dtype)
        + _phased(K_X, gx, phi_a)
        + _phased(K_Y, gy, phi_b)
        + torch.complex(Hz, torch.zeros_like(Hz))
    )
    return ordered_product(_propagator(H, torch.as_tensor(t, dtype=dtype) / gx.shape[-1]))


def evolve_piecewise(Hs: torch.Tensor, psi0: torch.Tensor, dt) -> torch.Tensor:
    """States after each slice of a piecewise-constant Hamiltonian: Hs
    (n, d, d) complex, psi0 (d,) complex -> (n + 1, d) [psi0, psi1, ...,
    psin] with psi_{i+1} = expm(-i dt H_i) psi_i (JAX hamiltonians.py:195)."""
    Us = _propagator(Hs, dt)
    psi = torch.as_tensor(psi0, dtype=Us.dtype, device=Us.device)
    states = [psi]
    for i in range(Us.shape[0]):
        psi = Us[i] @ psi
        states.append(psi)
    return torch.stack(states)


def evolve_smush(phi_c, phi_g, gc, gg, gx_vec, gy_vec, psi0, t=1.0, dtype=torch.float64) -> torch.Tensor:
    """The (n_slices + 1, 4) states along a smush pulse from psi0; pair with
    ``populations`` for the excitation-transfer curves."""
    phi_c, phi_g, gc, gg, gx, gy = _reals(dtype, phi_c, phi_g, gc, gg, gx_vec, gy_vec)
    Hs = smush_h(phi_c, phi_g, gc, gg, gx, gy, dtype=dtype)
    return evolve_piecewise(Hs, psi0, torch.as_tensor(t, dtype=dtype) / gx.shape[-1])


def populations(states: torch.Tensor) -> torch.Tensor:
    """|amplitude|^2 per basis state, any leading batch / time axes."""
    return states.real**2 + states.imag**2


def fsim_h(g, eta, dtype=torch.float64) -> torch.Tensor:
    """H = g (s+ s- + s- s+) + (g^2 / |eta|) ZZ."""
    g, eta = torch.broadcast_tensors(*_reals(dtype, g, eta))
    hop = torch.as_tensor(K_HOP, dtype=dtype, device=g.device)
    zz = torch.as_tensor(K_ZZ, dtype=dtype, device=g.device)
    re = g[..., None, None] * hop + (g**2 / torch.abs(eta))[..., None, None] * zz
    return torch.complex(re, torch.zeros_like(re))


def fsim_u(g, eta, t=1.0, dtype=torch.float64) -> torch.Tensor:
    H = fsim_h(g, eta, dtype=dtype)
    t = torch.as_tensor(t, dtype=dtype, device=H.device)
    return expm_taylor(-1j * t[..., None, None] * H)


def circulator_h(phi_ab, phi_ac, phi_bc, g_ab, g_ac, g_bc, dtype=torch.float64) -> torch.Tensor:
    """3Q circulator: pairwise phased conversion couplings, (..., 8, 8)."""
    phi_ab, phi_ac, phi_bc, g_ab, g_ac, g_bc = torch.broadcast_tensors(
        *_reals(dtype, phi_ab, phi_ac, phi_bc, g_ab, g_ac, g_bc)
    )
    return _phased(K_AB, g_ab, phi_ab) + _phased(K_AC, g_ac, phi_ac) + _phased(K_BC, g_bc, phi_bc)


def circulator_u(phi_ab, phi_ac, phi_bc, g_ab, g_ac, g_bc, t=1.0, dtype=torch.float64) -> torch.Tensor:
    H = circulator_h(phi_ab, phi_ac, phi_bc, g_ab, g_ac, g_bc, dtype=dtype)
    t = torch.as_tensor(t, dtype=dtype, device=H.device)
    return expm_taylor(-1j * t[..., None, None] * H)


def delta_conversion_gain_h(
    gphi_ab, gphi_ac, gphi_bc, g_ab, g_ac, g_bc, cphi_ab, cphi_ac, cphi_bc, c_ab, c_ac, c_bc,
    dtype=torch.float64,
) -> torch.Tensor:
    """3Q pairwise conversion + gain (12 parameters), (..., 8, 8). Each pair
    takes its own phases, as in the JAX package (the reference it follows
    used cphi_ac for the ab pair)."""
    p = torch.broadcast_tensors(
        *_reals(dtype, gphi_ab, gphi_ac, gphi_bc, g_ab, g_ac, g_bc, cphi_ab, cphi_ac, cphi_bc, c_ab, c_ac, c_bc)
    )
    gphi, g, cphi, c = p[0:3], p[3:6], p[6:9], p[9:12]
    H = torch.zeros(p[0].shape + (8, 8), dtype=_complex(dtype), device=p[0].device)
    for i, (Kc, Kg) in enumerate(((K_AB, K_AB_G), (K_AC, K_AC_G), (K_BC, K_BC_G))):
        H = H + _phased(Kc, c[i], cphi[i])
        H = H + _phased(Kg, g[i], gphi[i])
    return H


def delta_conversion_gain_u(*args, t=1.0, dtype=torch.float64) -> torch.Tensor:
    H = delta_conversion_gain_h(*args, dtype=dtype)
    t = torch.as_tensor(t, dtype=dtype, device=H.device)
    return expm_taylor(-1j * t[..., None, None] * H)
