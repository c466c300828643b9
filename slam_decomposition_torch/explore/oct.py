"""Optimal-control pulse shaping for parallel-driven (smush) gates (JAX
explore/oct.py): shape the piecewise-constant 1Q drive envelopes gx(t),
gy(t) riding a fixed conversion / gain coupling so that the propagator
meets an objective. GRAPE: Adam on the functional, gradients by reverse-mode
autograd through the Trotter product, every restart in one batch.

Functionals (0 = goal reached):
  - ``"hs"``      Hilbert-Schmidt gate distance, phase-aware (krotov
                  ``J_T_hs``);
  - ``"square"``  phase-invariant trace infidelity (``costs.square_cost``);
  - ``"li"``      local-invariant functional (``costs.
                  makhlin_functional_cost``): the target's local class;
  - ``"pe"``      perfect-entangler functional g3 sqrt(g1^2 + g2^2) - g1,
                  descended as a hinge; the returned solution is the first
                  iterate that passes the exact membership test
                  (``is_perfect_entangler``), else the iterate of smallest
                  |F_PE|.

The update shape (a sin^2-ramped flattop) multiplies the raw parameters,
so pulses rise from and return to zero whatever the optimizer does; an
optional amplitude penalty mirrors Krotov's lambda_a running cost.

Starts: ``optimize_pulses`` draws the JAX package's numbers at ``seed``, bit
for bit (``ops.threefry.uniform``: jax.random's generator in numpy);
``optimize_pulses_from`` takes the starts themselves.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.models.hamiltonians import smush_u
from slam_decomposition_torch.ops import threefry, weyl
from slam_decomposition_torch.opt import costs


def flattop(n_slices: int, rise_frac: float = 0.05, dtype=torch.float64) -> torch.Tensor:
    """sin^2-ramped flattop window at the slice midpoints (krotov.shapes.
    flattop with t_rise = T rise_frac, func='sinsq'): 0 -> 1 over the rise,
    flat 1, 1 -> 0 over the fall. A CPU tensor."""
    t = (torch.arange(n_slices, dtype=dtype) + 0.5) / n_slices
    rise = torch.clamp(t / rise_frac, 0.0, 1.0)
    fall = torch.clamp((1.0 - t) / rise_frac, 0.0, 1.0)
    return torch.sin(0.5 * math.pi * rise) ** 2 * torch.sin(0.5 * math.pi * fall) ** 2


def pe_functional(U: torch.Tensor) -> torch.Tensor:
    """F_PE = g3 sqrt(g1^2 + g2^2) - g1 over the Makhlin invariants: zero on
    the perfect-entangler polytope's boundary, <= 0 inside it on the
    identity side of the chamber (c1 + c2 <= 1; SWAP reads -2 and is no
    perfect entangler). 1e-300 keeps the gradient finite at g1 = g2 = 0."""
    g = weyl.g1g2g3(U)
    return g[..., 2] * torch.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2 + 1e-300) - g[..., 0]


def is_perfect_entangler(U: torch.Tensor, tol: float = 1e-9) -> torch.Tensor:
    """Exact perfect-entangler membership on Weyl coordinates (units of
    pi/2): c1 + c2 >= 1/2, c1 - c2 <= 1/2, c2 + c3 <= 1/2."""
    c = weyl.c1c2c3(U)
    return (
        (c[..., 0] + c[..., 1] >= 0.5 - tol)
        & (c[..., 0] - c[..., 1] <= 0.5 + tol)
        & (c[..., 1] + c[..., 2] <= 0.5 + tol)
    )


def hs_cost(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """krotov.functionals.J_T_hs: ||U - V||_HS^2 / (2 d^2), phase-aware."""
    d = U.shape[-1]
    diff = U - V
    return (diff.real**2 + diff.imag**2).sum(dim=(-2, -1)) / (2.0 * d * d)


class OCTResult(NamedTuple):
    """Best-restart pulse solution.

    pulses: (n_channels, n_slices) shaped drive envelopes (window applied);
    raw:    the unwindowed parameters that produced them;
    value:  the functional at the solution (penalty excluded);
    U:      the final propagator, (4, 4) complex on the solve's device;
    history: (iters + 1,) the winning restart's functional per iteration.
    """

    pulses: np.ndarray
    raw: np.ndarray
    value: np.ndarray
    U: torch.Tensor
    history: np.ndarray


def make_smush_eval(
    gc: float,
    gg: float,
    n_slices: int,
    t: float = 1.0,
    phi_c: float = 0.0,
    phi_g: float = 0.0,
    window: Optional[torch.Tensor] = None,
    device=DEFAULT_DEVICE,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Pulses (..., 2, n_slices) [gx; gy] -> the total propagator (..., 4, 4).
    The window (default ``flattop(n_slices)``) multiplies the raw
    parameters; it rides on the function as ``.window``, and the device the
    solve runs on as ``.device`` (the card unless ``device`` names
    another)."""
    dev = resolve_device(device)
    w = (flattop(n_slices) if window is None else torch.as_tensor(window, dtype=torch.float64)).to(dev)

    def eval_fn(p: torch.Tensor) -> torch.Tensor:
        shaped = p * w
        return smush_u(phi_c, phi_g, gc, gg, shaped[..., 0, :], shaped[..., 1, :], t=t)

    eval_fn.window = w
    eval_fn.device = dev
    return eval_fn


def _functional(kind: str, target: Optional[torch.Tensor]):
    if kind == "pe":
        return pe_functional
    if target is None:
        raise ValueError(f"functional '{kind}' needs a target unitary")
    if kind == "hs":
        return lambda U: hs_cost(U, target)
    if kind == "square":
        return lambda U: costs.square_cost(target, U)
    if kind == "li":
        return lambda U: costs.makhlin_functional_cost(target, U)
    raise ValueError(f"unknown functional '{kind}'")


def optimize_pulses(
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    n_slices: int,
    functional: str = "square",
    target=None,
    n_channels: int = 2,
    restarts: int = 8,
    iters: int = 300,
    lr: float = 0.15,
    amp_penalty: float = 0.0,
    amp0: float = 2.0,
    seed: int = 0,
) -> OCTResult:
    """GRAPE from ``restarts`` random starts, uniform in [-amp0, amp0) per
    channel and slice: the JAX package's draw at ``seed``. See
    ``optimize_pulses_from``."""
    p0 = (threefry.uniform(seed, (restarts, n_channels, n_slices)) * 2.0 - 1.0) * amp0
    return optimize_pulses_from(eval_fn, p0, functional, target, iters, lr, amp_penalty)


def optimize_pulses_from(
    eval_fn: Callable[[torch.Tensor], torch.Tensor],
    p0,
    functional: str = "square",
    target=None,
    iters: int = 300,
    lr: float = 0.15,
    amp_penalty: float = 0.0,
) -> OCTResult:
    """GRAPE from the starts p0 (R, n_channels, n_slices) (JAX
    oct.py:169-350): Adam on every restart at once, lr halving every iters/3
    steps, the functional of each pre-update point logged, then the final
    point appended. amp_penalty * mean(p^2) per restart joins the descended
    objective, not the reported values. Non-PE functionals select the best
    restart's final point; "pe" selects the first iterate (restart-major)
    inside the perfect-entangler polytope, else the one of smallest |F_PE|.
    ``eval_fn`` must carry its window as ``.window`` (``make_smush_eval``
    sets it) and runs on its ``.device``."""
    w = getattr(eval_fn, "window", None)
    if w is None:
        raise ValueError(
            "eval_fn must carry its update-shape window as `.window` (make_smush_eval sets it); "
            "reported pulses would not match the propagator otherwise"
        )
    dev = w.device
    if target is not None:
        target = torch.as_tensor(target, dtype=torch.complex128, device=dev)
    fn = _functional(functional, target)
    is_pe = functional == "pe"

    p = torch.as_tensor(p0, dtype=torch.float64).to(dev)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    hist, p_hist = [], []
    for i in range(iters):
        pg = p.detach().requires_grad_(True)
        val = fn(eval_fn(pg))
        # PE descent: the hinge max(F_PE, 0), since F_PE keeps falling past
        # the polytope on the SWAP side
        desc = torch.clamp_min(val, 0.0) if is_pe else val
        obj = desc + amp_penalty * (pg * pg).mean(dim=(-2, -1))
        (g,) = torch.autograd.grad(obj.sum(), pg)
        hist.append(val.detach())
        p_hist.append(p)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * (g * g)
        mhat = m / (1.0 - 0.9 ** (i + 1.0))
        vhat = v / (1.0 - 0.999 ** (i + 1.0))
        p = p - lr * (0.5 ** (i / (iters / 3.0))) * mhat / (torch.sqrt(vhat) + 1e-8)
    with torch.no_grad():
        hist.append(fn(eval_fn(p)))
        p_hist.append(p)
        hist = torch.stack(hist, dim=1)  # (R, iters + 1)
        p_hist = torch.stack(p_hist, dim=1)  # (R, iters + 1, C, N)
        L = iters + 1
        if is_pe:
            member = is_perfect_entangler(eval_fn(p_hist)).reshape(-1)
            idx = int(torch.argmax(member.to(torch.int8))) if member.any() else int(torch.argmin(hist.abs()))
        else:
            idx = int(torch.argmin(hist[:, -1])) * L + (L - 1)
        r, i = idx // L, idx % L
        raw = p_hist[r, i]
        U = eval_fn(raw)
    return OCTResult(
        pulses=(raw * w).cpu().numpy(),
        raw=raw.cpu().numpy(),
        value=hist[r, i].cpu().numpy(),
        U=U,
        history=hist[r].cpu().numpy(),
    )
