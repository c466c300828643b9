"""Batched L-BFGS with backtracking line search (JAX opt/minimize.py).

The JAX package vmaps a per-lane ``lax.while_loop``; here one loop runs over
the (L, n) state of all lanes with per-lane masks, and computes per lane
exactly the recurrences of that loop: the two-loop recursion with memory 8
over a masked ring buffer (newest last), Armijo backtracking (c1 = 1e-4,
halving while t > 1e-20), a steepest-descent step where the quasi-Newton
direction is no descent direction, a curvature pair kept when s.y > 1e-14,
the history reset when a line search fails, and a lane finished when
f <= f_tol, max|g| <= g_tol, or a steepest-descent line search fails.
Bounds are a projection of every trial point. A finished lane's state does
not move: every update is masked, and no sum runs across lanes, so a NaN in
one lane stays there.

(The JAX two-loop's backward pass reads slot idx of the ring buffer where
idx < hist, its forward pass where idx >= memory - hist; until the buffer
is full these differ, and the direction is then the forward pass's
correction of gamma g alone. The port repeats this, lane for lane.)

``fun`` maps (L, n) to (L,) and closes over its per-lane data, so every
evaluation is of all lanes. The host reads the device once per outer
iteration (whether any lane is live, and whether any needs a second trial
step) and then once per block of backtracking trials, whose size doubles
from 4; a trial beyond a lane's accepted one leaves that lane as it was.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

C1 = 1e-4  # Armijo
T_MIN = 1e-20  # the line search gives up below this step
GOOD_PAIR = 1e-14  # a curvature pair is kept when s.y exceeds this
FIRST_BLOCK = 4  # backtracking trials before the host looks again; doubles


class LBFGSResult(NamedTuple):
    x: torch.Tensor  # (L, n)
    f: torch.Tensor  # (L,)
    n_iters: torch.Tensor  # (L,) int32
    converged: torch.Tensor  # (L,) bool: f <= f_tol
    n_evals: int  # batched evaluations of fun (with or without gradient)
    n_syncs: int  # reads of the device by the host


def _dot(a, b):
    return (a * b).sum(-1)


def _where(cond, a, b):
    """torch.where with a per-lane cond broadcast over a's trailing dims."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - cond.ndim)), a, b)


def _two_loop(g, S, Y, rho, hist, gamma, memory):
    """The two-loop recursion over the masked ring buffer, per lane."""
    q = g
    alphas = [None] * memory
    for i in range(memory):  # newest -> oldest
        idx = memory - 1 - i
        a = torch.where(idx < hist, rho[:, idx] * _dot(S[:, idx], q), torch.zeros_like(gamma))
        q = q - a[:, None] * Y[:, idx]
        alphas[idx] = a
    r = gamma[:, None] * q
    for idx in range(memory):  # oldest -> newest
        b = rho[:, idx] * _dot(Y[:, idx], r)
        r = r + torch.where(idx >= memory - hist, alphas[idx] - b, torch.zeros_like(b))[:, None] * S[:, idx]
    return r


def lbfgs(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iters: int = 400,
    f_tol: float = 0.0,
    g_tol: float = 1e-12,
    memory: int = 8,
    lower: Optional[torch.Tensor] = None,
    upper: Optional[torch.Tensor] = None,
) -> LBFGSResult:
    """Minimize ``fun`` from every row of x0 (L, n) at once; a lane stops
    when f <= f_tol or max|g| <= g_tol. Runs on x0's device."""
    L, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    count = {"evals": 0, "syncs": 0}

    def project(x):
        return x if lower is None else torch.clamp(x, lower, upper)

    def value(x):
        count["evals"] += 1
        with torch.no_grad():
            return fun(x)

    def value_and_grad(x):
        count["evals"] += 1
        xg = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(xg)
            (g,) = torch.autograd.grad(f.sum(), xg)
        return f.detach(), g

    def flags(*conds):
        count["syncs"] += 1
        return torch.stack([c.any() for c in conds]).tolist()

    x = x0.detach()
    f, g = value_and_grad(x)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    S = torch.zeros((L, memory, n), dtype=dtype, device=dev)
    Y = torch.zeros_like(S)
    rho = torch.zeros((L, memory), dtype=dtype, device=dev)
    hist = torch.zeros(L, dtype=torch.int32, device=dev)
    gamma = torch.ones(L, dtype=dtype, device=dev)
    done = (f <= f_tol) | (g.abs().amax(-1) <= g_tol)

    while True:
        live = ~done & (it < max_iters)
        d = -_two_loop(g, S, Y, rho, hist, gamma, memory)
        gd = _dot(g, d)
        bad = gd >= 0  # no descent direction: steepest descent
        d = _where(bad, -g, d)
        gd = torch.where(bad, -_dot(g, g), gd)

        # backtracking, t = 1, 1/2, ...: a lane takes the first t that
        # meets the Armijo bound and stops; without one it fails
        xn = project(x + d)
        fn = value(xn)
        ok = fn <= f + C1 * gd
        any_live, more = flags(live, live & ~ok)
        if not any_live:
            break
        t, block = 0.5, FIRST_BLOCK
        while more and t > T_MIN:
            for _ in range(block):
                if t <= T_MIN:
                    break
                need = live & ~ok
                xt = project(x + t * d)
                ft = value(xt)
                xn = _where(need, xt, xn)
                fn = torch.where(need, ft, fn)
                ok = torch.where(need, ft <= f + C1 * t * gd, ok)
                t *= 0.5
            (more,) = flags(live & ~ok)
            block *= 2
        fail = ~ok
        xn = _where(fail, x, xn)
        fn = torch.where(fail, f, fn)
        _, gn = value_and_grad(xn)

        s = xn - x
        y = gn - g
        sy = _dot(s, y)
        good = live & (sy > GOOD_PAIR)
        S = _where(good, torch.cat([S[:, 1:], s[:, None]], dim=1), S)
        Y = _where(good, torch.cat([Y[:, 1:], y[:, None]], dim=1), Y)
        rho = _where(good, torch.cat([rho[:, 1:], (1.0 / sy.clamp_min(1e-300))[:, None]], dim=1), rho)
        new_hist = torch.where(good, (hist + 1).clamp_max(memory), hist)
        new_gamma = torch.where(good, sy / _dot(y, y).clamp_min(1e-300), gamma)
        # a failed line search wipes the history: restart as steepest descent
        new_hist = torch.where(fail, torch.zeros_like(hist), new_hist)
        new_gamma = torch.where(fail, torch.ones_like(gamma), new_gamma)
        new_done = (fn <= f_tol) | (gn.abs().amax(-1) <= g_tol) | (fail & (hist == 0))

        x = _where(live, xn, x)
        f = torch.where(live, fn, f)
        g = _where(live, gn, g)
        hist = torch.where(live, new_hist, hist)
        gamma = torch.where(live, new_gamma, gamma)
        done = torch.where(live, new_done, done)
        it = it + live.to(it.dtype)

    return LBFGSResult(x=x, f=f, n_iters=it, converged=f <= f_tol, n_evals=count["evals"], n_syncs=count["syncs"])
