"""Multi-start synthesis solvers (JAX opt/gauss_newton.py:29-53, 220-675):
Adam warm start, f32 LM ranking, f64 LM polish.

``make_solver`` builds the solver of one template on one device. Its
``solve`` takes x0s (B, R, n) and targets (B, d, d) and returns the polished
best restart per target with its cost:

1. Adam in f32 on every restart (the square cost for the phase residual,
   the squared residual otherwise);
2. f32 LM iterations on every restart, then a ranking of the restarts;
3. LM iterations in f64 from the best restart, and the final cost.

With ``top_m`` = m (JAX gauss_newton.py:240-249, 489-508) the restarts
are ranked by their cost after Adam and only each target's best m enter
step 2 (``keep_top_m``).

Two paths compute this, chosen by rule when the solver is built
(``make_solver``'s docstring): ``ChainSolver`` runs the three steps as the
three chain kernels (``ops.chain_kernels``: CUDA kernels on CUDA tensors,
their plain versions on CPU tensors), and certifies from the polish's final
accepted f = ||r||^2 as cost = 0.2 f - f^2/80 (exact for unitary pairs;
JAX gauss_newton.py:543-548). ``GeneralSolver`` runs them in plain PyTorch
for any ``eval_fn``, either residual, bounds and a ``final_cost_fn``.

``make_analytic_solver(k, device)`` replaces steps 1-2 by one batched
analytic synthesis (ops/kak_batch.make_analytic_init) and keeps the polish.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.convert import chain_gates_from_numpy
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.ops.kak_batch import make_analytic_init
from slam_decomposition_torch.utils import profiling

# lanes per LM chunk on the general path: forward-mode J holds n tangents of
# every intermediate of eval_fn at once (JAX maps its f64 LM over 1024-lane
# chunks for the same reason, gauss_newton.py:551-557); 8192 keeps the count
# of small launches per solve low on the card (peak memory: PERF.md)
LM_CHUNK = 8192


def certificate(f: torch.Tensor) -> torch.Tensor:
    """Square cost 1 - (|tr|^2 + 4)/20 from f = ||r||^2 = 8 - 2|tr|."""
    return 0.2 * f - f * f / 80.0


def phase_residual(eval_fn, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """r = vec(V(x) - e^{i phi} T), phi = arg tr(T^dag V), as (..., 2 d^2)
    reals: the real parts, then the imaginary parts, row-major. Same
    minimizers as the trace costs."""
    V = eval_fn(x)
    t = ck.trace_overlap(V, tgt)
    z = t / torch.sqrt(t.real**2 + t.imag**2 + 1e-300)
    d = V - z[..., None, None] * tgt
    return torch.cat([d.real.flatten(-2), d.imag.flatten(-2)], dim=-1)


def makhlin_residual(eval_fn, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """r = g(V(x)) - g(T), the three Makhlin invariants (traces only): zero
    exactly on the target's local-equivalence class, the shared minimizer
    set of the reduced / Weyl / Makhlin cost family."""
    return weyl.g1g2g3(eval_fn(x)) - weyl.g1g2g3(tgt)


RESIDUALS = {"phase": phase_residual, "makhlin": makhlin_residual}


def keep_top_m(cost: torch.Tensor, m: int) -> torch.Tensor:
    """cost (B, R) -> (B, m) restart indices of each target's m smallest
    costs, in ascending cost and, on ties, the lower index first: the
    selection of JAX ``lax.top_k(-cost, m)``. A NaN cost ranks last."""
    return torch.argsort(cost, dim=1, stable=True)[:, :m]


def gather_restarts(xs: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """xs (B, R, n), keep (B, m) -> (B * m, n) contiguous: the kept restarts
    of each target, in ``keep``'s order."""
    B, m = keep.shape
    return xs.gather(1, keep[..., None].expand(B, m, xs.shape[-1])).reshape(B * m, -1).contiguous()


def _checked_top_m(top_m: Optional[int], R: int) -> int:
    """The restarts per target that enter the f32 LM: R without a cut."""
    if top_m is None:
        return R
    if not 1 <= top_m <= R:
        raise ValueError(f"top_m must lie in 1..{R} (the restarts per target), got {top_m}")
    return top_m


def _best_restart(xs: torch.Tensor, fs: torch.Tensor) -> torch.Tensor:
    """xs (B, R, n), fs (B, R) -> (B, n): each target's restart of smallest f."""
    best = torch.argmin(fs, dim=1)
    return xs[torch.arange(xs.shape[0], device=xs.device), best]


class GeneralSolver:
    """The solver of any template, in plain PyTorch (the arithmetic of JAX
    gauss_newton.py:316-587): ``eval_fn`` maps (..., n) to (..., d, d),
    batched by shape.

    Gradients are reverse-mode autograd of the summed per-lane cost;
    Jacobians are forward-mode columns, one JVP per one-hot tangent vmapped
    over the tangents with the lanes batched inside (``chain_kernels.
    jacobian``). Both LM passes run over chunks of ``LM_CHUNK`` lanes.

    ``solve``, ``with_history``, ``polish``, ``polish_cert``, ``certify``
    take and return tensors on the solver's device. ``calls`` counts the
    solves the general path has run, over all its instances."""

    path = "general"
    calls = 0

    def __init__(
        self, eval_fn: Callable, n_params: int, adam_iters: int = 100, lm_iters: int = 6, lm32_iters: int = 8,
        adam_lr: float = 0.1, lower=None, upper=None, residual: str = "phase",
        final_cost_fn: Optional[Callable] = None, device=DEFAULT_DEVICE, top_m: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.top_m = top_m
        self.eval_fn = eval_fn
        self.n_params = n_params
        self.lm_iters, self.lm32_iters = lm_iters, lm32_iters
        self.residual = residual
        self.res_fn = RESIDUALS[residual]
        self.final_cost_fn = final_cost_fn
        self.sched = ck.adam_schedule(adam_iters, device=self.device, lr=adam_lr)
        self.bounds = None
        if lower is not None:
            self.bounds = tuple(torch.as_tensor(np.asarray(b), device=self.device) for b in (lower, upper))

    # ---------------- the pieces

    def project(self, x: torch.Tensor) -> torch.Tensor:
        if self.bounds is None:
            return x
        return torch.clamp(x, self.bounds[0].to(x.dtype), self.bounds[1].to(x.dtype))

    def cost(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The ranking and final cost: ``final_cost_fn`` if given, else the
        square cost 1 - (|tr|^2 + d) / (d (d + 1))."""
        V = self.eval_fn(x)
        if self.final_cost_fn is not None:
            return self.final_cost_fn(V, tgt)
        t = ck.trace_overlap(V, tgt)
        d = V.shape[-1]
        return 1.0 - (t.real**2 + t.imag**2 + d) / (d * (d + 1.0))

    def adam_cost(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The warm start's smooth objective: the square cost for the phase
        residual, the squared residual otherwise (the reduced costs have
        cusps; the Makhlin functional shares their minimizers)."""
        if self.residual == "phase" and self.final_cost_fn is None:
            return self.cost(x, tgt)
        r = self.res_fn(self.eval_fn, x, tgt)
        return (r * r).sum(-1)

    def _adam(self, x32, tgt32, history=False):
        return ck.adam_loop(
            lambda x: self.adam_cost(x, tgt32).float(), x32, self.sched, self.project if self.bounds else None, history
        )

    def _lm(self, x, tgt, iters, history=False):
        """LM on (L, n) lanes against (L, d, d) targets, in chunks."""
        project = self.project if self.bounds else None
        outs = []
        for s in range(0, x.shape[0], LM_CHUNK):
            t = tgt[s : s + LM_CHUNK]
            t32 = t.to(torch.complex64)
            outs.append(
                ck.lm_loop(
                    lambda x1, t=t: self.res_fn(self.eval_fn, x1, t),
                    lambda x1, t32=t32: self.res_fn(self.eval_fn, x1, t32),
                    x[s : s + LM_CHUNK], iters, project, history,
                )
            )
        return tuple(torch.cat(parts) for parts in zip(*outs))

    # ---------------- the solver's interface

    def rank(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """Steps 1-2: x0s (B, R, n), tgt (B, d, d) -> (xs (B, M, n) f32 after
        Adam and the f32 LM, scores (B, M) f32: the cost of each restart,
        smallest best). M = R, or with ``top_m`` the m restarts of least
        ``adam_cost`` after Adam (JAX ranks by it on this path,
        gauss_newton.py:502-506), in ascending order of it."""
        B, R, n = x0s.shape
        M = _checked_top_m(self.top_m, R)
        t32 = tgt.to(torch.complex64)
        tR = t32.repeat_interleave(R, dim=0)
        xs = self._adam(x0s.reshape(B * R, n).float(), tR)
        if self.top_m is not None:
            keep = keep_top_m(self.adam_cost(xs, tR).view(B, R), M)
            xs, tR = gather_restarts(xs.view(B, R, n), keep), t32.repeat_interleave(M, dim=0)
        if self.lm32_iters > 0:
            xs, _ = self._lm(xs, tR, self.lm32_iters)
        return xs.view(B, M, n), self.cost(xs, tR).view(B, M)

    def solve(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """x0s (B, R, n) f64, tgt (B, d, d) complex128 -> (x (B, n) f64,
        cost (B,) f64) of the best restart per target."""
        GeneralSolver.calls += 1
        return self.polish_cert(_best_restart(*self.rank(x0s, tgt)).to(x0s.dtype), tgt)

    __call__ = solve

    def with_history(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """As ``solve`` without the f32 LM pass, also returning the Adam
        losses of every restart (B, R, adam_iters) and the accepted ||r||^2
        of the winner's f64 LM after each iteration (B, lm_iters)."""
        GeneralSolver.calls += 1
        B, R, n = x0s.shape
        t32 = tgt.to(torch.complex64).repeat_interleave(R, dim=0)
        xs, hist = self._adam(x0s.reshape(B * R, n).float(), t32, history=True)
        xb = _best_restart(xs.view(B, R, n), self.cost(xs, t32).view(B, R)).to(x0s.dtype)
        xb, _, lm_hist = self._lm(xb, tgt, self.lm_iters, history=True)
        return xb, self.cost(xb, tgt), hist.view(B, R, -1), lm_hist

    def polish(self, x: torch.Tensor, tgt: torch.Tensor, iters: Optional[int] = None) -> torch.Tensor:
        """f64 LM only, from an already good x (B, n) -> (B, n)."""
        iters = self.lm_iters if iters is None else iters
        return self._lm(x, tgt, iters)[0] if iters > 0 else x

    def polish_cert(self, x: torch.Tensor, tgt: torch.Tensor):
        """polish + the final cost of its x."""
        x = self.polish(x, tgt)
        return x, self.cost(x, tgt)

    def certify(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The cost of x against tgt, in x's precision."""
        return self.cost(x, tgt)


class ChainSolver:
    """The kernel path: the solver of one plain u3 chain of depth k on one
    device (the card by default), for the phase residual and the square
    cost, without bounds."""

    path = "kernels"

    def __init__(
        self, chain_gates: np.ndarray, device=DEFAULT_DEVICE, adam_iters: int = ck.ADAM_ITERS,
        lm_iters: int = ck.LM_ITERS, lm32_iters: int = ck.LM32_ITERS, adam_lr: float = ck.ADAM_LR,
        top_m: Optional[int] = None,
    ):
        self.device = resolve_device(device)
        self.top_m = top_m
        self.gates64 = chain_gates_from_numpy(chain_gates, self.device)
        self.gates32 = self.gates64.to(torch.complex64)
        self.k = self.gates64.shape[0]
        self.n_params = 6 * (self.k + 1)
        self.lm_iters, self.lm32_iters = lm_iters, lm32_iters
        self._iters = dict(adam_iters=adam_iters, lm_iters=lm_iters, lm32_iters=lm32_iters, adam_lr=adam_lr)
        self.sched = ck.adam_schedule(adam_iters, device=self.device, lr=adam_lr)

    def rank(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """Steps 1-2: x0s (B, R, n), tgt (B, 4, 4) -> (xs (B, M, n) f32 after
        the Adam and LM kernels, scores (B, M) f32: each restart's ||r||^2 =
        8 - 2|tr|, monotone in the square cost, smallest best). M = R, or
        with ``top_m`` the m restarts of least square cost after Adam (the
        Adam kernel's cost instance), in ascending order of it; the LM
        kernel then runs on B * m lanes."""
        with profiling.span("solver.rank"):
            B, R, n = x0s.shape
            M = _checked_top_m(self.top_m, R)
            t32 = tgt.to(torch.complex64)
            tR = t32.repeat_interleave(R, dim=0).contiguous()
            x = x0s.reshape(B * R, n).float().contiguous()
            if self.top_m is None:
                xs = ck.adam_chain(x, tR, self.gates32, self.sched)
            else:
                xs, cost = ck.adam_chain(x, tR, self.gates32, self.sched, with_cost=True)
                xs = gather_restarts(xs.view(B, R, n), keep_top_m(cost.view(B, R), M))
                tR = t32.repeat_interleave(M, dim=0).contiguous()
            xs, fs = ck.lm_chain(xs, tR, self.gates32, self.lm32_iters)
            return xs.view(B, M, n), fs.view(B, M)

    def solve(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """x0s (B, R, n) f64, tgt (B, 4, 4) complex128 -> (x (B, n) f64,
        certified square cost (B,) f64) of the best restart per target."""
        return self.polish_cert(_best_restart(*self.rank(x0s, tgt)).double().contiguous(), tgt)

    __call__ = solve

    def with_history(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """The histories come from the general path, whatever the template
        (JAX gauss_newton.py:561-587): see ``GeneralSolver.with_history``."""
        g = self.gates64
        general = GeneralSolver(lambda x: chain_unitary(x, g), self.n_params, device=self.device, **self._iters)
        return general.with_history(x0s, tgt)

    def polish(self, x: torch.Tensor, tgt: torch.Tensor, iters: Optional[int] = None) -> torch.Tensor:
        """f64 LM only, from an already good x (B, n) -> (B, n): ``iters``
        iterations (default ``lm_iters``; JAX ``solve.polish``), none at
        0."""
        return self.polish_cert(x, tgt, iters)[0]

    def polish_cert(self, x: torch.Tensor, tgt: torch.Tensor, iters: Optional[int] = None):
        """polish + certified losses from the final accepted residual; at
        ``iters=0`` x is returned as it is, with the certificate of its
        residual."""
        iters = self.lm_iters if iters is None else iters
        with profiling.span("solver.polish"):
            xs, f = ck.polish_chain(x, tgt.contiguous(), self.gates64, iters)
            return (x if iters == 0 else xs), certificate(f)

    def certify(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The true f64 square cost of x against tgt."""
        return ck.square_cost(x, tgt, self.gates64)


def takes_kernels(chain_gates, residual="phase", final_cost_fn=None, lower=None) -> bool:
    """The routing rule of ``make_solver``: a plain u3 chain (``chain_gates``
    given) of a depth the kernels cover (``chain_kernels.KERNEL_KS``, 1..79:
    n = 6(k+1) <= 480; 1..12 as template instances, 13..79 through the
    depth-generic programs; depth 80 and deeper take the general path), the
    phase residual, the square cost, no bounds."""
    return (
        chain_gates is not None
        and residual == "phase"
        and final_cost_fn is None
        and lower is None
        and np.shape(chain_gates)[0] in ck.KERNEL_KS
    )


def make_solver(
    eval_fn: Callable, n_params: int, adam_iters: int = 100, lm_iters: int = 6, lm32_iters: int = 8,
    adam_lr: float = 0.1, lower=None, upper=None, residual: str = "phase",
    final_cost_fn: Optional[Callable] = None, chain_gates=None, device=DEFAULT_DEVICE, top_m: Optional[int] = None,
):
    """The solver of one template: an object with ``solve(x0s (B, R, n), tgt
    (B, d, d)) -> (x (B, n), cost (B,))``, ``with_history``, ``polish``,
    ``polish_cert``, ``certify``, ``n_params``, ``device`` and ``path``.

    ``eval_fn``: (..., n_params) -> (..., d, d). ``residual``: "phase" (an
    exact match of the unitary: the square and basic objectives) or
    "makhlin" (a match of the local-equivalence class: the reduced / Weyl /
    Makhlin objectives, d = 4). ``final_cost_fn(U, tgt)`` replaces the
    square cost in the ranking of restarts and the returned costs.
    ``lower`` / ``upper`` clamp every iterate. ``chain_gates``: the
    (k, 4, 4) constants of a plain u3 chain (``Ansatz.chain_gates``).
    ``top_m``: None (every restart enters the f32 LM), or m in 1..R, checked
    when the solve runs: only each target's m restarts of least cost after
    Adam enter it (``keep_top_m``), on both paths.

    Routing, by rule and not by a failed launch (``takes_kernels``; JAX
    gauss_newton.py:278-284 routes the same templates to its Pallas
    kernels): a plain chain of depth 1..79 with the phase residual, the
    square cost and no bounds takes the kernel path (``ChainSolver``: the
    three CUDA kernels on CUDA tensors, their plain versions on CPU
    tensors). Everything else, a chain of depth 80 or more included (the
    kernels cover depths 1..79), takes the general path (``GeneralSolver``),
    the same algorithm in plain PyTorch."""
    iters = dict(adam_iters=adam_iters, lm_iters=lm_iters, lm32_iters=lm32_iters, adam_lr=adam_lr, top_m=top_m)
    if takes_kernels(chain_gates, residual, final_cost_fn, lower):
        return ChainSolver(chain_gates, device, **iters)
    return GeneralSolver(
        eval_fn, n_params, lower=lower, upper=upper, residual=residual, final_cost_fn=final_cost_fn,
        device=device, **iters,
    )


class AnalyticSolver:
    """The analytic-warm-start solver of the k-application sqrt(iSwap)
    template (JAX gauss_newton.py:623-675): one batched f64 KAK synthesis
    seeds every lane inside the polish's basin, replacing the Adam
    multi-restart and f32 LM ranking phases.

    ``solve(tgt)`` takes (B, 4, 4) complex targets of the k-class and
    returns (x (B, n) f64, true f64 square cost (B,)); ``init_only(tgt)``
    is the synthesis alone; ``repolish(x, tgt)`` polishes and certifies an
    existing iterate (the same polish, the damping restarted). It runs on the
card unless ``device`` names another."""

    def __init__(self, k: int, device=DEFAULT_DEVICE):
        self.k = k
        self.base = ChainSolver(build_ansatz(cycle_gates([gates.SQISWAP], k)).chain_gates, device)
        self.device = self.base.device
        self.n_params = self.base.n_params
        self.init_only = make_analytic_init(k, self.device)

    def _targets(self, tgt) -> torch.Tensor:
        return torch.as_tensor(tgt).to(device=self.device, dtype=torch.complex128).contiguous()

    def solve(self, tgt):
        tgt = self._targets(tgt)
        return self.repolish(self.init_only(tgt), tgt)

    __call__ = solve

    def repolish(self, x: torch.Tensor, tgt):
        tgt = self._targets(tgt)
        x = self.base.polish(x.to(self.device, torch.float64).contiguous(), tgt)
        return x, self.base.certify(x, tgt)


make_analytic_solver = AnalyticSolver  # the JAX package's name for the constructor
