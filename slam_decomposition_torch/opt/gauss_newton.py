"""Chain solvers (JAX opt/gauss_newton.py:220-675, phase residual only).

The multi-start solver: Adam warm start, f32 LM ranking, f64 LM polish.

``make_solver(chain_gates)`` builds a ``ChainSolver`` whose ``solve``
takes x0s (B, R, n) and targets (B, 4, 4) and returns the polished best
restart per target with its certified square cost:

1. Adam (``ADAM_ITERS`` steps, f32) on every restart (``ops.chain_kernels.adam_chain``);
2. ``LM32_ITERS`` f32 LM iterations on every restart, which also return
   ||r||^2 = 8 - 2|tr|, monotone in the square cost, to rank restarts
   (``lm_chain``);
3. ``LM_ITERS`` LM iterations in f64 from the best restart (``polish_chain``),
   whose final accepted f = ||r||^2 gives the certificate
   cost = 0.2 f - f^2/80 (exact for unitary pairs; JAX gauss_newton.py:543-548).

On CUDA tensors the three steps are the hand-written kernels; on CPU
tensors their plain PyTorch versions.

``make_analytic_solver(k, device)`` replaces steps 1-2 by one batched
analytic synthesis (ops/kak_batch.make_analytic_init) and keeps the polish.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.convert import chain_gates_from_numpy
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.ops.kak_batch import make_analytic_init


def certificate(f: torch.Tensor) -> torch.Tensor:
    """Square cost 1 - (|tr|^2 + 4)/20 from f = ||r||^2 = 8 - 2|tr|."""
    return 0.2 * f - f * f / 80.0


class ChainSolver:
    """The solver of one chain depth k on one device (the card by default)."""

    def __init__(self, chain_gates: np.ndarray, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.gates64 = chain_gates_from_numpy(chain_gates, self.device)
        self.gates32 = self.gates64.to(torch.complex64)
        self.k = self.gates64.shape[0]
        self.n_params = 6 * (self.k + 1)
        self.sched = ck.adam_schedule(device=self.device)

    def solve(self, x0s: torch.Tensor, tgt: torch.Tensor):
        """x0s (B, R, n) f64, tgt (B, 4, 4) complex128 -> (x (B, n) f64,
        certified square cost (B,) f64) of the best restart per target."""
        B, R, n = x0s.shape
        t32 = tgt.to(torch.complex64).repeat_interleave(R, dim=0).contiguous()
        xs = ck.adam_chain(x0s.reshape(B * R, n).float().contiguous(), t32, self.gates32, self.sched)
        xs, fs = ck.lm_chain(xs, t32, self.gates32)
        best = torch.argmin(fs.view(B, R), dim=1)
        xb = xs.view(B, R, n)[torch.arange(B, device=xs.device), best]
        return self.polish_cert(xb.double().contiguous(), tgt)

    __call__ = solve

    def polish(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """f64 LM only, from an already good x (B, n) -> (B, n)."""
        return ck.polish_chain(x, tgt.contiguous(), self.gates64)[0]

    def polish_cert(self, x: torch.Tensor, tgt: torch.Tensor):
        """polish + certified losses from the final accepted residual."""
        xs, f = ck.polish_chain(x, tgt.contiguous(), self.gates64)
        return xs, certificate(f)

    def certify(self, x: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """The true f64 square cost of x against tgt."""
        return ck.square_cost(x, tgt, self.gates64)


make_solver = ChainSolver  # the JAX package's name for the constructor


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
