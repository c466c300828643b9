"""Seeded inputs of the three chain kernels at the solver's shapes, shared by
the scripts that time or check them on the card (chip_smoke.py phase 3,
tools/time_iters.py), so that their readings are of the same data."""

from __future__ import annotations

import math

import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.samplers import haar_sample


def kernel_inputs(k: int, targets: int, restarts: int, dev) -> dict:
    """For the depth-k sqiSwap chain: ``g64`` / ``g32`` the gates, ``T``
    (targets, 4, 4) complex128 Haar targets (seed 1000 + k), ``lanes_t`` the
    targets in complex64 repeated per restart, ``x0`` (targets * restarts, n)
    f32 uniform in [0, 2 pi) (device generator, seed k) and ``sched`` the
    Adam schedule, all on ``dev``."""
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    g64 = torch.as_tensor(a.chain_gates).to(dev)
    T = torch.as_tensor(haar_sample(targets, seed=1000 + k)).to(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(k)
    x0 = torch.rand((targets * restarts, a.n_params), generator=gen, device=dev) * (2 * math.pi)
    return {
        "g64": g64,
        "g32": g64.to(torch.complex64),
        "T": T,
        "lanes_t": T.to(torch.complex64).repeat_interleave(restarts, 0).contiguous(),
        "x0": x0.contiguous(),
        "sched": ck.adam_schedule(device=dev),
    }


def best_restart(xl: torch.Tensor, fl: torch.Tensor, restarts: int) -> torch.Tensor:
    """(targets, n) f64: of the f32 LM's (targets * restarts, n) results, each
    target's restart of smallest ||r||^2: what the solver hands to the polish."""
    targets = fl.shape[0] // restarts
    best = torch.argmin(fl.view(targets, restarts), dim=1)
    return xl.view(targets, restarts, -1)[torch.arange(targets, device=xl.device), best].double().contiguous()
