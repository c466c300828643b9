"""Seeded inputs of the three chain kernels at the solver's shapes, shared by
the scripts that time or check them on the card (chip_smoke.py phase 3,
tools/time_iters.py), so that their readings are of the same data; and the
f32 spread of the plain Adam that the deep chains' parity checks allow."""

from __future__ import annotations

import math

import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, chain_unitary, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.samplers import haar_sample


def kernel_inputs(k: int, targets: int, restarts: int, dev, gate=None) -> dict:
    """For the depth-k chain of ``gate`` (default sqiSwap): ``g64`` / ``g32`` the gates, ``T``
    (targets, 4, 4) complex128 Haar targets (seed 1000 + k; at depth 1, which
    reaches no Haar target, the chain at uniform parameters from a device
    generator of seed 1000 + k), ``lanes_t`` the
    targets in complex64 repeated per restart, ``x0`` (targets * restarts, n)
    f32 uniform in [0, 2 pi) (device generator, seed k) and ``sched`` the
    Adam schedule, all on ``dev``."""
    a = build_ansatz(cycle_gates([gates.SQISWAP if gate is None else gate], k))
    g64 = torch.as_tensor(a.chain_gates).to(dev)
    if k == 1:
        tgen = torch.Generator(device=dev)
        tgen.manual_seed(1000 + k)
        xt = torch.rand((targets, a.n_params), generator=tgen, device=dev, dtype=torch.float64) * (2 * math.pi)
        T = chain_unitary(xt, g64).contiguous()
    else:
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


def adam_ulp_spread(x0: torch.Tensor, tgt: torch.Tensor, gates: torch.Tensor, sched: torch.Tensor,
                    ref: torch.Tensor | None = None) -> torch.Tensor:
    """(L,) per lane, how far the plain f32 Adam's result moves when its
    start moves by one f32 ulp (each entry of x0 to its next float up, then
    down): the part of the result that f32 rounding leaves undetermined.
    Adam's m / sqrt(v) normalises gradient components that sit near zero, so
    on deep chains (n ~ 300) a few lanes in ten amplify rounding past the
    25-step parity bound (PERF.md section 6); there two f32 programs that
    sum in different orders can agree no better than this. ``ref``: the
    plain result from x0, where the caller has it."""
    ref = ck.adam_chain_ref(x0, tgt, gates, sched) if ref is None else ref
    return torch.maximum(*(
        (ck.adam_chain_ref(torch.nextafter(x0, torch.full_like(x0, bound)), tgt, gates, sched) - ref).abs().amax(1)
        for bound in (math.inf, -math.inf)
    ))
