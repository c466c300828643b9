"""Optimal-control pulse shaping through the PyTorch port: drive a weak
coupling into the perfect-entangler polytope with GRAPE (the reference's
krotov smush_OCT study), then the populations along the pulse.

    python examples/torch_07_optimal_control.py [--device cuda|cpu]

8 restarts x 250 iterations on the card, 4 x 150 on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from slam_decomposition_torch.explore.oct import is_perfect_entangler, make_smush_eval, optimize_pulses, pe_functional
from slam_decomposition_torch.models.hamiltonians import evolve_smush, populations

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
small = dev == "cpu"

N = 16
ev = make_smush_eval(gc=7 * np.pi / 8, gg=0.0, n_slices=N, device=dev)
zero = torch.zeros((2, N), dtype=torch.float64, device=ev.device)
print(f"undriven riswap(1.75)-class: F_PE = {float(pe_functional(ev(zero))):.3f} (> 0, not a PE)")

res = optimize_pulses(ev, N, functional="pe", restarts=4 if small else 8, iters=150 if small else 250, lr=0.2,
                      seed=1)
print(f"after pulse shaping:    F_PE = {float(res.value):.2e} "
      f"(perfect entangler: {bool(is_perfect_entangler(res.U, tol=1e-3))})")
pulses = torch.as_tensor(res.pulses)
print("gx pulse:", np.round(pulses[0].cpu().numpy(), 2))
print("gy pulse:", np.round(pulses[1].cpu().numpy(), 2))

# population dynamics along the optimized pulse (the hamiltonian_sim
# notebook's mesolve role)
psi0 = torch.zeros(4, dtype=torch.complex128, device=ev.device)
psi0[1] = 1.0
pops = populations(evolve_smush(0.0, 0.0, 7 * np.pi / 8, 0.0, pulses[0].to(ev.device), pulses[1].to(ev.device),
                                psi0))
print("pop(|01>) along pulse:", np.round(pops[:, 1].cpu().numpy(), 3))
assert bool(is_perfect_entangler(res.U, tol=1e-6))
