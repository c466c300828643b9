"""The full pipeline through the PyTorch port, at doc scale: Haar targets ->
exact monodromy ranges -> k-bucketed multi-start synthesis (make_solver: the
three chain kernels on the card) -> f64 certificates, with the k = 3
rescue. ``pipeline.decompose_haar`` is the same flow at B = 100000.

    python examples/torch_08_full_pipeline.py [--device cuda|cpu]

64 targets on the card, 16 on the CPU.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from slam_decomposition_torch.config import resolve_device
from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt.gauss_newton import make_solver
from slam_decomposition_torch.opt.samplers import haar_sample

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)
B, R, THRESH = (64 if dev.type == "cuda" else 16), 4, 1e-10

# 1. exact coverage ranges for the whole batch in one device call
coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=dev)
T = torch.as_tensor(haar_sample(B, seed=7)).to(dev)
ks = np.maximum(monodromy_ks_batch(coverage, T, dev), 2)
print("k histogram:", {int(k): int(c) for k, c in zip(*np.unique(ks, return_counts=True))})

# 2. per k bucket: one multi-start solve (Adam warm start, f32 LM ranking,
# f64 polish; the chain kernels on the card)
gen = torch.Generator(device=dev)
gen.manual_seed(0)


def solver(k):
    a = build_ansatz(cycle_gates([gates.SQISWAP], k))
    return make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=dev)


def x0(n, s):
    return torch.rand((n, R, s.n_params), generator=gen, device=dev, dtype=torch.float64) * (2 * math.pi)


losses = np.empty(B)
for k in sorted(set(ks.tolist())):
    idx = np.where(ks == k)[0]
    s = solver(int(k))
    _, bf = s.solve(x0(len(idx), s), T[torch.as_tensor(idx, device=dev)])
    losses[idx] = bf.cpu().numpy()
    print(f"k={k}: {len(idx)} targets on the {s.path} path, worst loss {losses[idx].max():.2e}")

# 3. rescue: unconverged targets re-solve at k=3 with fresh starts (every 2Q
# target is k <= 3 in sqiSwap)
s3 = solver(3)
for _ in range(3):
    stuck = np.where(~(losses <= THRESH))[0]
    if len(stuck) == 0:
        break
    _, bf = s3.solve(x0(len(stuck), s3), T[torch.as_tensor(stuck, device=dev)])
    losses[stuck] = np.fmin(losses[stuck], bf.cpu().numpy())
    print(f"rescue: {len(stuck)} re-solved at k=3")

n_ok = int((losses <= THRESH).sum())
print(f"certified {n_ok}/{B} below {THRESH}, worst loss {losses.max():.2e}")
assert n_ok == B
