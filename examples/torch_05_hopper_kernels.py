"""The three hand-written Hopper kernels of the solve, called directly
(ops/chain_kernels.py; sources in slam_decomposition_torch/csrc/), each
against its plain PyTorch version on the same inputs.

    python examples/torch_05_hopper_kernels.py [--device cuda|cpu]

On the card the wrappers build the kernels with nvcc at first use (~30 s)
and launch them on 40960 lanes; on the CPU (256 lanes) they run their plain
versions, so both columns come from the same code there.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from slam_decomposition_torch.config import resolve_device
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import certificate
from slam_decomposition_torch.opt.samplers import haar_sample

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = resolve_device(ap.parse_args().device)
L = 40960 if dev.type == "cuda" else 256

a = build_ansatz(cycle_gates([gates.SQISWAP], 2))
g64 = torch.as_tensor(a.chain_gates).to(dev)
g32 = g64.to(torch.complex64)
T = torch.as_tensor(haar_sample(L, seed=3)).to(dev)
T32 = T.to(torch.complex64)
x0 = torch.as_tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, (L, a.n_params)), dtype=torch.float32).to(dev)
sched = ck.adam_schedule(100, device=dev)


def median_cost(x):
    return ck.square_cost(x.double(), T, g64).median().item()


print(f"{L} lanes of the k = 2 sqiSwap chain on {dev}"
      f"{' (' + torch.cuda.get_device_name(dev) + ')' if dev.type == 'cuda' else ': the plain versions'}")
# 1. Adam warm start, 100 steps in f32
xa = ck.adam_chain(x0, T32, g32, sched)
xa_ref = ck.adam_chain_ref(x0, T32, g32, sched)
print(f"after Adam:   median cost {median_cost(xa):.2e} (plain {median_cost(xa_ref):.2e})")
# 2. the f32 LM ranking pass, 8 iterations
xl, fl = ck.lm_chain(xa, T32, g32, 8)
_, fl_ref = ck.lm_chain_ref(xa, T32, g32, 8)
print(f"after LM:     median cost {median_cost(xl):.2e}; ||r||^2 within 1e-3 of the plain version on "
      f"{torch.isclose(fl, fl_ref, rtol=1e-3, atol=1e-5).float().mean().item():.1%} of lanes")
# 3. the f64 polish, 6 iterations, certified from its final residual
x64 = xl.double().contiguous()
xp, fp = ck.polish_chain(x64, T, g64, 6)
_, fp_ref = ck.polish_chain_ref(x64, T, g64, 6)
c, c_ref = certificate(fp), certificate(fp_ref)
ok = c <= 1e-10
print(f"after polish: {ok.float().mean().item():.1%} certified at <= 1e-10 (plain {(c_ref <= 1e-10).float().mean().item():.1%}); "
      f"certificate - true f64 cost <= {(c - ck.square_cost(xp, T, g64))[ok].abs().max().item():.1e}")
print("launches:", ck.launch_counts())
assert ((c <= 1e-10) == (c_ref <= 1e-10)).float().mean().item() >= 0.99
