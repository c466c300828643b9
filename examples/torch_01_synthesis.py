"""Batched variational synthesis through the PyTorch port: the reference's
four-object idiom (reference README.md:33-52) on a whole target
distribution at once, the chain kernels on the card.

    python examples/torch_01_synthesis.py [--device cuda|cpu]

64 Haar targets on the card, 16 on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_sample

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
B = 64 if dev != "cpu" else 16

optimizer = TemplateOptimizer(lambda k: build_ansatz(cycle_gates([gates.SQISWAP], k)), objective="square",
                              spanning_range=[2, 3], training_restarts=6, override_fail=True, device=dev)
res = optimizer.approximate_from_distribution(haar_sample(B, seed=0))
print("k counts:", np.bincount(res.cycles), "worst loss:", res.loss.max())
