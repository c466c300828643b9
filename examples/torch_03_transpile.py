"""Speed-limit-aware transpilation of a benchmark circuit through the
PyTorch port: the basic analytic flow, the parallel-drive identities and
winner substitution on QFT-8.

    python examples/torch_03_transpile.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam_decomposition_torch.transpile import library
from slam_decomposition_torch.transpile.passes import (
    pass_manager_basic, pass_manager_optimized_sqiswap, pass_manager_slam)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

qc = library.qft(8)
_, basic = pass_manager_basic(qc, gate="sqiswap", duration_1q=0.25, device=dev)
_, opt_ = pass_manager_optimized_sqiswap(qc, duration_1q=0.25, device=dev)
print(f"QFT-8 duration: basic {basic['duration']:.2f} -> "
      f"parallel-drive {opt_['duration']:.2f}")
_, slam = pass_manager_slam(qc, strategy="weighted_overall",
                            speed_method="linear", duration_1q=0.25, device=dev)
print(f"slam weighted_overall: {slam['duration']:.2f}")
