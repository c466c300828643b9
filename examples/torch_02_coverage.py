"""Monodromy coverage through the PyTorch port: how many sqiSwap
applications reach which targets, and the Haar volumes of the layers.

    python examples/torch_02_coverage.py [--device cuda|cpu]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_range_from_target
from slam_decomposition_torch.coverage.haar import expected_cost, normalized_volume
from slam_decomposition_torch.models import gates

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

cov = gate_set_to_coverage(gates.cg_sqiswap(), device=dev)
for name, g in [("CNOT", gates.CNOT), ("SWAP", gates.SWAP), ("B", gates.berkeley())]:
    k, _ = monodromy_range_from_target(cov, g.to_numpy(), device=dev)
    print(f"k({name}) = {k}")
print("P2 Haar volume:", normalized_volume(cov[2].polytope))
print("E[Haar] cost:", expected_cost(cov))
