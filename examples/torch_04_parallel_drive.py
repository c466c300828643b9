"""Parallel-drive pulses through the PyTorch port: a trajectory through the
Weyl chamber, a solved parallel-driven CX, and SWAP from two driven iSwap
pulses (the JAX package's solved instance).

    python examples/torch_04_parallel_drive.py [--device cuda|cpu]

The CX solve draws 32 restarts on the card, 8 on the CPU.
"""
import argparse
import json
import os
import pathlib
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from slam_decomposition_torch.models.gates import SWAP
from slam_decomposition_torch.models.trajectory import evaluate_drive_sequence, improved_cx, smush_trajectory

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device

traj = smush_trajectory(0, 0, np.pi / 2, 0, [0.3, -0.2, 0.5, 0.1], [0.1, 0.4, -0.3, 0.2], device=dev)
print("trajectory through the chamber:\n", np.round(traj, 3))
params, loss, (A1, B1, A2, B2) = improved_cx(restarts=32 if dev != "cpu" else 8, device=dev)
print(f"solved parallel-driven CX pulse (1 application + exact 1Q locals), certified loss: {loss:.2e}")
assert loss < 1e-10

# SWAP from TWO driven full-iSwap-time pulses, the JAX package's solved
# instance (read in place)
art = json.loads((pathlib.Path(__file__).resolve().parents[1] /
                  "slam_decomposition_tpu/data/improved_swap_2pulse.json").read_text())
locs = [np.array([[complex(re, im) for re, im in row] for row in L]) for L in art["locals"]]
U = evaluate_drive_sequence(art["params"], art["plan"], art["gc"], art["gg"], art["n_slices"], locs, device=dev)
infid = 1.0 - abs(np.trace(SWAP.to_numpy().conj().T @ U)) / 4.0
print(f"SWAP via 2 driven iSwap pulses: infidelity {infid:.2e}")
assert infid < 1e-10
