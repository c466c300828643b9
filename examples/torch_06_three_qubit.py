"""Three qubits through the PyTorch port: the circulator Hamiltonian's
parameters solved for VSWAP, a fixed 3Q gate (CParitySwap) from CNOTs on a
line, and the entanglement-monotone costs (reference cost_function.py:
102-114 stubs; CirculatorSNAILGate custom_gates.py:95-138, VSwap :141).

    python examples/torch_06_three_qubit.py [--device cuda|cpu]

The CNOT search runs depths 6, 8, 10 with 8 restarts on the card, depth 6
with 4 on the CPU.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models import hamiltonians as ham
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates, hamiltonian_ansatz
from slam_decomposition_torch.opt import costs
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = ap.parse_args().device
small = dev == "cpu"

# 1. VSWAP (the circulator's native 3Q permutation) from the 7 physical
#    circulator-Hamiltonian parameters
ansatz = hamiltonian_ansatz(
    lambda p1, p2, p3, g1, g2, g3, t: ham.circulator_u(p1, p2, p3, g1, g2, g3, t=t),
    7,
    lower=np.array([-np.pi, -np.pi, -np.pi, 0, 0, 0, 0.5]),
    upper=np.array([np.pi, np.pi, np.pi, 1.5, 1.5, 1.5, 1.5]),
    n_qubits=3,
)
opt = TemplateOptimizer(ansatz, objective="square", training_restarts=12, override_fail=True, max_iters=300,
                        device=dev)
res = opt.approximate_target_U(gates.vswap().to_numpy())
print("circulator -> VSWAP loss:", float(res.loss[0]))

# 2. CParitySwap from 2Q CNOTs on a line, with explicit edge embedding
def builder(k):
    return build_ansatz(cycle_gates([gates.CNOT], k), edges=[[(0, 1), (1, 2), (0, 2)][i % 3] for i in range(k)],
                        n_qubits=3)


opt3 = TemplateOptimizer(builder, objective="square", spanning_range=[6] if small else [6, 8, 10],
                         training_restarts=4 if small else 8, override_fail=True, device=dev)
r3 = opt3.approximate_target_U(gates.CPARITY_SWAP.to_numpy())
print("CParitySwap from CNOTs: k =", int(r3.cycles[0]), "loss:", float(r3.loss[0]))

# 3. entanglement monotones on prep states, all differentiable
eye8 = torch.eye(8, dtype=torch.complex128, device=dev)
print("W-state monotones under identity:",
      {name: round(float(fn(eye8, state="w")), 4)
       for name, fn in (("MI", costs.mutual_information_cost), ("negativity", costs.negativity_cost),
                        ("EoE", costs.entropy_of_entanglement_cost))})
