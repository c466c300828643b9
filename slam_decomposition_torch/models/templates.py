"""The plain 2Q u3-chain template (JAX models/templates.py:33-193, 288).

U(x) = L_k G_{k-1} ... L_1 G_0 L_0 with L_i = u3(x[6i:6i+3]) (x) u3(x[6i+3:6i+6])
and G_i the constant 2Q gates. ``x`` is laid out layer-major, qubit-major,
three angles per u3, exactly as in the JAX package, so parameter vectors
cross between the two packages unchanged.

Only the plain chain is ported: ``vz_only``, ``no_exterior_1q``,
``n_qubits > 2`` and custom edges raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import numpy as np
import torch

from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.ops import su2


def layer_1q(x6: torch.Tensor) -> torch.Tensor:
    """kron(u3(x6[...,0:3]), u3(x6[...,3:6])) -> (..., 4, 4) complex."""
    A = su2.u3(x6[..., 0], x6[..., 1], x6[..., 2])
    B = su2.u3(x6[..., 3], x6[..., 4], x6[..., 5])
    return torch.einsum("...ab,...cd->...acbd", A, B).reshape(*x6.shape[:-1], 4, 4)


def chain_unitary(x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """U(x) for x (..., 6(k+1)) real and gates (k, 4, 4) complex.

    The gates are cast to the complex dtype matching x (complex64 for f32),
    so an f32 phase stays f32 end to end."""
    k = gates.shape[0]
    cdt = torch.complex64 if x.dtype == torch.float32 else torch.complex128
    G = gates.to(dtype=cdt, device=x.device)
    U = layer_1q(x[..., 0:6])
    for i in range(k):
        U = G[i] @ U
        U = layer_1q(x[..., 6 * (i + 1) : 6 * (i + 2)]) @ U
    return U


@dataclasses.dataclass(frozen=True)
class Ansatz:
    """A built template of fixed depth k."""

    n_qubits: int
    k: int
    n_params: int
    eval_fn: Callable[[torch.Tensor], torch.Tensor]  # (..., n) -> (..., 4, 4)
    # (k, 4, 4) complex128 numpy constants of the 2Q gates: the kernels' input
    chain_gates: np.ndarray


def build_ansatz(
    gate_seq: Sequence[Gate],
    edges=None,
    n_qubits: int = 2,
    no_exterior_1q: bool = False,
    vz_only: bool = False,
) -> Ansatz:
    """Template over a fixed 2Q gate sequence: an initial u3 layer, then per
    cycle the 2Q gate followed by a u3 layer on both qubits."""
    k = len(gate_seq)
    if n_qubits != 2 or vz_only or no_exterior_1q:
        raise NotImplementedError(
            "only the plain 2Q u3-chain template is ported "
            "(n_qubits=2, vz_only=False, no_exterior_1q=False)"
        )
    if edges is not None and any(tuple(e) != (0, 1) for e in edges):
        raise NotImplementedError("only the (0, 1) edge exists on 2 qubits")
    if k < 1:
        raise NotImplementedError("the chain needs at least one 2Q gate")
    chain_gates = np.stack([g.to_numpy() for g in gate_seq])
    gates_t = torch.as_tensor(chain_gates)

    def eval_fn(x):
        return chain_unitary(x, gates_t)

    return Ansatz(
        n_qubits=2,
        k=k,
        n_params=6 * (k + 1),
        eval_fn=eval_fn,
        chain_gates=chain_gates,
    )


def cycle_gates(base_gates: Sequence[Gate], k: int) -> List[Gate]:
    """itertools.cycle over the base gates, k of them."""
    return [base_gates[i % len(base_gates)] for i in range(k)]
