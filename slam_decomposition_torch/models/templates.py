"""Variational circuit templates as parameter -> unitary evaluators (JAX
models/templates.py:33-321).

A template is a closed-form chain U(x) = L_k G_k ... L_1 G_1 L_0 of 1Q
layers L_i (u3 on every qubit, or rz only) and 2Q gates G_i, constant
(``build_ansatz``) or parameterized (``build_ansatz_v2``);
``hamiltonian_ansatz`` optimizes a propagator's own parameters. ``eval_fn``
takes x (..., n_params) and returns (..., d, d) complex: it is batched by
shape, over any leading dimensions.

Layout of x, the JAX package's, so parameter vectors cross between the two
packages unchanged:
    [ all 1Q-layer params (layer-major, qubit-major, 3 per u3 / 1 per rz) |
      all 2Q-gate params (cycle-major) ]

The plain 2Q u3 chain (``n_qubits=2``, u3 layers, exterior layers, edge
(0, 1)) also carries ``chain_gates``, the constants the three CUDA kernels
take; it evaluates through ``chain_unitary``, the kernels' plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from slam_decomposition_torch.models.gates import Gate
from slam_decomposition_torch.ops import su2


def _complex_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.complex64 if x.dtype == torch.float32 else torch.complex128


def _kron(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    a, b = A.shape[-1], B.shape[-1]
    return torch.einsum("...ab,...cd->...acbd", A, B).reshape(*A.shape[:-2], a * b, a * b)


def layer_1q(x6: torch.Tensor) -> torch.Tensor:
    """kron(u3(x6[...,0:3]), u3(x6[...,3:6])) -> (..., 4, 4) complex."""
    A = su2.u3(x6[..., 0], x6[..., 1], x6[..., 2])
    B = su2.u3(x6[..., 3], x6[..., 4], x6[..., 5])
    return _kron(A, B)


def chain_unitary(x: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """U(x) for x (..., 6(k+1)) real and gates (k, 4, 4) complex.

    The gates are cast to the complex dtype matching x (complex64 for f32),
    so an f32 phase stays f32 end to end."""
    k = gates.shape[0]
    G = gates.to(dtype=_complex_dtype(x), device=x.device)
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
    n_params_1q: int
    eval_fn: Callable[[torch.Tensor], torch.Tensor]  # (..., n) -> (..., 2^q, 2^q)
    lower: np.ndarray  # (n_params,) sampling / bound box
    upper: np.ndarray
    use_bounds: bool = False
    # circuit cost of the instantiated 2Q gates from x; None means the
    # constant ``fixed_cost``
    cost_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    fixed_cost: float = 0.0
    # (k, 4, 4) complex128 numpy constants of the 2Q gates when the template
    # is the plain 2Q u3 chain the CUDA kernels take; None otherwise
    chain_gates: Optional[np.ndarray] = None
    # eval_fn holds a driven propagator (an expm of its parameters)
    driven: bool = False

    def circuit_cost(self, x):
        if self.cost_fn is None:
            return self.fixed_cost
        return self.cost_fn(torch.as_tensor(x))


def _embed_2q(U4: np.ndarray, edge: Tuple[int, int], n_qubits: int) -> np.ndarray:
    """A 4x4 gate on ``edge`` embedded into 2^n x 2^n (big-endian order).
    Host numpy, used only when a template is built."""
    if n_qubits == 2 and tuple(edge) == (0, 1):
        return U4
    dim = 2**n_qubits
    full = np.zeros((dim, dim), dtype=complex)
    others = [q for q in range(n_qubits) if q not in edge]
    for i in range(dim):
        bits_i = [(i >> (n_qubits - 1 - q)) & 1 for q in range(n_qubits)]
        for j in range(dim):
            bits_j = [(j >> (n_qubits - 1 - q)) & 1 for q in range(n_qubits)]
            if any(bits_i[q] != bits_j[q] for q in others):
                continue
            a = (bits_i[edge[0]] << 1) | bits_i[edge[1]]
            b = (bits_j[edge[0]] << 1) | bits_j[edge[1]]
            full[i, j] = U4[a, b]
    return full


def _layer_1q(params: torch.Tensor, n_qubits: int, vz_only: bool) -> torch.Tensor:
    """Tensor product of the per-qubit 1Q gates of one layer's (..., per *
    n_qubits) parameters."""
    per = 1 if vz_only else 3
    out = None
    for q in range(n_qubits):
        p = params[..., q * per : (q + 1) * per]
        m = su2.rz(p[..., 0]) if vz_only else su2.u3(p[..., 0], p[..., 1], p[..., 2])
        out = m if out is None else _kron(out, m)
    return out


def _layers(n_qubits, k, no_exterior_1q, vz_only):
    layer_p = (1 if vz_only else 3) * n_qubits
    n_layers = (k + 1) if not no_exterior_1q else max(k - 1, 0)
    return layer_p, n_layers * layer_p


def _chain_eval(x, gate_at, k, n_qubits, layer_p, no_exterior_1q, vz_only):
    """The chain over 1Q layers read from x and 2Q gates gate_at(i), each
    (d, d) or (..., d, d)."""
    if no_exterior_1q:
        U = gate_at(0)
        U = U.expand(*x.shape[:-1], *U.shape[-2:])
        for i in range(1, k):
            U = _layer_1q(x[..., (i - 1) * layer_p : i * layer_p], n_qubits, vz_only) @ U
            U = gate_at(i) @ U
        return U
    U = _layer_1q(x[..., :layer_p], n_qubits, vz_only)
    for i in range(k):
        U = gate_at(i) @ U
        U = _layer_1q(x[..., (i + 1) * layer_p : (i + 2) * layer_p], n_qubits, vz_only) @ U
    return U


def build_ansatz(
    gate_seq: Sequence[Gate],
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    n_qubits: int = 2,
    no_exterior_1q: bool = False,
    vz_only: bool = False,
) -> Ansatz:
    """Template over a fixed (possibly mixed-order) 2Q gate sequence: an
    initial 1Q layer (unless ``no_exterior_1q``), then per cycle the 2Q gate
    on its edge followed by a 1Q layer on all qubits (the final layer
    dropped with ``no_exterior_1q``). ``vz_only`` makes the layers rz."""
    k = len(gate_seq)
    if edges is None:
        edges = [(0, 1)] * k
    layer_p, n_1q = _layers(n_qubits, k, no_exterior_1q, vz_only)
    plain = (
        n_qubits == 2 and not vz_only and not no_exterior_1q
        and all(tuple(e) == (0, 1) for e in edges) and k > 0
    )
    if no_exterior_1q and k < 1:
        raise ValueError("a template without exterior layers needs at least one 2Q gate")
    chain_gates = np.stack([g.to_numpy() for g in gate_seq]) if plain else None
    d = 2**n_qubits
    Gs = torch.as_tensor(
        np.stack([_embed_2q(g.to_numpy(), e, n_qubits) for g, e in zip(gate_seq, edges)]).reshape(k, d, d)
    )

    def eval_fn(x):
        # the constants follow the parameter dtype, so an f32 phase stays f32
        if plain:
            return chain_unitary(x, Gs)
        G = Gs.to(dtype=_complex_dtype(x), device=x.device)
        return _chain_eval(x, lambda i: G[i], k, n_qubits, layer_p, no_exterior_1q, vz_only)

    return Ansatz(
        n_qubits=n_qubits,
        k=k,
        n_params=n_1q,
        n_params_1q=n_1q,
        eval_fn=eval_fn,
        lower=np.full(n_1q, 0.0),
        upper=np.full(n_1q, 2 * np.pi),
        fixed_cost=float(sum(g.cost() for g in gate_seq)),
        chain_gates=chain_gates,
    )


def build_ansatz_v2(
    gate_fn: Callable[..., torch.Tensor],
    n_gate_params: int,
    k: int,
    n_qubits: int = 2,
    edges: Optional[Sequence[Tuple[int, int]]] = None,
    no_exterior_1q: bool = False,
    vz_only: bool = False,
    gate_cost_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    gate_bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    dtype=torch.float64,
) -> Ansatz:
    """Template with parameterized 2Q gates. ``gate_fn(q, dtype=dtype)``
    takes one cycle's parameters q (..., n_gate_params), batched like x, and
    returns the (..., 4, 4) complex gate; ``gate_cost_fn(q)`` its cost (for
    the optimizer's cost ceiling); ``gate_bounds`` = (lower, upper) of one
    cycle's gate parameters, which turns the box into bounds. x is
    evaluated in ``dtype`` whatever its own."""
    if edges is None:
        edges = [(0, 1)] * k
    if n_qubits != 2 or any(tuple(e) != (0, 1) for e in edges):
        raise NotImplementedError("parameterized gates on more than 2 qubits need an explicit embedding")
    layer_p, n_1q = _layers(n_qubits, k, no_exterior_1q, vz_only)
    n_total = n_1q + k * n_gate_params

    def gate_params(x, i):
        return x[..., n_1q + i * n_gate_params : n_1q + (i + 1) * n_gate_params]

    def eval_fn(x):
        x = x.to(dtype)
        return _chain_eval(
            x, lambda i: gate_fn(gate_params(x, i), dtype=dtype), k, n_qubits, layer_p, no_exterior_1q, vz_only
        )

    # default box (-4 pi, 4 pi)
    lower = np.full(n_total, -4 * np.pi)
    upper = np.full(n_total, 4 * np.pi)
    if gate_bounds is not None:
        for i in range(k):
            lower[n_1q + i * n_gate_params : n_1q + (i + 1) * n_gate_params] = gate_bounds[0]
            upper[n_1q + i * n_gate_params : n_1q + (i + 1) * n_gate_params] = gate_bounds[1]

    cost_fn = None
    if gate_cost_fn is not None:

        def cost_fn(x):
            x = x.to(dtype)
            return sum(gate_cost_fn(gate_params(x, i)) for i in range(k))

    return Ansatz(
        n_qubits=n_qubits,
        k=k,
        n_params=n_total,
        n_params_1q=n_1q,
        eval_fn=eval_fn,
        lower=lower,
        upper=upper,
        use_bounds=gate_bounds is not None,
        cost_fn=cost_fn,
    )


def cycle_gates(base_gates: Sequence[Gate], k: int) -> List[Gate]:
    """itertools.cycle over the base gates, k of them."""
    return [base_gates[i % len(base_gates)] for i in range(k)]


def hamiltonian_ansatz(
    u_fn: Callable[..., torch.Tensor],
    n_params: int,
    lower=None,
    upper=None,
    n_qubits: int = 2,
) -> Ansatz:
    """Optimize a propagator's own parameters: eval(x) = u_fn(x[..., 0], ...,
    x[..., n-1]), each argument batched like x."""
    lower = np.zeros(n_params) if lower is None else np.asarray(lower)
    upper = np.ones(n_params) if upper is None else np.asarray(upper)

    def eval_fn(x):
        return u_fn(*[x[..., i] for i in range(n_params)])

    return Ansatz(
        n_qubits=n_qubits,
        k=1,
        n_params=n_params,
        n_params_1q=0,
        eval_fn=eval_fn,
        lower=lower,
        upper=upper,
        driven=True,
    )
