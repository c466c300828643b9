"""Cost functions, 0 = perfect, on batched complex tensors (JAX
opt/costs.py, every entry of ``COSTS`` and ``COSTS_3Q`` under the same
name). ``U`` and ``V`` are (..., d, d) complex and broadcast against each
other; a cost is (...) real. All are differentiable by autograd; the costs
through Weyl coordinates take the out-of-place joint diagonalization when
an operand requires grad (ops/eig.joint_diag).
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.ops import weyl
from slam_decomposition_torch.ops.eig import eig_unitary, eigh_hermitian

TINY = 1e-300  # keeps sqrt differentiable at 0


def _tr_overlap(U: torch.Tensor, V: torch.Tensor):
    """tr(V^dag U) and the dimension d."""
    return (V.conj() * U).sum(dim=(-2, -1)), U.shape[-1]


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return z.real * z.real + z.imag * z.imag


def basic_cost(U, V):
    """1 - |tr(V^dag U)| / d."""
    tr, d = _tr_overlap(U, V)
    return 1.0 - torch.sqrt(_abs2(tr) + TINY) / d


def basic_cost_inverse(U, V):
    """|tr(V^dag U)| / d, without the 1 -."""
    tr, d = _tr_overlap(U, V)
    return torch.sqrt(_abs2(tr) + TINY) / d


def square_cost(U, V):
    """1 - (|tr|^2 + d) / (d (d + 1)): the average-gate-infidelity form,
    smooth at the optimum."""
    tr, d = _tr_overlap(U, V)
    return 1.0 - (_abs2(tr) + d) / (d * (d + 1.0))


def weyl_euclidean_cost(U, V):
    """||c(U) - c(V)||_2 in Weyl coordinates."""
    d = weyl.c1c2c3(U) - weyl.c1c2c3(V)
    return torch.sqrt((d * d).sum(-1) + TINY)


def makhlin_euclidean_cost(U, V):
    """||g(U) - g(V)||_2 over the Makhlin invariants (traces only)."""
    d = weyl.g1g2g3(U) - weyl.g1g2g3(V)
    return torch.sqrt((d * d).sum(-1) + TINY)


def makhlin_functional_cost(U, V):
    """Squared Makhlin distance: the smooth local-invariant functional."""
    d = weyl.g1g2g3(U) - weyl.g1g2g3(V)
    return (d * d).sum(-1)


def _canonical_pair(U, V):
    return weyl.canonical_gate(weyl.c1c2c3(U)), weyl.canonical_gate(weyl.c1c2c3(V))


def basic_reduced_cost(U, V):
    """basic_cost between the canonical gates of both operands."""
    return basic_cost(*_canonical_pair(U, V))


def square_reduced_cost(U, V):
    """square_cost between the canonical gates of both operands."""
    return square_cost(*_canonical_pair(U, V))


def square_reduced_bell_cost(U, V):
    """square_cost in the Bell (magic) basis. Conjugation by a fixed unitary
    leaves |tr| unchanged, so this equals square_cost; kept for the name."""
    return square_cost(weyl.to_magic(U), weyl.to_magic(V))


def line_segment_distance(U, seg_a, seg_b):
    """Distance from c(U) to the line through seg_a and seg_b in Weyl space
    (unclamped, as the reference has it)."""
    c = weyl.c1c2c3(U)
    a = torch.as_tensor(seg_a, dtype=c.dtype, device=c.device)
    b = torch.as_tensor(seg_b, dtype=c.dtype, device=c.device)
    d = b - a
    cr = torch.linalg.cross(d.expand(c.shape), a - c, dim=-1)
    return torch.sqrt((cr * cr).sum(-1) + TINY) / torch.sqrt((d * d).sum())


def b_to_sqswap_segment():
    """The B <-> sqrt(SWAP) segment."""
    return np.array([0.5, 0.25, 0.0]), np.array([0.75, 0.25, 0.25])


def unitary_power(U: torch.Tensor, s) -> torch.Tensor:
    """Fractional power U^s = V diag(e^{i s theta}) V^dag through the joint
    Jacobi unitary eigendecomposition (ops/eig.eig_unitary)."""
    theta, V = eig_unitary(U)
    ph = torch.polar(torch.ones_like(theta), s * theta)
    return (V * ph[..., None, :]) @ V.conj().transpose(-2, -1)


def continuous_cost(U, V, timesteps: int = 2):
    """Fit the whole evolution, not just its end: the sum of basic_cost over
    the fractional powers U^s against V^s at s = j / timesteps."""
    total = 0.0
    for j in range(1, timesteps + 1):
        s = j / timesteps
        total = total + basic_cost(unitary_power(U, s), unitary_power(V, s))
    return total


# ------------------------------------------------------------- 3Q monotones
# Costs of U |prep> for the 3Q W / GHZ states; U is (..., 8, 8).


def _prep_state(state: str, like: torch.Tensor) -> torch.Tensor:
    v = np.zeros(8)
    if state == "w":
        v[0b100] = v[0b010] = v[0b001] = 1 / np.sqrt(3)
    else:
        v[0] = v[7] = 1 / np.sqrt(2)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _rho_of(U: torch.Tensor, state: str) -> torch.Tensor:
    """Density matrix (..., 8, 8) of U |prep>."""
    psi = (U * _prep_state(state, U)).sum(-1)
    return psi[..., :, None] * psi.conj()[..., None, :]


def _six(rho: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) -> (..., 2, 2, 2, 2, 2, 2): bra qubits, then ket qubits."""
    return rho.reshape(*rho.shape[:-2], 2, 2, 2, 2, 2, 2)


def _partial_trace_single(rho: torch.Tensor, q: int) -> torch.Tensor:
    """Trace qubit q out of a 3Q state, keeping the other two: (..., 4, 4)."""
    t = torch.diagonal(_six(rho), dim1=q - 6, dim2=q - 3).sum(-1)
    return t.reshape(*rho.shape[:-2], 4, 4)


def _reduced_1q(rho: torch.Tensor, q: int) -> torch.Tensor:
    """The state of qubit q alone: (..., 2, 2)."""
    a, b = [o for o in range(3) if o != q]
    letters = "abc"
    bra = "".join(letters[o] if o != q else "x" for o in range(3))
    ket = "".join(letters[o] if o != q else "y" for o in range(3))
    del a, b
    return torch.einsum(f"...{bra}{ket}->...xy", _six(rho))


def _partial_transpose(rho: torch.Tensor, q: int) -> torch.Tensor:
    """Swap qubit q's bra and ket indices of a 3Q density matrix."""
    return _six(rho).transpose(q - 6, q - 3).reshape(rho.shape)


def _entropy(rho: torch.Tensor) -> torch.Tensor:
    w, _ = eigh_hermitian(rho)
    w = torch.clamp(w, 1e-12, 1.0)
    return -(w * torch.log2(w)).sum(-1)


def mutual_information_cost(U: torch.Tensor, state: str = "w", square: bool = False):
    """Sum of the bipartite mutual informations of U |prep> over the three
    pairs of qubits; minimizing it undoes the prepared state's entanglement."""
    rho = _rho_of(U, state)
    total = 0.0
    for q in range(3):
        rho2 = _partial_trace_single(rho, q)
        r4 = rho2.reshape(*rho2.shape[:-2], 2, 2, 2, 2)
        rhoA = torch.einsum("...abcb->...ac", r4)
        rhoB = torch.einsum("...abad->...bd", r4)
        mi = _entropy(rhoA) + _entropy(rhoB) - _entropy(rho2)
        total = total + (mi * mi if square else mi)
    return total


def negativity_cost(U: torch.Tensor, state: str = "w"):
    """Sum over the three 1|2 cuts of the negativity
    N = (||rho^{T_q}||_1 - 1) / 2 of U |prep>: zero iff the state is a
    product across every cut."""
    rho = _rho_of(U, state)
    total = 0.0
    for q in range(3):
        w, _ = eigh_hermitian(_partial_transpose(rho, q))
        total = total + (w.abs().sum(-1) - 1.0) / 2.0
    return total


def entropy_of_entanglement_cost(U: torch.Tensor, state: str = "w"):
    """Sum over the three 1|2 cuts of the entropy of entanglement S(rho_q)."""
    rho = _rho_of(U, state)
    return sum(_entropy(_reduced_1q(rho, q)) for q in range(3))


_YY = np.array([[0, 0, 0, -1], [0, 0, 1, 0], [0, 1, 0, 0], [-1, 0, 0, 0]], dtype=float)


def _concurrence_2q(rho2: torch.Tensor) -> torch.Tensor:
    """Wootters concurrence of a 2Q mixed state with Hermitian algebra only:
    lambda_i = sqrt(eig(sqrt(rho) rho~ sqrt(rho))), rho~ = (Y Y) rho* (Y Y);
    C = max(0, l1 - l2 - l3 - l4)."""
    yy = torch.as_tensor(_YY, dtype=rho2.dtype, device=rho2.device)
    rho_t = yy @ rho2.conj() @ yy
    w, V = eigh_hermitian(rho2)
    s = torch.sqrt(torch.clamp(w, min=0.0)).to(V.dtype)
    sqrt_rho = (V * s[..., None, :]) @ V.conj().transpose(-2, -1)
    lam2, _ = eigh_hermitian(sqrt_rho @ rho_t @ sqrt_rho)
    lam = torch.sqrt(torch.clamp(lam2, min=0.0))  # ascending
    return torch.clamp(lam[..., 3] - lam[..., 2] - lam[..., 1] - lam[..., 0], min=0.0)


def _binary_entropy(x: torch.Tensor) -> torch.Tensor:
    x = torch.clamp(x, 1e-12, 1 - 1e-12)
    return -x * torch.log2(x) - (1 - x) * torch.log2(1 - x)


def entanglement_of_formation_cost(U: torch.Tensor, state: str = "w"):
    """Sum of the pairwise entanglement of formation over the three 2Q
    reduced states of U |prep> (Wootters: h((1 + sqrt(1 - C^2)) / 2)). It
    vanishes on GHZ, whose entanglement is tripartite: use the W state."""
    rho = _rho_of(U, state)
    total = 0.0
    for q in range(3):
        C = _concurrence_2q(_partial_trace_single(rho, q))
        total = total + _binary_entropy((1 + torch.sqrt(1 - C * C)) / 2) * (C > 1e-12)
    return total


COSTS = {
    "basic": basic_cost,
    "basic_inverse": basic_cost_inverse,
    "square": square_cost,
    "weyl_euclidean": weyl_euclidean_cost,
    "makhlin_euclidean": makhlin_euclidean_cost,
    "makhlin_functional": makhlin_functional_cost,
    "basic_reduced": basic_reduced_cost,
    "square_reduced": square_reduced_cost,
    "square_reduced_bell": square_reduced_bell_cost,
}

COSTS_3Q = {
    "mutual_information": mutual_information_cost,
    "mutual_information_square": lambda U, state="w": mutual_information_cost(U, state, square=True),
    "negativity": negativity_cost,
    "entanglement_of_formation": entanglement_of_formation_cost,
    "entropy_of_entanglement": entropy_of_entanglement_cost,
}
