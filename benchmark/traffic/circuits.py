"""The consolidated 2-qubit blocks of named benchmark circuits: the
generator of the `circuits` traffic mixes, one batch a circuit.

A transpile pass (the port's `transpile/passes.py` `speed_gate_substitute`,
through `MixedOrderBasisTemplate.ks_for_batch`) collects a circuit's
2-qubit blocks and assigns all of them their depth in one call, so a batch
here is one circuit's blocks. The mix's ``target_params`` give
``circuits``, a list of {"family", "qubits"}; the pool holds one batch for
each, in that order, the i-th circuit's random draws seeded from the pool's
seed and i.

Frozen copies, in NumPy on the host:

- of the port's `transpile/library.py` `qv` (Quantum Volume: q layers of
  Haar 4x4s on a random pairing, with `opt/samplers.py` `haar_sample`) and
  `qft` (H and controlled phases pi / 2^(j-i), then the final swaps): two
  circuits of the paper's benchmark suite (`circuit_suite.py` of
  github.com/Pitt-JonesLab/slam_decomposition), unrouted;
- of `transpile/consolidate.py` `collect_2q_blocks`: greedy maximal runs of
  gates on one pair, 1-qubit gates taken into the open block on their
  qubit or else into the next block there, a block closed by a 2-qubit gate
  on another pair over either of its qubits.

`benchmark/tests/test_perfbench_copies.py` holds them equal to the
originals.
"""

from __future__ import annotations

import numpy as np
import torch

_H = np.array([[1, 1], [1, -1]], dtype=complex) / np.sqrt(2)
_I2 = np.eye(2, dtype=complex)
_SWAP = np.eye(4, dtype=complex)[[0, 2, 1, 3]]


def _cp(theta: float) -> np.ndarray:
    return np.diag([1, 1, 1, np.exp(1j * theta)]).astype(complex)


def haar_sample(n: int, seed: int) -> np.ndarray:
    """(n, 4, 4) Haar-random U(4): QR of complex Ginibre, R's diagonal phases moved into Q."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))) / np.sqrt(2)
    q, r = np.linalg.qr(z)
    diag = np.einsum("...ii->...i", r)
    return q * (diag / np.abs(diag))[:, None, :]


def qv(q: int, seed: int) -> list:
    """Quantum Volume as (matrix, qubits) gates."""
    rng = np.random.default_rng(seed)
    gates = []
    for _ in range(q):
        perm = rng.permutation(q)
        us = haar_sample(q // 2, int(rng.integers(0, 2**31)))
        gates += [(us[i], (int(perm[2 * i]), int(perm[2 * i + 1]))) for i in range(q // 2)]
    return gates


def qft(q: int, seed: int) -> list:
    """The QFT with controlled phases and the final swaps as (matrix, qubits) gates (``seed`` unused)."""
    gates = []
    for i in range(q):
        gates.append((_H, (i,)))
        gates += [(_cp(np.pi / (2 ** (j - i))), (j, i)) for j in range(i + 1, q)]
    gates += [(_SWAP, (i, q - 1 - i)) for i in range(q // 2)]
    return gates


FAMILIES = {"qv": qv, "qft": qft}


def _on_pair(m: np.ndarray, qubits: tuple, pair: tuple) -> np.ndarray:
    """A gate on ``qubits`` as a 4x4 on ``pair`` (its first qubit the high bit)."""
    if len(qubits) == 1:
        return np.kron(m, _I2) if qubits[0] == pair[0] else np.kron(_I2, m)
    return m if qubits[0] == pair[0] else _SWAP @ m @ _SWAP


def block_unitaries(gates: list) -> list:
    """Each block's 4x4 unitary, in the order in which the blocks close."""
    on_qubit, pending, closed = {}, {}, []

    def close(b):
        closed.append(b)
        for q in b["pair"]:
            if on_qubit.get(q) is b:
                on_qubit[q] = None

    for m, qubits in gates:
        if len(qubits) == 1:
            b = on_qubit.get(qubits[0])
            (b["gates"] if b is not None else pending.setdefault(qubits[0], [])).append((m, qubits))
            continue
        pair = tuple(sorted(qubits))
        b, b2 = on_qubit.get(qubits[0]), on_qubit.get(qubits[1])
        if b is not None and b is b2 and b["pair"] == pair:
            b["gates"].append((m, qubits))
            continue
        for i, bb in enumerate((b, b2)):
            if bb is not None and not (i == 1 and bb is b):
                close(bb)
        nb = {"pair": pair, "gates": pending.pop(pair[0], []) + pending.pop(pair[1], []) + [(m, qubits)]}
        on_qubit[pair[0]] = on_qubit[pair[1]] = nb
    seen = set()
    for b in on_qubit.values():
        if b is not None and id(b) not in seen:
            seen.add(id(b))
            close(b)
    out = []
    for b in closed:
        u = np.eye(4, dtype=complex)
        for m, qubits in b["gates"]:
            u = _on_pair(m, qubits, b["pair"]) @ u
        out.append(u)
    return out


def batches(seed: int, device, circuits: list) -> tuple:
    """((n, 4, 4) complex128 blocks of every circuit on ``device``, each circuit's block count)."""
    parts = []
    for i, c in enumerate(circuits):
        s = int(np.random.SeedSequence([seed, i]).generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))
        parts.append(np.stack(block_unitaries(FAMILIES[c["family"]](c["qubits"], s))))
    return torch.as_tensor(np.concatenate(parts)).to(device), [len(p) for p in parts]
