"""Collect + consolidate 2Q blocks (JAX transpile/consolidate.py; the
Collect2qBlocks/ConsolidateBlocks role, sampler.py:44,
speed_limit_pass.py:131-137).

Greedy maximal runs: walk ops in order, merging consecutive ops whose qubit
support stays within one pair; each block collapses to a single 4x4 unitary
op. 1Q ops not adjacent to any 2Q interaction stay as-is (force_consolidate
merges them into neighboring blocks when possible).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import List, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.ops.weyl import c1c2c3
from slam_decomposition_torch.transpile.ir import Circuit, Op, embed


@dataclasses.dataclass
class Block:
    qubits: Tuple[int, int]
    ops: List[Op]
    positions: List[int] = dataclasses.field(default_factory=list)

    @property
    def unitary(self) -> np.ndarray:
        q0, q1 = self.qubits
        U = np.eye(4, dtype=complex)
        for op in self.ops:
            m = op.to_matrix()
            if op.n_qubits == 1:
                loc = (0,) if op.qubits[0] == q0 else (1,)
            else:
                loc = tuple(0 if q == q0 else 1 for q in op.qubits)
            U = embed(m, loc, 2) @ U
        return U


def collect_2q_blocks(circ: Circuit) -> Tuple[List[Block], List[Tuple[int, Op]]]:
    """Greedy block collection. Returns (blocks, leftovers) where leftovers
    are (position, op) 1Q ops that attached to no block."""
    open_blocks: dict = {}  # frozenset(qubits) -> Block
    qubit_block: dict = {}  # qubit -> Block or None
    blocks: List[Block] = []
    leftovers: List[Tuple[int, Op]] = []
    pending_1q: dict = {}  # qubit -> list of (pos, op) awaiting a block

    def close(b: Block):
        blocks.append(b)
        for q in b.qubits:
            if qubit_block.get(q) is b:
                qubit_block[q] = None

    for pos, op in enumerate(circ.ops):
        if op.n_qubits == 1:
            q = op.qubits[0]
            b = qubit_block.get(q)
            if b is not None:
                b.ops.append(op)
                b.positions.append(pos)
            else:
                pending_1q.setdefault(q, []).append((pos, op))
        elif op.n_qubits == 2:
            pair = tuple(sorted(op.qubits))
            b = qubit_block.get(op.qubits[0])
            b2 = qubit_block.get(op.qubits[1])
            if b is not None and b is b2 and tuple(sorted(b.qubits)) == pair:
                b.ops.append(op)
                b.positions.append(pos)
            else:
                closed_ids = set()
                for bb in (b, b2):
                    if bb is not None and id(bb) not in closed_ids:
                        closed_ids.add(id(bb))
                        close(bb)
                nb = Block(qubits=pair, ops=[])
                # absorb pending 1q ops on these qubits
                for q in pair:
                    for p0, p1 in pending_1q.pop(q, []):
                        nb.ops.append(p1)
                        nb.positions.append(p0)
                nb.ops.append(op)
                nb.positions.append(pos)
                qubit_block[pair[0]] = nb
                qubit_block[pair[1]] = nb
        else:
            raise ValueError("unroll 3q+ ops before consolidation")

    seen = set()
    for b in qubit_block.values():
        if b is not None and id(b) not in seen:
            seen.add(id(b))
            close(b)
    for q, lst in pending_1q.items():
        leftovers.extend(lst)
    return blocks, leftovers


def consolidate_2q_blocks(circ: Circuit) -> List[Block]:
    """force_consolidate=True behavior: every 2Q interaction becomes one
    consolidated block (leftover bare 1Q ops are dropped from the block
    list — they carry no 2Q content)."""
    blocks, _ = collect_2q_blocks(circ)
    return blocks


def block_coordinate_counts(circ: Circuit, decimals: int = 4, device=DEFAULT_DEVICE) -> dict:
    """Histogram of consolidated 2Q-block Weyl coordinates.

    The reference's "shot chart" study (scripts/shot_chart.ipynb): collect
    + consolidate every 2Q block of a (routed) benchmark circuit, map each
    block to its Weyl coordinate, and count occupancy per coordinate —
    e.g. the SWAP-class vs CNOT-class ratio that motivates speed-limit
    winner weighting. Coordinates are computed in ONE batched f64 c1c2c3 on
    ``device`` instead of the notebook's per-block weylchamber.c1c2c3 loop,
    and keyed rounded to ``decimals``. ``device`` is the card unless the
    caller names another.
    """
    device = resolve_device(device)
    blocks = consolidate_2q_blocks(circ)
    if not blocks:
        return {}
    mats = torch.as_tensor(np.stack([b.unitary for b in blocks]), device=device)
    coords = np.round(c1c2c3(mats).cpu().numpy(), decimals) + 0.0  # -0.0 -> 0.0
    return dict(Counter(tuple(float(x) for x in c) for c in coords))


def consolidated_circuit(circ: Circuit) -> Circuit:
    """Rebuild the circuit with each block as a single 'unitary2q' op,
    emitted at the position of the block's last op (ops on other qubits
    commute past the block, so the replay order is equivalent)."""
    blocks, leftovers = collect_2q_blocks(circ)
    events = [(pos, op, None) for pos, op in leftovers]
    for b in blocks:
        events.append((max(b.positions), None, b))
    events.sort(key=lambda e: e[0])
    out = Circuit(circ.n_qubits)
    for _, op, b in events:
        if b is not None:
            out.unitary(b.unitary, b.qubits, name="unitary2q")
        else:
            out.append(op)
    return out
