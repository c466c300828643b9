"""The basic analytic decomposition pass manager and its analysis passes
(JAX transpile/passes.py:79-144, 251-278, 889-950; reference
speed_limit_pass.py:36-101, 531-551).

Passes operate on consolidated 2Q blocks. ``pass_manager_basic`` with
``batched=True`` synthesizes every sqiSwap block of a k-class in one device
call (transpile/batch_synth.py); otherwise each block goes through the
exact host routine.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch
from slam_decomposition_torch.transpile.consolidate import collect_2q_blocks, consolidate_2q_blocks
from slam_decomposition_torch.transpile.cx_decompose import cx_decompose_to_circuit
from slam_decomposition_torch.transpile.ir import Circuit, unroll_3q_or_more
from slam_decomposition_torch.transpile.kak import sqiswap_decompose

BATCH_MIN_BLOCKS = 64  # batched=None batches sqiSwap circuits from this many blocks


def duration_analysis(circ: Circuit, duration_1q: float = 0.0) -> Dict:
    """Critical-path duration + gate counts. Per-op durations: explicit op
    duration, else duration_1q for 1Q ops, else 1 (fooAnalysis,
    speed_limit_pass.py:36-101; this computes the true duration-weighted
    critical path rather than the reference's op-count longest path, whose
    mismatch the reference itself flags at :44)."""
    finish = [0.0] * circ.n_qubits
    counts: Dict[str, int] = {}
    # reference-metric DP: longest path by NODE COUNT through the per-qubit
    # dependency DAG, then sum of durations along that path (ties broken
    # toward larger duration for determinism)
    plen = [0] * circ.n_qubits  # longest node-count path ending at qubit q
    pdur = [0.0] * circ.n_qubits
    for op in circ.ops:
        if op.duration is not None:
            d = op.duration
        elif op.n_qubits == 1:
            d = duration_1q
        else:
            d = 1.0
        start = max(finish[q] for q in op.qubits)
        for q in op.qubits:
            finish[q] = start + d
        best = max((plen[q], pdur[q]) for q in op.qubits)
        for q in op.qubits:
            plen[q] = best[0] + 1
            pdur[q] = best[1] + d
        counts[op.name] = counts.get(op.name, 0) + 1
    return {
        "duration": max(finish) if finish else 0.0,
        # the reference's property_set["duration"]: durations summed along
        # dag.longest_path(), the node-count-longest path, NOT the true
        # duration-critical path (its own FIXME, speed_limit_pass.py:44)
        "duration_ref_metric": (max(zip(plen, pdur))[1] if circ.n_qubits else 0.0),
        "gate_counts": counts,
        "depth": circ.depth(),
    }


def _blocks_to_circuit(circ: Circuit, substitutions: Dict[int, Circuit]) -> Circuit:
    """Rebuild a circuit replacing block i with its substitution circuit
    (qubit indices inside substitutions are block-local 0/1)."""
    blocks, leftovers = collect_2q_blocks(circ)
    events = [(pos, op, None) for pos, op in leftovers]
    for i, b in enumerate(blocks):
        events.append((max(b.positions), i, b))
    events.sort(key=lambda e: e[0])
    out = Circuit(circ.n_qubits)
    for _, tag, b in events:
        if b is None:
            out.append(tag)
            continue
        sub = substitutions.get(tag)
        if sub is None:
            out.unitary(b.unitary, b.qubits, name="unitary2q")
            continue
        for op in sub.ops:
            mapped = tuple(b.qubits[q] for q in op.qubits)
            out.append(dataclasses.replace(op, qubits=mapped))
    return out


def optimize_1q_gates(circ: Circuit) -> Circuit:
    """Merge consecutive 1Q ops on the same qubit into one op (the
    Optimize1qGates role, speed_limit_pass.py:492/526/549: without it the
    substitution passes double-count 1Q layer durations). Matrices multiply
    when available; parameter placeholders merge by replacement."""
    out = Circuit(circ.n_qubits)
    last_1q: Dict[int, int] = {}  # qubit -> index in out.ops
    for op in circ.ops:
        if op.n_qubits == 1:
            q = op.qubits[0]
            prev = last_1q.get(q)
            if prev is not None:
                pop = out.ops[prev]
                try:
                    m = op.to_matrix() @ pop.to_matrix()
                    out.ops[prev] = dataclasses.replace(pop, name="u1q", params=(), matrix=m)
                except KeyError:
                    out.ops[prev] = op
                continue
            out.append(op)
            last_1q[q] = len(out.ops) - 1
        else:
            for q in op.qubits:
                last_1q.pop(q, None)
            out.append(op)
    return out


def pass_manager_basic(
    circ: Circuit,
    gate: str = "sqiswap",
    duration_1q: float = 0.0,
    batched: Optional[bool] = None,
    device=DEFAULT_DEVICE,
    stats: Optional[dict] = None,
) -> Tuple[Circuit, Dict]:
    """Analytic decomposition baseline (pass_manager_basic,
    speed_limit_pass.py:531-551): unroll, consolidate into 2Q blocks,
    synthesize each block into sqiSwap (``gate="sqiswap"``) or CX, merge 1Q
    runs, and return (circuit, duration_analysis).

    ``batched`` selects the batched sqiSwap synthesis on ``device``
    (transpile/batch_synth.py). None = batch when the gate is sqiSwap, the
    circuit has at least BATCH_MIN_BLOCKS blocks and ``device`` is CUDA.
    ``stats`` (if given) receives the batched call's block counts and,
    under "results", its (steps, n) per block. ``device`` is the card unless
    the caller names another."""
    if gate not in ("sqiswap", "cx"):
        raise ValueError(gate)
    device = resolve_device(device)
    circ = unroll_3q_or_more(circ)
    blocks = consolidate_2q_blocks(circ)
    if batched is None:
        batched = gate == "sqiswap" and len(blocks) >= BATCH_MIN_BLOCKS and device.type == "cuda"
    if gate == "sqiswap" and batched and blocks:
        Us = np.stack([b.unitary for b in blocks])
        results = sqiswap_decompose_batch(Us, stats=stats, device=device)
        if stats is not None:
            stats["results"] = results
        step_lists = [steps for steps, _ in results]
    elif gate == "sqiswap":
        step_lists = [sqiswap_decompose(b.unitary)[0] for b in blocks]
    subs: Dict[int, Circuit] = {}
    for i, b in enumerate(blocks):
        if gate == "cx":
            subs[i] = cx_decompose_to_circuit(b.unitary, duration_1q)
            continue
        sub = Circuit(2)
        for kind, payload in step_lists[i]:
            if kind == "sqiswap":
                sub.append("riswap", (0, 1), params=(0.5,), duration=0.5)
            elif kind == "1q":
                sub.unitary(payload[0], (0,), name="u1q", duration=duration_1q)
                sub.unitary(payload[1], (1,), name="u1q", duration=duration_1q)
        subs[i] = sub
    out = optimize_1q_gates(_blocks_to_circuit(circ, subs))
    return out, duration_analysis(out, duration_1q)
