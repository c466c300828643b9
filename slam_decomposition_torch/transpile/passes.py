"""Speed-limit-aware transpilation passes and their pass managers (JAX
transpile/passes.py; reference speed_limit_pass.py): duration analysis, the
basic analytic decomposition, winner substitution (``pass_manager_slam``)
and the parallel-drive identities (``pass_manager_optimized_sqiswap``).

Passes operate on consolidated 2Q blocks. ``pass_manager_basic`` with
``batched=True`` synthesizes every sqiSwap block of a k-class in one device
call (transpile/batch_synth.py); otherwise each block goes through the
exact host routine. The substitution passes assign every block's
application count in one batched call. With ``fit_1q=True`` the winner
pass fits the 1Q layers of every substituted block of one 2Q structure in
one multi-start solve (``fit_substituted_1q``: the chain kernels on the
card), and the parallel-drive pass fits each block's driven pulses and
layers (``fit_substituted_pd``: the general solver by pulse count, its
fallback on the chain kernels).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.coverage.mixed import MixedOrderBasisTemplate
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch
from slam_decomposition_torch.transpile.consolidate import collect_2q_blocks, consolidate_2q_blocks
from slam_decomposition_torch.transpile.cx_decompose import cx_decompose_to_circuit
from slam_decomposition_torch.transpile.ir import Circuit, unroll_3q_or_more
from slam_decomposition_torch.transpile.kak import sqiswap_decompose

logger = logging.getLogger(__name__)

BATCH_MIN_BLOCKS = 64  # batched=None batches sqiSwap circuits from this many blocks

# family-classification tolerance of the parallel-drive pass's Weyl
# coordinates: a block within 1e-6 of a named family is treated as that
# family, at an infidelity ~(1e-6)^2
_CLASS_TOL = 1e-6

_TEMPLATE_CACHE: Dict[Tuple[str, str], MixedOrderBasisTemplate] = {}


def _c1c2c3_batch(us: np.ndarray, device) -> np.ndarray:
    """Weyl coordinates of a (N, 4, 4) block stack, one batched call on
    ``device``."""
    from slam_decomposition_torch.coverage.coverage import weyl_coords_float

    return weyl_coords_float(np.asarray(us), device)


def _cached_template(key: str, device: torch.device, factory) -> MixedOrderBasisTemplate:
    """A template built once per process and device."""
    if (key, str(device)) not in _TEMPLATE_CACHE:
        _TEMPLATE_CACHE[(key, str(device))] = factory()
    return _TEMPLATE_CACHE[(key, str(device))]


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


# ---------------------------------------------------- winner substitution


def _random_1q_layer(sub: Circuit, rng, duration_1q):
    """A u3 placeholder on each qubit (the reference's random 1Q layers)."""
    for q in (0, 1):
        sub.append("u", (q,), params=tuple(rng.uniform(0, 2 * np.pi, 3)), duration=duration_1q)


def fit_substituted_1q(
    blocks,
    subs: Dict[int, Circuit],
    duration_1q: float = 0.0,
    threshold: float = 1e-10,
    restarts: int = 8,
    seed: int = 0,
    device=DEFAULT_DEVICE,
    stats: Optional[list] = None,
) -> Dict[int, Circuit]:
    """Replace the 1Q placeholders of substitution circuits with fitted u3
    layers, so that each substituted block's unitary equals its block's up
    to global phase.

    The substitutions are grouped by their sequence of 2Q matrices; each
    group is one template (``build_ansatz`` over ``custom_cost_gate``\\ s)
    and one multi-start solve of all its blocks from ``restarts`` uniform
    starts a block (drawn from ``np.random.default_rng(seed)`` in the JAX
    package's order of groups and draws) through ``make_solver`` on
    ``device`` (the card unless the caller names another): a chain of depth
    1..79 takes the three chain kernels, one launch of each a group, a
    deeper one the general solver. A block whose certified cost stays above
    ``threshold`` keeps its placeholders and is logged. Substitutions with
    no 2Q matrix (empty, or family-extension duration dummies) are returned
    unchanged. ``stats`` (a list, if given) receives a dict per group:
    applications, blocks, fitted, worst cost, solver path, seconds and the
    fitted circuits by block index."""
    from slam_decomposition_torch.models.templates import build_ansatz
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    device = resolve_device(device)
    groups: Dict[Tuple, List[int]] = {}
    seqs: Dict[int, List] = {}
    for i, sub in subs.items():
        two_q = [op for op in sub.ops if op.n_qubits == 2]
        if not two_q or any(op.matrix is None for op in two_q):
            continue
        groups.setdefault(tuple((op.name, op.matrix.tobytes()) for op in two_q), []).append(i)
        seqs[i] = two_q
    out = dict(subs)
    rng = np.random.default_rng(seed)
    layer_p = 6  # 2 qubits x u3
    for key, idxs in groups.items():
        t0 = time.perf_counter()
        two_q = seqs[idxs[0]]
        gate_seq = [G.custom_cost_gate(op.matrix, name=op.name, duration=op.duration or 1.0) for op in two_q]
        ansatz = build_ansatz(gate_seq)
        B = len(idxs)
        solver = make_solver(ansatz.eval_fn, ansatz.n_params, chain_gates=ansatz.chain_gates, device=device)
        tgts = torch.as_tensor(np.stack([blocks[i].unitary for i in idxs])).to(device=device, dtype=torch.complex128)
        x0s = torch.as_tensor(rng.uniform(0, 2 * np.pi, (B, restarts, ansatz.n_params))).to(device)
        xs, fs = solver.solve(x0s, tgts)
        xs, fs = xs.cpu().numpy(), fs.cpu().numpy()
        bad = fs > threshold
        if bad.any():
            logger.warning("fit_substituted_1q: %d/%d blocks above threshold (worst %.2e); placeholders kept there",
                           int(bad.sum()), B, fs.max())
        fitted: Dict[int, Circuit] = {}
        for j, i in enumerate(idxs):
            if bad[j]:
                continue
            new = fitted[i] = Circuit(2)
            for layer in range(len(gate_seq) + 1):
                p = xs[j, layer * layer_p : (layer + 1) * layer_p]
                for q in (0, 1):
                    new.append("u", (q,), params=tuple(p[q * 3 : (q + 1) * 3]), duration=duration_1q)
                if layer < len(gate_seq):
                    op = two_q[layer]
                    new.append(op.name, (0, 1), matrix=op.matrix, duration=op.duration)
        out.update(fitted)
        logger.info("fit_substituted_1q: fitted %d blocks (structure %s, worst loss %.2e)", int((~bad).sum()),
                    [n for n, _ in key], fs.max())
        if stats is not None:
            stats.append({"applications": len(two_q), "blocks": B, "fitted": int((~bad).sum()),
                          "worst": float(fs.max()), "path": solver.path, "seconds": time.perf_counter() - t0,
                          "circuits": fitted})
    return out


def speed_gate_substitute(
    circ: Circuit,
    strategy: str = "basic_overall",
    speed_method: str = "linear",
    duration_1q: float = 0.0,
    basic_metric: int = 0,
    lambda_weight: float = 0.47,
    family_extension: bool = False,
    coupling_edges: Optional[List[Tuple[int, int]]] = None,
    seed: int = 0,
    fit_1q: bool = False,
    device=DEFAULT_DEVICE,
    stats: Optional[list] = None,
) -> Circuit:
    """SpeedGateSubstitute (speed_limit_pass.py:104-314): pick winner
    gate(s) from the candidate database and replace every 2Q block with the
    winner template at its monodromy range (one batched k assignment on
    ``device`` per winner), 1Q layers as random placeholders unless
    ``fit_1q`` (``fit_substituted_1q``, whose per-group ``stats`` it
    passes on)."""
    from slam_decomposition_torch.explore.candidates import get_group_name
    from slam_decomposition_torch.explore.family import recursive_sibling_check
    from slam_decomposition_torch.explore.winners import pick_winner

    device = resolve_device(device)
    circ = unroll_3q_or_more(circ)
    blocks = consolidate_2q_blocks(circ)
    group = get_group_name(speed_method, duration_1q)
    rng = np.random.default_rng(seed)
    smush = "smush" in strategy
    # one matrix a gate object, not one a block; the entry holds the gate,
    # so that its id cannot pass to a later winner's gate
    gate_np: Dict[int, Tuple[G.Gate, np.ndarray]] = {}

    def substitute_with(template, scaled_gate, target, k):
        if family_extension:
            base = template.base_gates[0]
            _, cost = recursive_sibling_check(template.coverage, base, target, cost_1q=duration_1q,
                                              basis_factor=scaled_gate.duration, use_smush=smush, device=device)
            sub = Circuit(2)
            # a dummy op carrying the family-extended duration
            sub.unitary(target, (0, 1), name="dummy", duration=max(cost - 2 * duration_1q, 0.0))
            return sub
        if id(scaled_gate) not in gate_np:
            gate_np[id(scaled_gate)] = (scaled_gate, scaled_gate.to_numpy())
        matrix = gate_np[id(scaled_gate)][1]
        sub = Circuit(2)
        _random_1q_layer(sub, rng, duration_1q)
        for _ in range(k):
            sub.append("winner2q", (0, 1), matrix=matrix, duration=scaled_gate.duration)
            _random_1q_layer(sub, rng, duration_1q)
        return sub

    def substitute_all(idxs, metric, target_ops=None, use_smush=False):
        winner, scaled = pick_winner(group, metric=metric, target_ops=target_ops, smush=use_smush,
                                     family_extension=family_extension, device=device)
        template = MixedOrderBasisTemplate([winner], smush=use_smush, device=device)
        ks = (None if family_extension or not idxs
              else template.ks_for_batch(np.stack([blocks[i].unitary for i in idxs])))
        for j, i in enumerate(idxs):
            subs[i] = substitute_with(template, scaled, blocks[i].unitary, None if ks is None else int(ks[j]))

    subs: Dict[int, Circuit] = {}
    if strategy in ("basic_overall", "lambda_weight", "basic_smush", "lambda_smush"):
        metric = basic_metric if "basic" in strategy else (-1, lambda_weight)
        substitute_all(list(range(len(blocks))), metric, use_smush=smush)
    elif strategy == "weighted_overall":
        substitute_all(list(range(len(blocks))), -1, target_ops=[b.unitary for b in blocks])
    elif strategy == "weighted_pairwise":
        edges = coupling_edges or sorted({tuple(sorted(b.qubits)) for b in blocks})
        for edge in edges:
            idxs = [i for i, b in enumerate(blocks) if tuple(sorted(b.qubits)) == tuple(edge)]
            if idxs:
                substitute_all(idxs, -1, target_ops=[blocks[i].unitary for i in idxs])
    else:
        raise ValueError(f"unknown strategy {strategy}")

    if fit_1q:
        subs = fit_substituted_1q(blocks, subs, duration_1q=duration_1q, device=device, stats=stats)
    return _blocks_to_circuit(circ, subs)


# ------------------------------------------------ parallel-drive identities


def _emit_u_layer(c: Circuit, p, duration_1q):
    """A "u" op of 3 angles on each qubit from the 6 angles p."""
    for q in (0, 1):
        c.append("u", (q,), params=tuple(p[q * 3 : (q + 1) * 3]), duration=duration_1q)


def _block_infidelities(Vs: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """1 - |tr(V^dag U)| / 4 of each (V, U) pair."""
    return 1.0 - np.abs(np.einsum("nij,nij->n", Vs.conj(), targets)) / 4.0


def pd_core(m: int, gc: float = np.pi / 2, n_slices: int = 4):
    """(core_fn, n_core) of the driven core of ``fit_substituted_pd``'s
    m-pulse group: core_fn(x) evaluates pulse(t_1) [u3 layer, pulse(t_j)]*
    as (..., 4, 4). Layout: [t_1..t_m, then per pulse phi_c, phi_g,
    gx[n_slices], gy[n_slices], then the (m - 1) interior u3 layers of 6
    angles]. The pulse times are frozen: detached, so that gradients and
    Jacobian columns of their slots are zero, and each lane's pulses run at
    its own times."""
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models.trajectory import _layer

    per_pulse = 2 + 2 * n_slices
    n_core = m + m * per_pulse + max(m - 1, 0) * 6

    def core_fn(x):
        ts = x[..., :m].detach()

        def pulse(j):
            pp = x[..., m + j * per_pulse : m + (j + 1) * per_pulse]
            return ham.smush_u(pp[..., 0], pp[..., 1], gc, 0.0, pp[..., 2 : 2 + n_slices], pp[..., 2 + n_slices :],
                               t=ts[..., j])

        U = pulse(0)
        for j in range(1, m):
            lo = m + m * per_pulse + (j - 1) * 6
            U = pulse(j) @ (_layer(x[..., lo : lo + 6], U) @ U)
        return U

    return core_fn, n_core


def fit_substituted_pd(
    blocks,
    subs: Dict[int, Circuit],
    plans: Dict[int, List[float]],
    duration_1q: float = 0.0,
    gc: float = np.pi / 2,
    n_slices: int = 4,
    threshold: float = 1e-9,
    restarts: int = 16,
    seed: int = 0,
    device=DEFAULT_DEVICE,
    stats: Optional[list] = None,
) -> Dict[int, Circuit]:
    """Fidelity-faithful parallel-drive substitution (JAX passes.py:411-759):
    for each block, the smush pulses of its plan (piecewise-constant 1Q
    drives riding the iSwap-strength coupler, models/trajectory.py) and the
    u3 layers around them, fitted so that the substitution equals the
    block's unitary up to global phase.

    ``plans[i]`` lists the pulse times (in iSwap units) that
    ``optimized_sqiswap_sub`` claimed for block i.

    - A one-pulse block whose zero-drive pulse already has the block's
      class (an iSwap-class block) takes no optimizer: its four locals
      follow from two KAK forms (all zero pulses are one batched call).
    - The others are fitted by pulse count m, one group at a time: a
      Makhlin class fit of the drive core (the pulse times ride in frozen
      parameter slots, detached from the gradients), the outer locals by
      KAK sandwich of every fitted core, two f64 LM polishes of core and
      locals together, and for lanes still above ``threshold`` a direct
      full-parameter solve from fresh starts with the polished point as
      restart 0, the better of the two kept. Every solve of this stage
      takes the general path.
    - Blocks still above ``threshold`` fall back to three zero-drive
      sqiSwap-time pulses with four u3 layers: a plain depth-3 chain, so
      the chain kernels solve it on the card. Blocks above ``threshold``
      after that keep their placeholders and are logged.

    Starts come from ``np.random.default_rng(seed)`` in the JAX package's
    order (each group's starts in sorted m, its rescue's where it has
    failures, the fallback's last). ``device`` is the card unless the
    caller names another. ``stats`` (a list, if given) receives a record
    per stage: "exact", one "class_fit" per m, and "fallback", each with
    its blocks, the blocks it fitted, its solver path and seconds, and the
    fitted circuits by block index."""
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models.gates import _const_gate
    from slam_decomposition_torch.models.templates import build_ansatz
    from slam_decomposition_torch.models.trajectory import _locals_angles, _with_locals
    from slam_decomposition_torch.opt import costs
    from slam_decomposition_torch.opt.gauss_newton import make_solver
    from slam_decomposition_torch.transpile.kak import kak_form

    device = resolve_device(device)
    out = dict(subs)
    rng = np.random.default_rng(seed)
    per_pulse = 2 + 2 * n_slices

    def pulses(pp: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """(N, 4, 4) smush pulses of parameters pp (N, per_pulse), each at
        its own duration ts (N,): one batched call on ``device``."""
        x = torch.as_tensor(pp, dtype=torch.float64, device=device)
        t = torch.as_tensor(ts, dtype=torch.float64, device=device)
        return ham.smush_u(x[:, 0], x[:, 1], gc, 0.0, x[:, 2 : 2 + n_slices], x[:, 2 + n_slices :], t=t).cpu().numpy()

    def zero_pulses(ts) -> np.ndarray:
        """The zero-drive pulse of each duration in ts: one batched call."""
        return pulses(np.zeros((len(ts), per_pulse)), np.asarray(ts, dtype=float))

    def record(stage, **kw):
        if stats is not None:
            stats.append({"stage": stage, **kw})

    block_forms: Dict[bytes, object] = {}

    def block_form(i):
        """The block's KAK form, once per distinct unitary (QFT-64's 2048
        blocks hold 65)."""
        key = blocks[i].unitary.tobytes()
        if key not in block_forms:
            block_forms[key] = kak_form(blocks[i].unitary)
        return block_forms[key]

    def sandwich(bf, pf):
        """Outer locals (A1, B1, A2, B2) with (A2 x B2) P (A1 x B1) equal to
        the block, from the block's and the pulse's KAK forms."""
        return (pf.l2.conj().T @ bf.l2, pf.r2.conj().T @ bf.r2, bf.l1 @ pf.l1.conj().T, bf.r1 @ pf.r1.conj().T)

    def durations_2q(i):
        return [op.duration for op in subs[i].ops if op.n_qubits == 2]

    # --- the exact path: a single zero-drive pulse whose class equals the
    # block's. The duration is re-derived from the block's f64 class where
    # 2 t[0] of its KAK form lies within 1e-5 of the plan, as the JAX package
    # does, and the classes are certified against each other at 1e-12. The
    # zero pulse of duration t is in the iSwap family, KAK coordinates
    # (pi t / 4, pi t / 4, 0), so in practice the iSwap-class blocks match;
    # controlled-family blocks, (a, 0, 0), never do and take the class fit
    t0_clock = time.perf_counter()
    single = [i for i in plans if len(plans[i]) == 1]
    t_pulse = {}
    for i in single:
        t_exact = 2.0 * float(block_form(i).t[0])
        t_pulse[i] = t_exact if abs(t_exact - plans[i][0]) < 1e-5 else plans[i][0]
    P0s = dict(zip(single, zero_pulses([t_pulse[i] for i in single]))) if single else {}
    pulse_forms: Dict[float, object] = {}
    exact: Dict[int, Circuit] = {}
    groups: Dict[int, List[int]] = {}
    for i in plans:
        if i in P0s:
            bf, P0 = block_form(i), P0s[i]
            key = round(float(t_pulse[i]), 12)
            if key not in pulse_forms:
                pulse_forms[key] = kak_form(P0)
            pf = pulse_forms[key]
            if np.abs(bf.t - pf.t).max() < 1e-12:
                A1, B1, A2, B2 = sandwich(bf, pf)
                old = durations_2q(i)
                c = Circuit(2)
                c.unitary(A1, (0,), name="u1q", duration=duration_1q)
                c.unitary(B1, (1,), name="u1q", duration=duration_1q)
                c.append("pd_pulse", (0, 1), matrix=P0, duration=old[0] if old else None)
                c.unitary(A2, (0,), name="u1q", duration=duration_1q)
                c.unitary(B2, (1,), name="u1q", duration=duration_1q)
                exact[i] = c
                continue
        groups.setdefault(len(plans[i]), []).append(i)
    out.update(exact)
    record("exact", blocks=len(exact), fitted=len(exact), indices=sorted(exact), path="none",
           seconds=time.perf_counter() - t0_clock, circuits=exact)

    fallback: List[int] = []
    for m, idxs in sorted(groups.items()):
        if m == 0:
            continue
        clock = time.perf_counter()
        seconds = {}
        # --- stage 1: class fit of the drive core (Makhlin residual, no
        # outer layers), all blocks with m pulses at once
        core_fn, n_core = pd_core(m, gc, n_slices)
        B = len(idxs)
        targets = np.stack([blocks[i].unitary for i in idxs])
        tgts = torch.as_tensor(targets, dtype=torch.complex128, device=device)
        solver = make_solver(core_fn, n_core, adam_iters=400, lm32_iters=16, lm_iters=16, residual="makhlin",
                             final_cost_fn=costs.makhlin_functional_cost, device=device)
        x0 = rng.uniform(-2 * np.pi, 2 * np.pi, (B, restarts, n_core))
        for j, i in enumerate(idxs):
            x0[j, :, :m] = plans[i]
        xs, _ = solver(torch.as_tensor(x0, device=device), tgts)
        seconds["class_fit"] = time.perf_counter() - clock

        # --- stage 2: the outer locals by KAK sandwich of every fitted core
        # (one batched evaluation), seeding the full parameterization
        clock = time.perf_counter()
        cores = core_fn(xs).cpu().numpy()
        xs = xs.cpu().numpy()
        x_full = np.zeros((B, n_core + 12))
        x_full[:, :n_core] = xs
        for j, i in enumerate(idxs):
            x_full[j, n_core:] = _locals_angles(*sandwich(block_form(i), kak_form(cores[j])))
        seconds["sandwich"] = time.perf_counter() - clock

        # --- stage 3: two f64 LM polishes of core and locals together (each
        # restarts the damping at 1e-3), then a direct full-parameter solve
        # of the lanes still above the threshold
        clock = time.perf_counter()
        full_fn = _with_locals(core_fn, n_core)
        full = make_solver(full_fn, n_core + 12, device=device)
        xf = torch.as_tensor(x_full, device=device)
        x_pol = full.polish(full.polish(xf, tgts, iters=12), tgts, iters=12)
        infids = _block_infidelities(full_fn(x_pol).cpu().numpy(), targets)
        x_pol = x_pol.cpu().numpy()
        seconds["polish"] = time.perf_counter() - clock
        fail = np.flatnonzero(infids > threshold)
        rescued = 0
        if len(fail):
            clock = time.perf_counter()
            rescue = make_solver(full_fn, n_core + 12, adam_iters=600, lm32_iters=16, lm_iters=16, device=device)
            rx0 = rng.uniform(-2 * np.pi, 2 * np.pi, (len(fail), restarts, n_core + 12))
            for jj, j in enumerate(fail):
                rx0[jj, :, :m] = plans[idxs[j]]
                rx0[jj, 0] = x_pol[j]  # restart 0: the polished seed
            rxs, _ = rescue(torch.as_tensor(rx0, device=device), tgts[torch.as_tensor(fail, device=device)])
            r_infids = _block_infidelities(full_fn(rxs).cpu().numpy(), targets[fail])
            rxs = rxs.cpu().numpy()
            for jj, j in enumerate(fail):
                if r_infids[jj] < infids[j]:
                    x_pol[j] = rxs[jj]
                    infids[j] = r_infids[jj]
                    rescued += int(r_infids[jj] <= threshold)
            seconds["rescue"] = time.perf_counter() - clock

        # --- the emit: every (block, pulse) matrix in one batched call, each
        # pulse at its plan's duration
        clock = time.perf_counter()
        PP = np.stack([[x_pol[j, m + mm * per_pulse : m + (mm + 1) * per_pulse] for mm in range(m)] for j in range(B)])
        TT = np.array([[plans[i][mm] for mm in range(m)] for i in idxs])
        Upulses = pulses(PP.reshape(B * m, per_pulse), TT.reshape(B * m)).reshape(B, m, 4, 4)
        fitted: Dict[int, Circuit] = {}
        for j, i in enumerate(idxs):
            if infids[j] > threshold:
                fallback.append(i)
                continue
            x = x_pol[j]
            old = durations_2q(i)
            c = fitted[i] = Circuit(2)
            _emit_u_layer(c, x[n_core : n_core + 6], duration_1q)
            for layer in range(m):
                pp = x[m + layer * per_pulse : m + (layer + 1) * per_pulse]
                c.append("pd_pulse", (0, 1), params=tuple(pp), matrix=Upulses[j, layer],
                         duration=old[layer] if layer < len(old) else None)
                if layer < m - 1:
                    lo = m + m * per_pulse + layer * 6
                    _emit_u_layer(c, x[lo : lo + 6], duration_1q)
            _emit_u_layer(c, x[n_core + 6 : n_core + 12], duration_1q)
        out.update(fitted)
        seconds["emit"] = time.perf_counter() - clock
        worst = float(infids.max())
        logger.info("fit_substituted_pd: fitted %d/%d blocks with %d pulse(s) (worst block infidelity %.2e)",
                    len(fitted), B, m, worst)
        record("class_fit", m=m, blocks=B, fitted=len(fitted), indices=list(idxs), infidelities=infids,
               failed=int(len(fail)), rescued=rescued, worst=worst, path=solver.path, seconds=sum(seconds.values()),
               stage_seconds=seconds, circuits=fitted)

    if fallback:
        # blocks the driven plan cannot reach at certification depth (SWAP
        # under the time-optimal [1.0, 0.5] plan needs an instantaneous local
        # layer inside the coupler time; models/trajectory.improved_swap):
        # three sqiSwap-time zero-drive pulses, one more 1Q layer of time,
        # solved as one plain depth-3 chain
        clock = time.perf_counter()
        (Pm,) = zero_pulses([0.5])
        a = build_ansatz([_const_gate("pd_sq_zero", 2, Pm)] * 3)
        solver = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=device)
        tgts = torch.as_tensor(np.stack([blocks[i].unitary for i in fallback]), dtype=torch.complex128, device=device)
        x0 = rng.uniform(0, 2 * np.pi, (len(fallback), restarts, a.n_params))
        xs, fs = solver(torch.as_tensor(x0, device=device), tgts)
        xs, fs = xs.cpu().numpy(), fs.cpu().numpy()
        fitted = {}
        for j, i in enumerate(fallback):
            if fs[j] > threshold:
                continue
            old = durations_2q(i)
            half = old[0] * 0.5 / plans[i][0] if old else None
            c = fitted[i] = Circuit(2)
            for layer in range(4):
                _emit_u_layer(c, xs[j, layer * 6 : (layer + 1) * 6], duration_1q)
                if layer < 3:
                    c.append("pd_pulse", (0, 1), params=(0.0,) * per_pulse, matrix=Pm, duration=half)
        out.update(fitted)
        if len(fitted) < len(fallback):
            logger.warning("fit_substituted_pd: %d blocks above threshold even after the exact fallback; "
                           "placeholders kept there", len(fallback) - len(fitted))
        logger.info("fit_substituted_pd: exact 3-segment fallback rescued %d/%d driven-plan failures",
                    len(fitted), len(fallback))
        record("fallback", blocks=len(fallback), fitted=len(fitted), indices=fallback, costs=fs,
               worst=float(fs.max()), path=solver.path, seconds=time.perf_counter() - clock, circuits=fitted)
    return out


def optimized_sqiswap_sub(
    circ: Circuit,
    duration_1q: float = 0.0,
    speed_method: str = "linear",
    seed: int = 0,
    fit_1q: bool = False,
    device=DEFAULT_DEVICE,
    stats: Optional[list] = None,
) -> Circuit:
    """OptimizedSqiswapSub (speed_limit_pass.py:317-464): CX-family blocks
    become a time-scaled parallel-driven iSwap, SWAP an iSwap then a
    sqiSwap, iSwap one iSwap, and any other block the fewest applications
    of the extended (smush) iSwap or sqiSwap coverage. Coordinates of all
    blocks are one batched call on ``device``, the general blocks' counts
    one batched call per set. 1Q layers are random placeholders, unless
    ``fit_1q``: then ``fit_substituted_pd`` fits each block's pulses and
    layers to its unitary (``stats``: its per-stage records)."""
    circ, blocks, subs, plans = _pd_substitutions(circ, duration_1q, speed_method, seed, resolve_device(device))
    if not blocks:
        return circ
    if fit_1q:
        subs = fit_substituted_pd(blocks, subs, plans, duration_1q=duration_1q, device=device, stats=stats)
    return _blocks_to_circuit(circ, subs)


def _pd_substitutions(circ: Circuit, duration_1q: float, speed_method: str, seed: int, device):
    """(unrolled circuit, blocks, substitution per block, drive plan per
    block: fractions of iSwap) of ``optimized_sqiswap_sub``."""
    from slam_decomposition_torch.explore.scaling import scaled_gate_for

    circ = unroll_3q_or_more(circ)
    blocks = consolidate_2q_blocks(circ)
    if not blocks:
        return circ, blocks, {}, {}
    rng = np.random.default_rng(seed)

    iswap = G.cg_iswap()
    sqiswap = G.conversion_gain_gate(0, 0, np.pi / 2, 0, 0.5)
    scaled_iswap = scaled_gate_for(iswap.params, speed_method)
    edge_iswap_t = _cached_template(
        "iswap_smush", device, lambda: MixedOrderBasisTemplate([iswap], smush=True, device=device))
    sq_t = _cached_template(
        "sqiswap_smush", device, lambda: MixedOrderBasisTemplate([sqiswap], smush=True, device=device))

    us = np.stack([b.unitary for b in blocks])
    coords = _c1c2c3_batch(us, device)
    is_ctrl = (np.abs(coords[:, 1]) < _CLASS_TOL) & (np.abs(coords[:, 2]) < _CLASS_TOL)
    is_swap = np.all(np.abs(coords - [0.5, 0.5, 0.5]) < _CLASS_TOL, axis=1)
    is_iswap = np.all(np.abs(coords - [0.5, 0.5, 0.0]) < _CLASS_TOL, axis=1)
    general = ~(is_ctrl | is_swap | is_iswap)
    ks_iswap = np.zeros(len(blocks), dtype=int)
    ks_sq = np.zeros(len(blocks), dtype=int)
    if general.any():
        ks_iswap[general] = edge_iswap_t.ks_for_batch(us[general])
        need_sq = np.zeros(len(blocks), dtype=bool)
        need_sq[general] = ks_iswap[general] != 1
        if need_sq.any():
            ks_sq[need_sq] = sq_t.ks_for_batch(us[need_sq])

    frac_cache: Dict[float, Tuple[G.Gate, np.ndarray]] = {}
    scaled_iswap_np = scaled_iswap.to_numpy()

    def scaled_fraction(frac: float) -> Tuple[G.Gate, np.ndarray]:
        """(gate, matrix) of a fraction of the scaled iSwap, one a fraction."""
        key = round(float(frac), 12)
        if key not in frac_cache:
            g = G.conversion_gain_gate(*scaled_iswap.params[:-1], scaled_iswap.params[-1] * frac)
            g = dataclasses.replace(G.cg_normalize_duration(g, 1.0), duration_override=scaled_iswap.duration * frac)
            frac_cache[key] = (g, g.to_numpy())
        return frac_cache[key]

    subs: Dict[int, Circuit] = {}
    plans: Dict[int, List[float]] = {}
    for i in range(len(blocks)):
        c = coords[i]
        sub = Circuit(2)
        _random_1q_layer(sub, rng, duration_1q)
        if abs(c[1]) < _CLASS_TOL and abs(c[2]) < _CLASS_TOL:
            # controlled family: a fraction of the parallel-driven iSwap
            frac = c[0] / 0.5
            g, g_np = scaled_fraction(frac)
            sub.append("pd_iswap", (0, 1), matrix=g_np, duration=g.duration)
            plans[i] = [float(frac)]
        elif np.allclose(c, [0.5, 0.5, 0.5], atol=_CLASS_TOL):
            # SWAP = pd-iSwap then sqiSwap
            sub.append("pd_iswap", (0, 1), matrix=scaled_iswap_np, duration=scaled_iswap.duration)
            _random_1q_layer(sub, rng, duration_1q)
            g, g_np = scaled_fraction(0.5)
            sub.append("pd_sqiswap", (0, 1), matrix=g_np, duration=g.duration)
            plans[i] = [1.0, 0.5]
        elif np.allclose(c, [0.5, 0.5, 0.0], atol=_CLASS_TOL) or ks_iswap[i] == 1:
            sub.append("pd_iswap", (0, 1), matrix=scaled_iswap_np, duration=scaled_iswap.duration)
            plans[i] = [1.0]
        else:
            # general: the extended sqiSwap coverage's count
            k = int(ks_sq[i])
            gsq, gsq_np = scaled_fraction(0.5)
            for _ in range(k):
                sub.append("pd_sqiswap", (0, 1), matrix=gsq_np, duration=gsq.duration)
                _random_1q_layer(sub, rng, duration_1q)
            plans[i] = [0.5] * k
        _random_1q_layer(sub, rng, duration_1q)
        subs[i] = sub
    return circ, blocks, subs, plans


def pass_manager_slam(
    circ: Circuit,
    strategy: str = "basic_overall",
    speed_method: str = "linear",
    duration_1q: float = 0.0,
    basic_metric: int = 0,
    family_extension: bool = False,
    coupling_edges=None,
    fit_1q: bool = False,
    device=DEFAULT_DEVICE,
    stats: Optional[list] = None,
) -> Tuple[Circuit, Dict]:
    """Winner-substitution manager (pass_manager_slam,
    speed_limit_pass.py:501-528): ``speed_gate_substitute``, then merged 1Q
    runs, and (circuit, duration_analysis). ``fit_1q=True`` makes the output
    fidelity-faithful where each group's fit certifies: substituted blocks'
    1Q layers are fitted so the circuit's unitary is kept block by block
    (``stats``: the per-group fit records). ``device`` is the card unless
    the caller names another."""
    out = optimize_1q_gates(
        speed_gate_substitute(
            circ, strategy=strategy, speed_method=speed_method, duration_1q=duration_1q, basic_metric=basic_metric,
            family_extension=family_extension, coupling_edges=coupling_edges, fit_1q=fit_1q, device=device,
            stats=stats,
        )
    )
    return out, duration_analysis(out, duration_1q)


def pass_manager_optimized_sqiswap(
    circ: Circuit, duration_1q: float = 0.0, speed_method: str = "linear", fit_1q: bool = False,
    device=DEFAULT_DEVICE, stats: Optional[list] = None,
) -> Tuple[Circuit, Dict]:
    """Parallel-drive identity manager (pass_manager_optimized_sqiswap,
    speed_limit_pass.py:468-497): ``optimized_sqiswap_sub``, merged 1Q
    runs, and (circuit, duration_analysis). ``fit_1q=True`` makes the
    output fidelity-faithful where the driven fit certifies
    (``fit_substituted_pd``; ``stats``: its per-stage records). ``device``
    is the card unless the caller names another."""
    out = optimize_1q_gates(
        optimized_sqiswap_sub(circ, duration_1q=duration_1q, speed_method=speed_method, fit_1q=fit_1q, device=device,
                              stats=stats)
    )
    return out, duration_analysis(out, duration_1q)
