"""Coupling-map routing: SABRE-style SWAP insertion (JAX
transpile/route.py, host numpy: the same heuristics and the same numpy
random calls in the same order, so a seed gives the same routed circuit).

The reference delegates layout/routing to qiskit's
``transpile(qc, coupling_map=CouplingMap.from_grid(4, 4),
optimization_level=3)`` before its duration passes
(results/main.ipynb cell 8). This framework is qiskit-free, so the router
is native: a SABRE-lite heuristic (front layer + lookahead + decay,
Li/Ding/Xie arXiv:1809.02573) over an arbitrary coupling graph, with
multi-trial layout search (snake / trivial / random) keeping the
lowest-duration result.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from slam_decomposition_torch.transpile.consolidate import collect_2q_blocks
from slam_decomposition_torch.transpile.ir import Circuit


# basic-pipeline block durations used for all routing-side makespan
# estimates (duration_proxy, schedule_for_duration, _sabre_once's emit and
# swap accounting): 1Q layer 0.25; consolidated 2-application sqiswap block
# 2*0.5 + 3*0.25 = 1.75; 3-application (swap-carrying) block 2.25. One
# source of truth — if the transpile passes' duration model changes, the
# router must score the same objective the benchmark measures.
DUR_1Q = 0.25
DUR_2APP = 1.75
DUR_3APP = 2.25


def grid_coupling(rows: int, cols: int) -> List[Tuple[int, int]]:
    """Edges of a rows x cols grid, row-major numbering
    (CouplingMap.from_grid analog)."""
    edges = []
    for r in range(rows):
        for c in range(cols):
            q = r * cols + c
            if c + 1 < cols:
                edges.append((q, q + 1))
            if r + 1 < rows:
                edges.append((q, q + cols))
    return edges


def snake_order(rows: int, cols: int) -> List[int]:
    """Physical qubits in boustrophedon order — a Hamiltonian path of the
    grid, so a linear-chain circuit routes with zero swaps."""
    order = []
    for r in range(rows):
        row = list(range(r * cols, (r + 1) * cols))
        order.extend(row if r % 2 == 0 else row[::-1])
    return order


def _distances(n: int, edges: Sequence[Tuple[int, int]]) -> np.ndarray:
    adj: List[List[int]] = [[] for _ in range(n)]
    for a, b in edges:
        adj[a].append(b)
        adj[b].append(a)
    dist = np.full((n, n), np.inf)
    for s in range(n):
        dist[s, s] = 0
        dq = deque([s])
        while dq:
            u = dq.popleft()
            for v in adj[u]:
                if dist[s, v] == np.inf:
                    dist[s, v] = dist[s, u] + 1
                    dq.append(v)
    return dist


_ZDIAG_1Q = {"rz", "z", "s", "t", "sdg", "tdg", "p", "phase"}
_XDIAG_1Q = {"x", "rx"}


def _axis_on(op, q) -> Optional[str]:
    """The Pauli axis on which ``op`` acts diagonally at qubit ``q``
    ('z'/'x'), or None. cp/cz/rzz are Z-diagonal on both qubits; cx is
    Z-diagonal on its control and X-diagonal on its target."""
    if op.name in ("cp", "cz", "rzz"):
        return "z"
    if op.name == "cx":
        return "z" if q == op.qubits[0] else "x"
    if op.n_qubits == 1:
        if op.name in _ZDIAG_1Q:
            return "z"
        if op.name in _XDIAG_1Q:
            return "x"
    return None


def _commute(a, b) -> bool:
    """Sufficient commutation test: on every shared qubit, both ops are
    diagonal on the same Pauli axis."""
    shared = set(a.qubits) & set(b.qubits)
    for q in shared:
        ax = _axis_on(a, q)
        if ax is None or ax != _axis_on(b, q):
            return False
    return True


def duration_proxy(
    circ: Circuit,
    dur_1q: float = DUR_1Q,
    dur_2app: float = DUR_2APP,
    dur_3app: float = DUR_3APP,
) -> float:
    """Cheap estimate of the basic-pipeline duration of a routed circuit:
    consolidate 2Q blocks, then ASAP makespan with 2-application blocks at
    1.75 and swap-containing (3-application) blocks at 2.25 (sqiswap 0.5 +
    1Q layers 0.25 each). This is the objective the benchmark actually
    scores — ranking routing trials by raw swap count picks circuits whose
    critical path is LONGER (measured: QFT-16 with 55 swaps at makespan
    145.75 vs 101 swaps at 133.0)."""
    from collections import defaultdict

    blocks, leftovers = collect_2q_blocks(circ)
    events = [(pos, dur_1q, (op.qubits[0],)) for pos, op in leftovers]
    for b in blocks:
        has_swap = any(o.name == "swap" for o in b.ops)
        events.append(
            (max(b.positions), dur_3app if has_swap else dur_2app,
             tuple(b.qubits))
        )
    events.sort(key=lambda e: e[0])
    finish: dict = defaultdict(float)
    for _, cost, qs in events:
        start = max(finish[q] for q in qs)
        for q in qs:
            finish[q] = start + cost
    return max(finish.values(), default=0.0)


def _commute_dag(ops, relax: bool = True) -> Tuple[List[int], List[List[int]]]:
    """Dependency DAG over ops as (pred counts, successor lists): per-qubit
    chains RELAXED by commutation — consecutive ops that are jointly
    diagonal (same Pauli axis) on every shared qubit commute and become
    independent, so a router's front layer can pick whichever commuting
    gate is currently cheap. This is the big lever on structured circuits
    (QFT's cp cascades all mutually commute; cx chains sharing a
    control/target likewise) that qiskit's optimization_level=3 exploits
    and a plain per-qubit-chain SABRE cannot (the reference routes with O3,
    results/main.ipynb cell 1)."""
    n_ops = len(ops)
    pred_sets: List[set] = [set() for _ in range(n_ops)]
    group: Dict[int, List[int]] = {}  # qubit -> current commuting group
    group_preds: Dict[int, List[int]] = {}  # qubit -> group's predecessors
    for i, op in enumerate(ops):
        for q in op.qubits:
            g = group.get(q, [])
            if relax and g and all(_commute(ops[j], op) for j in g):
                pred_sets[i].update(group_preds.get(q, ()))
                g.append(i)
            else:
                pred_sets[i].update(g)
                group_preds[q] = g
                group[q] = [i]
    preds = [0] * n_ops
    succs: List[List[int]] = [[] for _ in range(n_ops)]
    for i, ps in enumerate(pred_sets):
        preds[i] = len(ps)
        for j in ps:
            succs[j].append(i)
    return preds, succs


def schedule_for_duration(
    circ: Circuit,
    dur_1q: float = DUR_1Q,
    dur_2q: float = DUR_2APP,
    dur_swap: float = DUR_3APP,
) -> Circuit:
    """Reorder ops (semantics preserved via the commutation DAG) to
    minimize the ASAP makespan of the emitted order: critical-path list
    scheduling with per-qubit resources. A swap-greedy router can emit a
    commuting sibling ahead of a critical-chain gate, pushing the whole
    chain later; this pass undoes that. Durations are the basic-pipeline
    block costs (2-app block 1.75, 3-app/swap 2.25, 1Q layer 0.25) — only
    the relative priorities matter."""
    import heapq

    ops = circ.ops
    n_ops = len(ops)
    preds, succs = _commute_dag(ops)

    def d(op):
        if op.n_qubits == 1:
            return dur_1q
        return dur_swap if op.name == "swap" else dur_2q

    # downstream critical path (reverse topological order = reverse of any
    # forward topo order; program order IS one since deps point backward)
    prio = [0.0] * n_ops
    for i in range(n_ops - 1, -1, -1):
        down = max((prio[s] for s in succs[i]), default=0.0)
        prio[i] = d(ops[i]) + down

    finish = [0.0] * circ.n_qubits
    npred = list(preds)
    ready = [(-prio[i], i) for i in range(n_ops) if npred[i] == 0]
    heapq.heapify(ready)
    out = Circuit(circ.n_qubits)
    while ready:
        _, i = heapq.heappop(ready)
        op = ops[i]
        start = max((finish[q] for q in op.qubits), default=0.0)
        for q in op.qubits:
            finish[q] = start + d(op)
        out.append(op)
        for s in succs[i]:
            npred[s] -= 1
            if npred[s] == 0:
                heapq.heappush(ready, (-prio[s], s))
    assert len(out.ops) == n_ops
    return out


def _sabre_once(
    circ: Circuit,
    edges: Sequence[Tuple[int, int]],
    dist: np.ndarray,
    layout: List[int],
    decay_step: float = 0.001,
    lookahead: int = 20,
    lookahead_w: float = 0.5,
    final_layout: Optional[List[int]] = None,
    relax: bool = True,
    depth_w: float = 0.35,
    swap_busy: bool = True,
) -> Circuit:
    """One routing pass with a fixed initial layout. ``layout[logical] =
    physical``. Returns the routed circuit on physical qubits; if
    ``final_layout`` is a list it receives the end-of-circuit mapping
    (for SABRE's forward-backward layout iteration)."""
    n = dist.shape[0]  # physical qubit count (>= circ.n_qubits)
    pi = list(layout)

    n_ops = len(circ.ops)
    preds, succs = _commute_dag(circ.ops, relax=relax)
    front = deque(i for i in range(n_ops) if preds[i] == 0)
    out = Circuit(n)
    decay = np.zeros(n)
    done = 0
    front_set = set(front)
    executed = [False] * n_ops

    last_pair: Dict[int, Tuple[int, int]] = {}  # phys qubit -> last 2q pair
    finish = np.zeros(n)  # per-physical-qubit busy-until (duration units)

    def emit(i):
        op = circ.ops[i]
        mapped = tuple(pi[q] for q in op.qubits)
        out.append(dataclasses.replace(op, qubits=mapped))
        t0 = max(finish[p] for p in mapped)
        dop = DUR_1Q if op.n_qubits == 1 else (
            DUR_3APP if op.name == "swap" else DUR_2APP
        )
        for p in mapped:
            finish[p] = t0 + dop
        if op.n_qubits == 2:
            pair = (min(mapped), max(mapped))
            for p in mapped:
                last_pair[p] = pair
        executed[i] = True
        for s in succs[i]:
            preds[s] -= 1
            if preds[s] == 0:
                front.append(s)
                front_set.add(s)

    while done < n_ops:
        progressed = True
        while progressed:
            progressed = False
            for i in list(front):
                op = circ.ops[i]
                if op.n_qubits == 1 or (
                    op.n_qubits == 2 and dist[pi[op.qubits[0]], pi[op.qubits[1]]] <= 1
                ):
                    front.remove(i)
                    front_set.discard(i)
                    emit(i)
                    done += 1
                    progressed = True
                    decay[:] = 0.0  # SABRE resets decay on progress
        if done == n_ops:
            break
        # blocked: pick the swap minimizing the SABRE heuristic
        blocked = [circ.ops[i] for i in front if circ.ops[i].n_qubits == 2]
        # extended lookahead set: next few not-yet-done 2Q ops in program order
        ext = []
        for i in range(n_ops):
            if len(ext) >= lookahead:
                break
            if not executed[i] and i not in front_set and circ.ops[i].n_qubits == 2:
                ext.append(circ.ops[i])
        cand_swaps = set()
        for op in blocked:
            for lq in op.qubits:
                p = pi[lq]
                for a, b in edges:
                    if a == p or b == p:
                        cand_swaps.add((min(a, b), max(a, b)))
        inv = {p: l for l, p in enumerate(pi)}

        def score(sw):
            a, b = sw
            trial = dict(((a, b), (b, a)))
            def d(p):
                return trial.get(p, p)
            h = sum(dist[d(pi[o.qubits[0]]), d(pi[o.qubits[1]])] for o in blocked)
            h /= max(len(blocked), 1)
            if ext:
                he = sum(
                    dist[d(pi[o.qubits[0]]), d(pi[o.qubits[1]])] for o in ext
                ) / len(ext)
                h += lookahead_w * he
            h = (1 + max(decay[a], decay[b])) * h
            # consolidation bias: a swap on the pair that just carried a 2Q
            # gate fuses into that block downstream (zero marginal cost)
            if last_pair.get(a) == (a, b):
                h -= 0.12
            # depth awareness: prefer swaps on idle qubits — a swap on the
            # busiest wire lands on the critical path, one on a cold wire
            # hides in existing slack (the benchmark scores MAKESPAN, not
            # swap count)
            if depth_w:
                tmax = finish.max()
                if tmax > 0:
                    h += depth_w * (max(finish[a], finish[b]) / tmax)
            return h

        best = min(sorted(cand_swaps), key=score)
        a, b = best
        out.append("swap", (a, b))
        if swap_busy:
            # account the inserted swap's duration in the busy-until map the
            # depth term reads. Both accountings are useful heuristics —
            # counting self-inserted swaps steers later swaps onto cold
            # wires (helps random circuits); ignoring them biases toward
            # reusing recently-swapped wires, which consolidation then
            # absorbs (helps structured cascades) — so route() tries both
            # and lets the duration score arbitrate.
            t0 = max(finish[a], finish[b])
            finish[a] = finish[b] = t0 + DUR_3APP
            pair = (min(a, b), max(a, b))
            last_pair[a] = last_pair[b] = pair
        la, lb = inv.get(a), inv.get(b)
        if la is not None:
            pi[la] = b
        if lb is not None:
            pi[lb] = a
        decay[a] += decay_step
        decay[b] += decay_step
    if final_layout is not None:
        final_layout[:] = pi
    return out


def route(
    circ: Circuit,
    edges: Sequence[Tuple[int, int]],
    seed: int = 0,
    trials: int = 4,
    rows_cols: Optional[Tuple[int, int]] = None,
    score_fn=None,
    return_layouts: bool = False,
    configs: Optional[Sequence[Tuple[bool, float, bool]]] = None,
    reschedule: bool = True,
) -> Circuit:
    """Route ``circ`` onto the coupling graph, trying several initial
    layouts (snake, trivial, random) and keeping the best result.

    ``score_fn(circuit) -> float`` ranks results (default: the
    basic-pipeline duration proxy). With ``return_layouts`` the winning
    trial's (routed, initial, final) logical->physical layouts come back —
    needed to verify unitary equivalence modulo the tracked permutation.

    ``configs``: (relax, depth_w, swap_busy) SABRE variants to arbitrate
    (default: the full round-2 set). ``configs=[(False, 0.0, False)]``
    with ``score_fn=swap count`` and ``reschedule=False`` reproduces the
    round-1 swap-greedy chain-DAG router — used by
    scripts/fidelity_attribution.py to attribute headline fidelity-gain
    deltas to the router."""
    n = circ.n_qubits
    n_phys = max(max(e) for e in edges) + 1
    if n > n_phys:
        raise ValueError(f"circuit has {n} qubits, coupling graph {n_phys}")
    dist = _distances(n_phys, edges)
    rng = np.random.default_rng(seed)
    layouts: List[List[int]] = [list(range(n))]
    if rows_cols is not None:
        sn = snake_order(*rows_cols)
        layouts.append([sn[i] for i in range(n)])
    for _ in range(max(trials - len(layouts), 0)):
        layouts.append(list(rng.permutation(n_phys))[:n])
    if score_fn is None:
        # rank trials by the basic-pipeline duration estimate — the actual
        # benchmark objective. (Block count / raw swap count are the wrong
        # proxies: consolidation makes some swaps free, and swap-minimal
        # routings can have strictly longer critical paths.)
        score_fn = duration_proxy
    rev = Circuit(n)
    for op in reversed(circ.ops):
        rev.append(op)
    best = None
    for lay in layouts:
        # SABRE layout: forward-backward passes refine the initial layout
        # (Li/Ding/Xie sec. V); the final mapping of each pass seeds the
        # next direction's initial layout. Both dependency-DAG modes are
        # tried — commutation-relaxed routing saves many swaps on
        # structured circuits but can serialize the critical path, so the
        # duration score arbitrates.
        # depth_w=0 never reads the busy-until map, so swap_busy is
        # irrelevant there — try both accountings only for the depth-aware
        # configs (see the swap_busy note in _sabre_once)
        for relax, depth_w, swap_busy in (configs if configs is not None else (
            (True, 0.35, True), (False, 0.35, True),
            (True, 0.35, False), (False, 0.35, False),
            (True, 0.0, True), (False, 0.0, True),
        )):
            cur = list(lay)
            for _ in range(2):
                fl: List[int] = []
                _sabre_once(rev, edges, dist, cur, final_layout=fl,
                            relax=relax, depth_w=depth_w,
                            swap_busy=swap_busy)
                cur = fl
                fl = []
                init = list(cur)
                routed = _sabre_once(circ, edges, dist, cur,
                                     final_layout=fl, relax=relax,
                                     depth_w=depth_w, swap_busy=swap_busy)
                # fix the emission order: swap-greedy routing may emit
                # commuting siblings ahead of critical-chain gates
                if reschedule:
                    routed = schedule_for_duration(routed)
                s = score_fn(routed)
                if best is None or s < best[0]:
                    best = (s, routed, init, list(fl))
                cur = fl
    if return_layouts:
        return best[1], best[2], best[3]
    return best[1]
