"""Certify the extended-volume frontier by solving inside it (the protocol
of the JAX package's scripts/certify_extended_frontier.py, which stays as
it is).

    python -m slam_decomposition_torch.tools.certify_frontier [n_targets] [restarts] [--device cuda] [--out PATH]

The extended-coverage hulls (explore/smush_volume.rational_hull) relax
float facets outward, so a row's extended volume is an upper estimate of
what the parallel-driven template reaches. For every (gate, k) row of
``extended_results.json`` whose extended volume exceeds its base volume,
this draws Haar targets whose monodromy class lies inside the extended
polytope and outside the bare coverage polytope (the frontier the volume
win is claimed from), runs the parallel-drive class fit over the k-cycle
driven template the hulls were sampled from (Makhlin residual, Adam 400,
f32 LM 16, f64 LM 16, ranked by the Makhlin functional) and reports the
fraction certified at or below 1e-10, with up to two rescue rounds of
fresh starts for the stragglers.

The targets are padded to PAD = 128 lanes by cycling them, as the JAX
script does; that layout decides which targets get a second lane of
restarts, so it is part of the result. Starts come from the script's
generators in its order. ``extended_results.json`` and the coverage sets
are read where they are; the rows are written, one at a time, to
``build/slam_coverage/frontier_certification.json``
(``config.coverage_cache_dir()``), and rows already there are skipped.
Solves run on the card unless ``--device`` names another.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, coverage_cache_dir, data_dir, resolve_device
from slam_decomposition_torch.explore.smush_volume import DURATION_1Q, NAMED_GATES, _smush_eval, load_smush_coverage
from slam_decomposition_torch.models import gates as G

N_TARGETS = 100
RESTARTS = 16
THRESH = 1e-10
HAAR_POOL = 20_000
PAD = 128  # lanes a row: the targets cycled
RESCUE_ROUNDS = 2


def frontier_targets(name: str, k: int, n: int, device=DEFAULT_DEVICE) -> np.ndarray:
    """The first ``n`` of ``haar_sample(HAAR_POOL, seed=20260821 + 31 k +
    len(name))`` whose monodromy class lies inside the extended polytope of
    (name, k) and outside the bare coverage polytope, (m, 4, 4) with m <= n.
    The representatives of the whole pool are one batched call on
    ``device``."""
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_reps_float
    from slam_decomposition_torch.opt.samplers import haar_sample

    device = resolve_device(device)
    gc, gg, t, iters = NAMED_GATES[name]
    base_gate = G.cg_canonicalize(G.conversion_gain_gate(0, 0, gc, gg, t))
    bare = gate_set_to_coverage(base_gate, max_layers=iters, device=device)
    ext = load_smush_coverage(base_gate)[k]
    base = bare[k] if k < len(bare) else None
    Us = haar_sample(HAAR_POOL, seed=20260821 + 31 * k + len(name))
    reps = monodromy_reps_float(Us, device)[:, :, :3]
    picked = []
    for U, r in zip(Us, reps):
        if not ext.contains_float(r) or (base is not None and base.contains_float(r)):
            continue
        picked.append(U)
        if len(picked) >= n:
            break
    return np.stack(picked) if picked else np.zeros((0, 4, 4), complex)


def certify_row(name: str, k: int, n_targets: int, restarts: int = RESTARTS, device=DEFAULT_DEVICE,
                detail: bool = False) -> dict:
    """The row's summary (the JAX script's keys): frontier targets sampled,
    the fraction certified at THRESH, the median and worst loss, and the
    solve's seconds. With ``detail`` also the targets (B, 4, 4), each
    target's best parameters (B, n) and loss (B,), the certified mask and
    the number of solve rounds."""
    from slam_decomposition_torch.opt.costs import makhlin_functional_cost
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    device = resolve_device(device)
    gc, gg, t, _ = NAMED_GATES[name]
    Us = frontier_targets(name, k, n_targets, device)
    B = len(Us)
    if B == 0:
        return {"name": name, "k": k, "frontier_sampled": 0}
    eval_fn, n_params = _smush_eval(gc, gg, t, k)
    n_slices = max(int(round(t / DURATION_1Q)), 1)
    per_cycle = 2 + 2 * n_slices
    solver = make_solver(eval_fn, n_params, adam_iters=400, lm32_iters=16, lm_iters=16, residual="makhlin",
                         final_cost_fn=makhlin_functional_cost, device=device)
    idx = np.resize(np.arange(B), PAD)
    tgt = torch.as_tensor(Us[idx], dtype=torch.complex128, device=device)
    rng = np.random.default_rng(7 * k + len(name))

    def x0_draw(r):
        x0 = rng.uniform(0, 2 * np.pi, (PAD, r, n_params))
        for c in range(k):  # physically scaled drive amplitudes
            lo = c * per_cycle + 2
            x0[..., lo : lo + 2 * n_slices] = rng.uniform(-4.0, 4.0, (PAD, r, 2 * n_slices))
        return torch.as_tensor(x0, device=device)

    losses = np.full(B, np.inf)
    xbest = np.zeros((B, n_params))

    def solve_round():
        xs, bf = solver(x0_draw(restarts), tgt)
        xs, bf = xs.cpu().numpy(), bf.cpu().numpy()
        before = losses.copy()
        np.minimum.at(losses, idx, bf)
        for lane, j in enumerate(idx):  # each improved target keeps its first lane at the new minimum
            if losses[j] < before[j] and bf[lane] == losses[j]:
                xbest[j] = xs[lane]
                before[j] = losses[j]

    t0 = time.perf_counter()
    solve_round()
    rounds = 1
    for _ in range(RESCUE_ROUNDS):
        if (losses <= THRESH).all():
            break
        solve_round()
        rounds += 1
    seconds = time.perf_counter() - t0
    out = {
        "name": name,
        "k": k,
        "frontier_sampled": B,
        "certified_frac": round(float((losses <= THRESH).mean()), 4),
        "median_loss": float(np.median(losses)),
        "worst_loss": float(losses.max()),
        "seconds": round(seconds, 1),
        "threshold": THRESH,
    }
    if detail:
        out.update(targets=Us, x=xbest, losses=losses, certified=losses <= THRESH, rounds=rounds)
    return out


def frontier_rows(results) -> list:
    """(k, name) of every row of extended_results.json whose extended volume
    beats its base and that ``results`` lacks, k = 1 rows first."""
    rows = json.loads((data_dir() / "extended_results.json").read_text())
    done = {(r["name"], r["k"]) for r in results}
    todo = []
    for name, per_k in rows.items():
        for k_str, (base_vol, ext_vol, *_flags) in sorted(per_k.items()):
            if ext_vol > base_vol + 1e-12 and (name, int(k_str)) not in done:
                todo.append((int(k_str), name))
    return sorted(todo)


def main(n_targets=N_TARGETS, restarts=RESTARTS, device="cuda", out=None, log=print) -> list:
    """Certify every frontier row missing from ``out`` (default
    ``build/slam_coverage/frontier_certification.json``), writing the file
    after each row; returns all rows."""
    path = coverage_cache_dir() / "frontier_certification.json" if out is None else out
    try:
        results = json.loads(path.read_text())
    except (OSError, json.JSONDecodeError):
        results = []
    path.parent.mkdir(parents=True, exist_ok=True)
    for k, name in frontier_rows(results):
        row = certify_row(name, k, n_targets, restarts, device)
        log(json.dumps(row))
        results.append(row)
        path.write_text(json.dumps(results, indent=1))  # partial results survive a cut
    return results


if __name__ == "__main__":
    import pathlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_targets", nargs="?", type=int, default=N_TARGETS)
    ap.add_argument("restarts", nargs="?", type=int, default=RESTARTS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", type=pathlib.Path, default=None)
    a = ap.parse_args()
    t0 = time.perf_counter()
    main(a.n_targets, a.restarts, a.device, a.out, log=lambda line: print(line, flush=True))
    print(f"# {time.perf_counter() - t0:.1f} s", file=sys.stderr)
