"""The headline duration / fidelity table through the port (the protocol of
the JAX package's scripts/headline_benchmarks.py, which stays as it is).

    python -m slam_decomposition_torch.tools.headline [--device cuda] [--q 16] [--avg-reps 3]
        [--data-reps 10] [--haar-n 3000] [--out PATH]

SWAP duration, the Haar-average 2Q duration, and the QV, VQE(Linear),
VQE(Full) and QFT circuits routed onto the sqrt(q) x sqrt(q) grid (best of
``data_reps`` route seeds, averaged over ``avg_reps``), under the basic
(analytic sqiSwap) flow and the parallel-drive flow, duration_1q = 0.25,
linear SLF, total fidelity f = exp(-d * 100 ns / 100 us)^n. Writes
``build/slam_transpile/headline_results.json`` (never the repo's
``headline_results.json``) and prints the table and the seconds.

The basic flow runs the exact host routine per block (``batched=False``),
as the JAX script does on the CPU; the parallel-drive flow's coordinates
and counts run on ``device``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from slam_decomposition_torch.config import resolve_device, transpile_dir
from slam_decomposition_torch.models import gates as G
from slam_decomposition_torch.opt.samplers import haar_sample
from slam_decomposition_torch.transpile import library
from slam_decomposition_torch.transpile.ir import Circuit
from slam_decomposition_torch.transpile.passes import pass_manager_basic, pass_manager_optimized_sqiswap
from slam_decomposition_torch.transpile.route import grid_coupling, route

DUR_1Q = 0.25


def fidelity(duration, n_qubits, t_2q_ns=100.0, t1_us=100.0):
    """f = exp(-d * t_2q / T1)^n."""
    return float(np.exp(-duration * t_2q_ns * 1e-9 / (t1_us * 1e-6)) ** n_qubits)


def managers(c: Circuit, device):
    """(basic, parallel-drive) duration analyses of one circuit."""
    _, mb = pass_manager_basic(c, gate="sqiswap", duration_1q=DUR_1Q, batched=False, device=device)
    _, mo = pass_manager_optimized_sqiswap(c, duration_1q=DUR_1Q, device=device)
    return mb, mo


def gate_duration(U, device):
    c = Circuit(2)
    c.unitary(U, (0, 1))
    mb, mo = managers(c, device)
    return mb["duration"], mo["duration"]


def main(q=16, avg_reps=3, data_reps=10, haar_n=3000, device="cuda", out=None, log=print) -> dict:
    """The table as a dict (the JAX script's keys), written to ``out``
    (default ``build/slam_transpile/headline_results.json``)."""
    device = resolve_device(device)
    results = {}
    rows = cols = int(np.sqrt(q))
    if rows * cols != q:
        raise ValueError("the grid protocol needs a square qubit count")
    edges = grid_coupling(rows, cols)

    db, do = gate_duration(G.SWAP.to_numpy(), device)
    results["SWAP"] = {"basic": db, "optimized": do}
    log(f"SWAP duration: basic {db:.3f} optimized {do:.3f} (reference: 2.5 -> 2.25)")

    t0 = time.perf_counter()
    pairs = [gate_duration(U, device) for U in haar_sample(haar_n, seed=0)]
    basics, opts = np.array(pairs).T
    results["haar_avg"] = {"basic": float(np.mean(basics)), "optimized": float(np.mean(opts)), "n": haar_n}
    log(f"Haar-average 2Q duration (N={haar_n}): basic {np.mean(basics):.4f} optimized {np.mean(opts):.4f} "
        f"(reference: 1.9055 -> 1.7075) [{time.perf_counter() - t0:.1f}s]")

    suite = {
        "QV": lambda s: library.qv(q, seed=s),
        "VQE(Linear)": lambda s: library.vqe_linear(q, seed=s),
        "VQE(Full)": lambda s: library.vqe_full(q, seed=s),
        "QFT": lambda s: library.qft(q),
    }
    for name, gen in suite.items():
        t0 = time.perf_counter()
        bests = []  # per rep: (basic, optimized, basic ref metric, optimized ref metric)
        for rep in range(avg_reps):
            best_b = best_o = best_br = best_or = np.inf
            for dr in range(data_reps):
                seed = rep * data_reps + dr
                c = route(gen(seed), edges, seed=seed, rows_cols=(rows, cols))
                mb, mo = managers(c, device)
                if mb["duration"] < best_b:
                    best_b, best_br = mb["duration"], mb["duration_ref_metric"]
                if mo["duration"] < best_o:
                    best_o, best_or = mo["duration"], mo["duration_ref_metric"]
            bests.append((best_b, best_o, best_br, best_or))
        b, o, br, orr = np.array(bests, dtype=float).T
        ab, ao = float(np.mean(b)), float(np.mean(o))
        fb, fo = fidelity(ab, q), fidelity(ao, q)
        results[name] = {
            "basic": ab, "optimized": ao, "basic_err": float(np.std(b)), "optimized_err": float(np.std(o)),
            "basic_ref_metric": float(np.mean(br)), "optimized_ref_metric": float(np.mean(orr)),
            "fid_basic": fb, "fid_opt": fo, "fid_gain_pct": 100 * (fo / fb - 1),
        }
        log(f"{name}-{q}: basic {ab:.2f} optimized {ao:.2f} ({100 * (ao / ab - 1):+.1f}%); ref-metric "
            f"{np.mean(br):.2f} -> {np.mean(orr):.2f}; total-fidelity {100 * (fo / fb - 1):+.1f}% "
            f"[{time.perf_counter() - t0:.1f}s]")
        if ab < ao - 1e-9:
            raise AssertionError(f"{name}: the parallel-drive flow is worse than the basic flow")

    path = transpile_dir() / "headline_results.json" if out is None else out
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(results, indent=1))
    log(f"wrote {path}")
    return results


def _cli():
    import pathlib

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--avg-reps", type=int, default=3)
    ap.add_argument("--data-reps", type=int, default=10)
    ap.add_argument("--haar-n", type=int, default=3000)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    a = ap.parse_args()
    t0 = time.perf_counter()
    main(a.q, a.avg_reps, a.data_reps, a.haar_n, a.device, a.out)
    print(f"whole run {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    _cli()
