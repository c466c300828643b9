"""The headline fidelity gains attributed to the router (JAX
scripts/fidelity_attribution.py).

The reference's total-fidelity model is f = exp(-d * 100 ns / 100 us)^n, so
the basic -> optimized gain is gain = exp(n (d_basic - d_opt) / 1000) - 1, a
function of the absolute duration gap alone. Each headline circuit is
routed onto the 4x4 grid by the round-1 router (one (relax=False,
depth_w=0, swap_busy=False) SABRE config, scored by swap count, no
rescheduling) and by the round-2 router (``transpile.route``'s default),
the same routed circuit goes through ``pass_manager_basic`` and
``pass_manager_optimized_sqiswap`` per seed, and the best basic duration's
pair is kept; the gains under each router print beside the reference's.

    python3 -m slam_decomposition_torch.tools.fidelity_attribution [n_seeds] [--device cuda|cpu]

Writes ``config.studies_dir()/fidelity_attribution.json``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import write_json
from slam_decomposition_torch.tools.parity_diagnostics import suite

Q = 16
DUR_1Q = 0.25

# reference (basic, optimized, published gain %) from BASELINE.md rows 8-12
REF = {
    "QV": (133.0, 118.08, +27.0),
    "VQE(Linear)": (25.75, 21.5, None),
    "VQE(Full)": (318.0, 273.3, +104.4),
    "QFT": (127.5, 106.2, +40.6),
}


def swap_count(circ) -> int:
    return sum(1 for op in circ.ops if op.n_qubits == 2)


def gain_pct(d_basic, d_opt, n=Q) -> float:
    return 100.0 * (np.exp(n * (d_basic - d_opt) * 1e-3) - 1.0)


def router_kwargs(router: str) -> dict:
    if router == "round1":
        return dict(configs=[(False, 0.0, False)], score_fn=swap_count, reschedule=False)
    return {}


def run(gen, router: str, n_seeds: int, device=DEFAULT_DEVICE) -> tuple:
    """(basic, optimized) durations of the seed of least basic duration."""
    from slam_decomposition_torch.transpile.passes import pass_manager_basic, pass_manager_optimized_sqiswap
    from slam_decomposition_torch.transpile.route import grid_coupling, route

    edges = grid_coupling(4, 4)
    best = None
    for seed in range(n_seeds):
        c = route(gen(seed), edges, seed=seed, rows_cols=(4, 4), **router_kwargs(router))
        _, mb = pass_manager_basic(c, gate="sqiswap", duration_1q=DUR_1Q, device=device)
        _, mo = pass_manager_optimized_sqiswap(c, duration_1q=DUR_1Q, device=device)
        if best is None or mb["duration"] < best[0]:
            best = (mb["duration"], mo["duration"])
    return best


def attribution(n_seeds: int = 10, device=DEFAULT_DEVICE, q: int = Q) -> dict:
    device = resolve_device(device)
    results = {}
    gens = suite(q)
    for name in REF:  # the script's order
        gen = gens[name]
        row = {"ref": REF[name]}
        for router in ("round1", "round2"):
            t0 = time.perf_counter()
            db, do = run(gen, router, n_seeds, device)
            row[router] = {"basic": db, "opt": do, "gap": db - do, "fid_gain_pct": round(gain_pct(db, do), 1),
                           "seconds": time.perf_counter() - t0}
            print(f"{name:<12} {router}: basic {db:.2f} opt {do:.2f} gap {db - do:.2f} fid gain "
                  f"{gain_pct(db, do):+.1f}% [{row[router]['seconds']:.0f}s]")
        rb, ro, rg = REF[name]
        ref_gain = gain_pct(rb, ro)
        print(f"{name:<12} reference: basic {rb} opt {ro} gap {rb - ro:.2f} fid gain {ref_gain:+.1f}%"
              + (f" (published {rg:+.1f}%)" if rg is not None else ""))
        row["ref_gain_pct"] = round(ref_gain, 1)
        results[name] = row
    return results


def check_identity() -> None:
    """The published fidelity gains are exp(n gap / 1000) - 1."""
    for name, (rb, ro, rg) in REF.items():
        if rg is not None:
            assert abs(gain_pct(rb, ro) - rg) < 0.6, (name, gain_pct(rb, ro), rg)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_seeds", type=int, nargs="?", default=10)
    ap.add_argument("--qubits", type=int, default=Q)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    results = attribution(a.n_seeds, a.device, a.qubits)
    check_identity()
    path = write_json("fidelity_attribution.json", results)
    print(f"\nwrote {path} [{time.perf_counter() - t0:.0f}s total]")
    return results


if __name__ == "__main__":
    main()
