"""Per-circuit routing and block diagnostics of the headline table (JAX
scripts/parity_diagnostics.py): each circuit routed onto the 4x4 grid
(``transpile.route``, the best basic duration over the seeds), then the
router's swaps, the consolidated 2Q blocks and their sqiSwap counts
(``opt.samplers.sqiswap_count_batch``), and both duration metrics.

    python3 -m slam_decomposition_torch.tools.parity_diagnostics [circuit ...] [--seeds 10] [--device cuda|cpu]

One JSON line per circuit (the script's keys); the rows also go to
``config.studies_dir()/parity_diagnostics.json``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import write_json

Q = 16
DUR_1Q = 0.25


def diagnose(name, gen, n_seeds=10, device=DEFAULT_DEVICE) -> dict:
    from slam_decomposition_torch.opt.samplers import sqiswap_count_batch
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.passes import pass_manager_basic
    from slam_decomposition_torch.transpile.route import grid_coupling, route

    device = resolve_device(device)
    edges = grid_coupling(4, 4)
    best = None
    for seed in range(n_seeds):
        c = route(gen(seed), edges, seed=seed, rows_cols=(4, 4))
        _, mb = pass_manager_basic(c, gate="sqiswap", duration_1q=DUR_1Q, device=device)
        if best is None or mb["duration"] < best[1]["duration"]:
            best = (c, mb, seed)
    c, mb, seed = best
    blocks = consolidate_2q_blocks(c)
    ks = sqiswap_count_batch(np.stack([b.unitary for b in blocks]), device)
    uniq, cnt = np.unique(ks, return_counts=True)
    out = {
        "circuit": name,
        "seed": seed,
        "router_swaps": sum(1 for op in c.ops if op.name == "swap"),
        "n_blocks": len(blocks),
        "k_hist": {int(u): int(n) for u, n in zip(uniq, cnt)},
        "duration": mb["duration"],
        "duration_ref_metric": mb["duration_ref_metric"],
    }
    print(json.dumps(out))
    return out


def suite(q: int = Q) -> dict:
    from slam_decomposition_torch.transpile import library

    return {
        "QFT": lambda s: library.qft(q),
        "QV": lambda s: library.qv(q, seed=s),
        "VQE(Full)": lambda s: library.vqe_full(q, seed=s),
        "VQE(Linear)": lambda s: library.vqe_linear(q, seed=s),
    }


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("circuits", nargs="*")
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--qubits", type=int, default=Q)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    gens = suite(a.qubits)
    rows = [diagnose(name, gens[name], a.seeds, a.device) for name in a.circuits or list(gens)]
    write_json("parity_diagnostics.json", rows)
    return rows


if __name__ == "__main__":
    main()
