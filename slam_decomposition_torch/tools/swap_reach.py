"""How often the targeted descents of the iSwap k=2 extended coverage reach
the SWAP vertex, by the source of their starts.

    python -m slam_decomposition_torch.tools.swap_reach [--seeds 100 130] [--device cuda]

For each seed, the 6 descents toward SWAP that ``explore.smush_volume.
extend_coverage("iSwap")`` runs at k = 2 (250 Adam steps from starts uniform
in +-4 pi): the closest any iterate comes to SWAP's Weyl coordinates, once
from the JAX package's draw (``ops.threefry.uniform``, as the port draws)
and once from a ``torch.Generator`` at the same seed. Whether one comes
within ~1e-5 decides the row's SWAP flag in extended_results.json. Prints
each seed and, per source, the share within 1e-5.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from slam_decomposition_torch.config import resolve_device
from slam_decomposition_torch.explore import smush_volume as sv
from slam_decomposition_torch.ops import threefry

RESTARTS, BOUND, NEAR = 6, 4 * np.pi, 1e-5


def closest_to_swap(x0: np.ndarray, device) -> float:
    gc, gg, t, _ = sv.NAMED_GATES["iSwap"]
    cs = sv.targeted_coords_from(gc, gg, t, 2, torch.as_tensor(x0).to(device), iters=250)
    # the five vertices' descents, vertex-major: SWAP's are the third block
    per = RESTARTS * 251
    return float(np.linalg.norm(cs[2 * per : 3 * per] - 0.5, axis=1).min())


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs=2, default=[100, 130], help="seed range [lo, hi)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    _, n = sv._smush_eval(*sv.NAMED_GATES["iSwap"][:3], 2)
    shape = (len(sv._vertex_targets()), RESTARTS, n)
    near = {"jax": [], "torch": []}
    for seed in range(*args.seeds):
        gen = torch.Generator().manual_seed(seed)
        starts = {
            "jax": threefry.uniform(seed, shape, -BOUND, BOUND),
            "torch": ((torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * BOUND).numpy(),
        }
        d = {src: closest_to_swap(x0, dev) for src, x0 in starts.items()}
        for src in near:
            near[src].append(d[src] < NEAR)
        print(f"seed {seed}: closest to SWAP from the JAX draw {d['jax']:.3e}, from a torch.Generator {d['torch']:.3e}")
    for src, hits in near.items():
        print(f"{src} draws: {sum(hits)} of {len(hits)} seeds within {NEAR:g} of SWAP")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
