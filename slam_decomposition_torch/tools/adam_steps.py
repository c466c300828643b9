"""How far the Adam kernel and its plain version drift apart, step by step,
on one CUDA card.

    python -m slam_decomposition_torch.tools.adam_steps [--ks K ...] [--targets N] [--restarts R]
        [--drives G1 G2] [--steps S ...]

For the depth-k chain of sqiSwap (or of conversion_gain_gate(0, 0, G1, G2,
1) with --drives) at the inputs of tools/inputs.kernel_inputs, prints after
each step count S the share of lanes on which adam_chain's x lies within
5e-5 of the plain adam_chain_ref's x, the largest such distance, and the
share within the plain result's one-ulp spread where that is larger
(tools/inputs.adam_ulp_spread). The plain version runs once, to the
largest S, and is read after every step; the kernel runs once per S. These
are the readings that the Adam parity checks' step counts rest on. Prints
the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

ATOL = 5e-5


def main(argv) -> int:
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import adam_ulp_spread, kernel_inputs

    ap = argparse.ArgumentParser(description="adam_chain against its plain version by step count")
    ap.add_argument("--ks", type=int, nargs="*", default=[13, 48, 79])
    ap.add_argument("--targets", type=int, default=500)
    ap.add_argument("--restarts", type=int, default=5)
    ap.add_argument("--drives", type=float, nargs=2, default=None, help="g1 g2 of a conversion-gain gate")
    ap.add_argument("--steps", type=int, nargs="*", default=[1, 2, 3, 5, 8, 10, 15, 20, 25])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("adam_steps: CUDA is not available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    gate = None if args.drives is None else gates.conversion_gain_gate(0, 0, *args.drives, 1)
    chain = "sqiswap" if gate is None else f"cg({args.drives[0]:.6f}, {args.drives[1]:.6f})"
    steps = sorted(args.steps)
    for k in args.ks:
        _, g32, _, lanes_t, x0, sched = kernel_inputs(k, args.targets, args.restarts, dev, gate).values()
        trail = []
        ck.adam_loop(lambda x: ck.square_cost(x, lanes_t, g32), x0, sched[:steps[-1]],
                     project=lambda x: trail.append(x) or x)
        for s in steps:
            ss = sched[:s].contiguous()
            d = (ck.adam_chain(x0, lanes_t, g32, ss) - trail[s - 1]).abs().amax(1)
            spread = adam_ulp_spread(x0, lanes_t, g32, ss, trail[s - 1]).clamp_min(ATOL)
            print(f"[adam_steps] {chain} k={k} L={x0.shape[0]} steps={s}: within {ATOL:g} "
                  f"{(d <= ATOL).double().mean().item():.5f}, max|dx| {d.max().item():.3e}, "
                  f"within the one-ulp spread {(d <= spread).double().mean().item():.5f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
