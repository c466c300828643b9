"""Times of the LM and polish kernels by iteration count, on one CUDA card.

    python -m slam_decomposition_torch.tools.time_iters [--lanes N ...] [--reps R] [--ks K ...]
        [--adam-ks K ...] [--adam-targets N] [--sass]

For k = 2 and 3 (or the depths given with --ks), at the main path's shapes
(40000 f32 lanes into lm_chain, the best restart of each of 10000 targets
into polish_chain) and at any further polish lane counts given with
--lanes, the milliseconds of one launch with 0, 1, ... iterations: the
median of R launches between CUDA events after a warm one. A launch with 0
iterations loads the lane, takes one residual and stores; the step from one
count to the next is one more iteration on every lane (one that rebuilds J
wherever the step before was accepted). With --adam-ks, adam_chain's
milliseconds for the 100-step schedule at each of those depths on
--adam-targets targets x 4 restarts, and per lane; with --sass, each kernel
instance's SASS instruction count (cuobjdump). Prints the card's name and
power limit first. A variant tree is timed by running this module from that
tree in the same command.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

import torch

CHUNK, RESTARTS = 10_000, 4


def median_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return statistics.median(out)


def main(argv) -> int:
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import best_restart, kernel_inputs

    ap = argparse.ArgumentParser(description="times of lm_chain and polish_chain by iteration count")
    ap.add_argument("--lanes", type=int, nargs="*", default=[], help="further polish lane counts")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--ks", type=int, nargs="*", default=[2, 3], help="depths of the LM and polish timings")
    ap.add_argument("--adam-ks", type=int, nargs="*", default=[], help="depths of the adam_chain timings")
    ap.add_argument("--adam-targets", type=int, default=2500, help="targets of the adam_chain timings")
    ap.add_argument("--sass", action="store_true", help="print the SASS instruction count of every instance")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_iters: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    if args.sass:
        from slam_decomposition_torch.ops import _build

        for entry, n in sorted(_build.sass_instructions().items()):
            print(f"sass {entry}: {n} instructions")
    for k in args.adam_ks:
        g64, g32, T, t32, x0, sched = kernel_inputs(k, args.adam_targets, RESTARTS, dev).values()
        ms = median_ms(lambda: ck.adam_chain(x0, t32, g32, sched), args.reps)
        print(f"adam_chain k={k} L={len(x0)} {sched.shape[0]} steps: {ms:.3f} ms, {1e6 * ms / len(x0):.3f} ns a lane")
    for k in args.ks:
        for lanes in [CHUNK, *args.lanes]:
            g64, g32, T, t32, x0, sched = kernel_inputs(k, lanes, RESTARTS, dev).values()
            xa = ck.adam_chain(x0, t32, g32, sched)
            if lanes == CHUNK:
                ms = [median_ms(lambda: ck.lm_chain(xa, t32, g32, i), args.reps) for i in range(ck.LM32_ITERS + 1)]
                print(f"lm_chain k={k} L={len(xa)} ms at 0..{ck.LM32_ITERS} iterations: "
                      + " ".join(f"{m:.3f}" for m in ms))
            xl, fl = ck.lm_chain(xa, t32, g32)
            xb = best_restart(xl, fl, RESTARTS)
            ms = [median_ms(lambda: ck.polish_chain(xb, T, g64, i), args.reps) for i in range(ck.LM_ITERS + 1)]
            print(f"polish_chain k={k} L={lanes} ms at 0..{ck.LM_ITERS} iterations: " + " ".join(f"{m:.3f}" for m in ms))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
