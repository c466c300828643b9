"""Times of the LM and polish kernels by iteration count, on one CUDA card.

    python -m slam_decomposition_torch.tools.time_iters [--targets N ...] [--restarts R]
        [--lanes N ...] [--reps R] [--ks K ...] [--adam-ks K ...] [--adam-targets N] [--sass]

For k = 2 and 3 (or the depths given with --ks), at the main path's shapes
(40000 f32 lanes into lm_chain, the best restart of each of 10000 targets
into polish_chain; --targets N ... and --restarts R give other target
counts, the LM then on N x R lanes: 16384 x 5 is a sixteenth-iSwap chunk,
500 x 5 the depth runs') and at any further polish lane counts given with
--lanes, the milliseconds of one launch with 0, 1, ... iterations: the
median of R launches between CUDA events after a warm one. A launch with 0
iterations loads the lane, takes one residual and stores; the step from one
count to the next is one more iteration on every lane (one that rebuilds J
wherever the step before was accepted), then the bound of the full count
(utils/mfu.py, J rebuilt as often as this run's accepted steps ask) and
the share of it the launch reaches. With --adam-ks, adam_chain's
milliseconds for the 100-step schedule at each of those depths on
--adam-targets targets x 4 restarts, per lane, and against its bound
(utils/mfu.py adam_launch); at a depth with an instance (k <= 12) also
the depth-generic program's time on the same lanes. The generic program
has no switch to leave a phase out: its split comes from timing copies of
the tree with a phase cut (PERF.md section 6). With --sass, each kernel
instance's SASS instruction count (cuobjdump). Prints the card's name and
power limit first, then the build's seconds (0.0 when the library was
built before) and the depth-generic programs' registers. A variant tree
is timed by running this module from that tree in the same command.
"""

from __future__ import annotations

import argparse
import ctypes
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


def bound_text(bound: dict, ms: float) -> str:
    return f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), the full count {bound['bound_ms'] / ms:.1%} of it"


def adam_generic(x0, t32, g32, sched):
    """adam_chain's depth-generic program (its C entry, which the wrapper
    takes from k = 13) at any depth."""
    from slam_decomposition_torch.ops import _build

    out = torch.empty_like(x0)
    p = _build.ptr
    _build.launch(None, "slam_adam_chain_generic", p(x0), p(t32), p(g32), p(sched),
                  ctypes.c_int(sched.shape[0]), ctypes.c_int(g32.shape[0]), ctypes.c_int(len(x0)), p(out), None)
    return out


def main(argv) -> int:
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import best_restart, fresh_iterations, kernel_inputs
    from slam_decomposition_torch.utils import mfu

    ap = argparse.ArgumentParser(description="times of lm_chain and polish_chain by iteration count")
    ap.add_argument("--targets", type=int, nargs="*", default=[CHUNK],
                    help="target counts: the LM on targets x restarts lanes, the polish on targets")
    ap.add_argument("--restarts", type=int, default=RESTARTS, help="restarts a target")
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
    from slam_decomposition_torch.ops import _build

    info = _build.build()
    print(f"build {info['seconds']:.1f} s nvcc -> {info['path'].name}")
    for entry, r in sorted(_build.ptxas_summary(info["ptxas"]).items()):
        if "gen" in entry:  # the depth-generic programs
            print(f"ptxas {entry}: {r.get('registers')} registers, {r.get('spill_stores')} B spill stores")
    if args.sass:
        for entry, n in sorted(_build.sass_instructions().items()):
            print(f"sass {entry}: {n} instructions")
    for k in args.adam_ks:
        g64, g32, T, t32, x0, sched = kernel_inputs(k, args.adam_targets, RESTARTS, dev).values()
        ms = median_ms(lambda: ck.adam_chain(x0, t32, g32, sched), args.reps)
        print(f"adam_chain k={k} L={len(x0)} {sched.shape[0]} steps: {ms:.3f} ms, {1e6 * ms / len(x0):.3f} ns a lane; "
              + bound_text(mfu.adam_launch(k, len(x0), sched.shape[0]), ms))
        o = _build.occupancy("adam_chain", k, generic=True)
        print(f"adam_chain k={k} depth-generic program: {o['lanes']} lanes a block, {o['smem']} B of shared memory a "
              f"block, {o['blocks']} resident blocks = {o['warps']} warps an SM (room for {o['room']} by shared memory)")
        if k <= max(ck.INSTANCE_KS):  # the depth-generic program's C entry at the same depth
            ms_g = median_ms(lambda: adam_generic(x0, t32, g32, sched), args.reps)
            print(f"adam_chain k={k} L={len(x0)} depth-generic program: {ms_g:.3f} ms, {ms_g / ms:.2f}x the instance")
    for k in args.ks:
        for j, lanes in enumerate([*args.targets, *args.lanes]):
            g64, g32, T, t32, x0, sched = kernel_inputs(k, lanes, args.restarts, dev).values()
            xa = ck.adam_chain(x0, t32, g32, sched)
            if j < len(args.targets):
                ms = [median_ms(lambda: ck.lm_chain(xa, t32, g32, i), args.reps) for i in range(ck.LM32_ITERS + 1)]
                fresh = fresh_iterations(ck.lm_chain, xa, t32, g32, ck.LM32_ITERS)
                print(f"lm_chain k={k} L={len(xa)} ms at 0..{ck.LM32_ITERS} iterations: "
                      + " ".join(f"{m:.3f}" for m in ms) + "; "
                      + bound_text(mfu.lm_launch(k, len(xa), ck.LM32_ITERS, fresh), ms[-1]))
            xl, fl = ck.lm_chain(xa, t32, g32)
            xb = best_restart(xl, fl, args.restarts)
            ms = [median_ms(lambda: ck.polish_chain(xb, T, g64, i), args.reps) for i in range(ck.LM_ITERS + 1)]
            fresh = fresh_iterations(ck.polish_chain, xb, T, g64, ck.LM_ITERS)
            print(f"polish_chain k={k} L={lanes} ms at 0..{ck.LM_ITERS} iterations: " + " ".join(f"{m:.3f}" for m in ms)
                  + "; " + bound_text(mfu.polish_launch(k, lanes, ck.LM_ITERS, fresh), ms[-1]))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
