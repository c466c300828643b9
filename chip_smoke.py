"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (more for the build report):
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: compile the CUDA kernels from slam_decomposition_torch/csrc with
     nvcc, print the build seconds, ptxas registers / spills and the
     resident blocks and warps per SM (CUDA occupancy calculator) of the
     eigenphase kernel and of each chain kernel instance (Adam with and
     without the cost, the LM and the polish at k = 1..12: 48 instances;
     and the depth-generic programs, in which k is a runtime argument:
     Adam's two a layer bucket (ADAM_GEN_BUCKETS, with and without the
     cost), the LM's and the polish's one a slot bucket (LM_GEN_BUCKETS)
     and their gate-list kernels; at k = 12 and at depth_deep()'s deep
     depths to 79, with their lanes a block) with its
     shared memory a block, static or dynamic; every instance must build
     without spills and with no stack frame beyond the math library's sincos
     scratch, and keep 12 warps per SM resident, or every block its shared
     memory leaves room for where that is fewer (at least one; the generic
     programs: every block of their bucket's register cap of lanes an SM);
  3. kernel parity: each kernel against its plain PyTorch version on the
     same inputs at the main path's shapes (40000 f32 lanes = 10000
     targets x 4 restarts for Adam and LM, 10000 f64 lanes for the
     polish), at k=2 and k=3, with times of both after one warm call, and
     each instance's FLOPs, bound and share of the bound from the port's
     flop model (slam_decomposition_torch/utils/mfu.py) at those shapes;
     the Adam instance that also returns the square cost must return the
     default instance's x bit for bit and the plain square cost of that x;
     then, at k = 12 on 500 targets x 5 restarts, the depth-generic
     programs (their C entries, which the wrappers take from k = 13)
     against the k = 12 instances, within the same limits, both timed;
     then the magic-basis eigenphase kernel (csrc/weyl_coords.cu) on
     haar_sample(100000, seed=456): its phases mod 2 pi and its monodromy
     representatives within 1e-12 of the plain chain's on the CPU, the
     sqiSwap set's k of every target the CPU's (histogram {2: 79029,
     3: 20971}) at one launch a KS_CHUNK, timed against its bound and the
     plain chain on the card;
  4. main path: slam_decomposition_torch.pipeline.decompose_haar at
     B=100000, chunk=10000, restarts=4, thresh=1e-10, seed=456, which must
     give the k histogram {2: 79029, 3: 20971}, certify every target at
     square cost <= 1e-10, launch every chain kernel once per chunk it
     solves (warm-up, k buckets and rescue rounds) and the eigenphase
     kernel once per KS_CHUNK of its two k assignments (warm-up, batch);
  5. transpile path, counted like the main path:
     (a) QFT-64 (2048 blocks): the sqiSwap count histogram, then
     slam_decomposition_torch.transpile.passes.pass_manager_basic(qft(64),
     "sqiswap", 0.25) batched on the card and as the host loop, each run
     twice (warm, then timed), against the JAX package's durations and gate
     counts, with no host fallback and one polish launch per k-class; the
     timed batched pass's emitted steps re-certified on the host;
     (b) batched synthesis of haar_sample(100000, seed=456): the count
     histogram, every block's steps against its target, the host fallback
     under its limit, two polish launches, and the warm seconds per stage;
     after each of (a) and (b), the polish kernel against its plain version
     on the analytic init's seeds of each k-class (1275 / 32 and 79029 /
     20971 lanes), with phase 3's tolerances and outside the counted runs;
  6. TemplateOptimizer API, counted like the main path (the README's first
     quick-start with the port's import path): sqiSwap templates,
     objective "square", spanning_range [2, 3], 5 restarts, on
     haar_sample(100000, seed=456). The three kernels must run and the
     general solver must not; a target solved at depth 2 must have monodromy
     depth 2 or lie within 2e-5 of the depth-2 region; every reported loss
     <= 1e-10 is confirmed by the f64 cost of its parameters; the success
     share must reach API_SUCCESS_MIN; the launches must be one per chunk
     solved; then the kernels against their plain versions at one chunk's
     lanes (81920 f32, 16384 f64) with phase 3's limits;
  7. the quarter-iSwap basis, conversion_gain_gate(0, 0, 0, pi/8, 1), whose
     templates run to depth 6, counted like the main path: the monodromy
     depths of haar_sample(100000, seed=456) on the card, equal to the
     CPU's, then TemplateOptimizer over spanning_range [2..6] with each
     target's own range (its depth to 6), 5 restarts: every depth on the
     kernels, one launch of each per chunk solved at each depth, the success
     share at least its limit (QUARTER_ISWAP), every loss <= 1e-10 confirmed
     in f64, the seconds per depth; then the depth-5 chain through the
     kernels against the general solver from the same starts, restart by
     restart, and the kernels against their plain versions at the lanes the
     depth-5 and depth-6 runs launched;
  8. the eighth-iSwap basis, conversion_gain_gate(0, 0, 0, pi/16, 1), whose
     templates run to depth 12, as phase 7 (EIGHTH_ISWAP): the depths of the
     100000 targets on the card equal to the CPU's, the optimizer over each
     target's range (its depth to 12) with every depth 2..12 on the kernels,
     the chain through both solver paths at depth 8 (1000 depth-8 targets)
     and depth 10 (500 targets of depth 9 or 10), and the kernels against
     their plain versions at the lanes the depth-8, 10 and 12 runs launched
     (a chunk's at most);
  9. the sixteenth-iSwap basis, conversion_gain_gate(0, 0, 0, pi/32, 1),
     whose templates run to depth 24, as phase 7 (SIXTEENTH_ISWAP): four in
     five targets at depth 13 or more, on the depth-generic programs; the
     seconds the optimizer spends drawing starts on the host; the chain
     through both solver paths at depth 13 (1000 depth-13 targets) and depth
     16 (500 targets of depth 15 or 16), and the kernels against their
     plain versions at the lanes the depth-13 and 22 runs launched;
 10. the coverage engine (host code; coordinates on the card): (a) the
     sqiSwap and quarter-iSwap sets built without their caches, each
     equal row for row to the JAX package's cached pickle (operations,
     cost, every convex subpolytope's exact rows and name), each build's
     seconds printed, and the main path's depth histogram over the built
     sqiSwap set; (b) the parallel-drive basis conversion_gain_gate(0, 0,
     pi/8, pi/4, 1), both drives on, which has no cache: the port's own
     cached build deleted, the set built from nothing (4 entries, depths
     0..3), its expected cost within 1e-12 of the JAX package's, then the
     optimizer over it as phase 7 (PARALLEL_DRIVE: depths 2 and 3, whose
     gates have all 8 nonzeros), and MixedOrderBasisTemplate's cost of the
     100000 targets equal to the sum of their depths;
 11. depths: spanning_range [1, 2, 3] on sqiSwap, iSwap, CNOT and SWAP tiled
     to 1000 targets (cycles 1, 2, 2, 3), the CNOT basis at depth 3 on
     haar_sample(10000, seed=2), depths 4 to 12 and 13, 16, 20, 24, 32, 48,
     64, 79 on 500 Haar targets on the kernels (13..79: the depth-generic
     programs) and depth 80 routed to the general solver by rule (no solve;
     the path of every depth is printed), every run at exactly one launch of
     each kernel per chunk, and the kernels against their plain versions at
     these runs' lanes (K = 1 at 5000 / 1000, the CNOT chain's K = 3 at
     50000 / 10000, K = 4..16 and 79 at 2500 / 500) with phase 3's limits;
 12. general solver on the card: the reduced and Makhlin objectives at depth
     3 on 10000 Haar targets, L-BFGS on the CNOT basis (2000 targets x 5
     restarts), a free conversion-gain gate under bounds reaching CNOT at
     depth 1 from 256 restarts, and the chain template forced through the
     general solver against the kernel path from the same starts, restart
     by restart;
 13. the driven (Trotter) path, counted like the main path, each part with
     its seconds, launches, general-solver calls, path and peak memory:
     (a) smush_u, evolve_smush and smush_prefix_unitaries on the card
     against the CPU's f64 at 1e-12, the prefix products by log-depth
     doubling against the running product (both timed), the device kernels
     of one driven evaluation, Adam step and LM iteration at 32 lanes
     (torch.profiler), and sample_smush_coords on the iSwap cycle at k = 1,
     2, 3 (3000 samples each, timed); (b) improved_cx at seed 0, 32
     restarts: certified <= 1e-10 on the general solver, its locals
     rebuilding CNOT within trace infidelity 1e-10; (c) improved_swap(
     exact=True), 16 restarts: certified on the chain kernels at K = 3, one
     launch of each, then the kernels against their plain versions at those
     lanes with phase 3's limits; (d) the golden improved_swap_2pulse.json
     through evaluate_drive_sequence, < 1e-10; (e) improved_swap_two_pulse
     at seed 0, certified and rebuilding SWAP (improved_swap()'s [1.0, 0.5]
     plan, ~1e-5 by design, is phase 15's m = 2 class fit); (f) VSWAP from
     hamiltonian_ansatz(circulator_u, 7) through TemplateOptimizer, loss <
     1e-8; (g) GRAPE on CNOT: the hs functional (8 restarts x 300
     iterations, 8 slices, printed) and the li functional (8 x 400, 16
     slices: value < 1e-3, CNOT's coordinates within 0.05); (h)
     extend_coverage(save=False) of iSwap and B: every row's
     cnot / swap / b flags equal to slam_decomposition_tpu/data/
     extended_results.json, the exact base volume within 1e-9, the extended
     volume within 0.02 or the JAX package's own spread over three seeds
     where wider (EXT_VOL_SPREAD), the seconds per gate;
 14. the speed-limit transpilation path, counted like the main path: (a)
     each kernel against its plain version on the chain of the winner
     conversion_gain_gate(0, 0, pi/80, 0.2375 pi, 1) (both drives on) at
     the lanes QFT-64's fit launches (K = 2: 1350 targets x 8 restarts, K =
     4: 32 x 8) with phase 3's limits; (b) explore.winners.pick_winner of
     the linear speed limit at duration_1q 0 and 0.25 equal to the JAX
     package's winners, scaled durations and scores; (c)
     transpile.passes.pass_manager_slam(qft(64), duration_1q=0.25,
     fit_1q=True) cold and warm: duration 190.75 and the JAX gate counts,
     one launch of each kernel per structure group (2 groups), each group's
     fitted blocks no fewer than the JAX package's less 1% of the group,
     every fitted block rebuilding its block's unitary within 1e-9, the
     wall clock of both runs; (d) the headline rows (tools/headline.py):
     SWAP 2.5 -> 2.25, VQE(Linear)-16 routed on the 4x4 grid at seed 0
     25.75 -> 21.5, and the protocol cut to 1 x 1 route seed and 20 Haar
     targets equal to the JAX package's values;
 15. the parallel-drive pass with its driven fit, counted like the main
     path: (a) transpile.passes.pass_manager_optimized_sqiswap(qft(64),
     duration_1q=0.25, fit_1q=True) cold and warm: the blocks by path (exact
     path, class fit per pulse count m, the exact 3-segment fallback,
     placeholders) against the port's own CPU run of the same call (PD_SPLIT:
     the exact path equal, each class fit no fewer than the CPU's less 1% of
     its group, the placeholders no more than the CPU's plus 3% of its
     fallback blocks), every fitted block rebuilding its
     block's unitary within 1e-9, the duration analysis, the wall clock and
     each stage's seconds, the fallback at one launch of each kernel and the
     class fits' general-solver calls, the peak device memory; (b) each
     kernel against its plain version on the fallback's chain (three
     zero-drive sqiSwap-time pulses, K = 3) at its lanes (fallback blocks x
     16) with phase 3's limits; (c) QV-16 routed on the 4x4 grid at seed 0,
     once, with (a)'s checks (class fits at m = 1 and 2); (d)
     tools/certify_frontier.certify_row("B", 1, 32): its certified fraction
     beside the JAX package's 0.96 at n = 100, and every certified loss
     equal to the CPU's f64 Makhlin functional of the returned x within
     1e-12;
 16. the mesh (parallel/), counted like the main path: (a)
     pipeline.decompose_haar(B=100000, seed=456, mesh=make_mesh(1)) on a
     one-rank NCCL group started in this process: the k histogram, 100000
     certified, the losses equal bit for bit to phase 4's unsharded call,
     per solved chunk one launch of Adam and of the LM and two of the polish
     (the local winner's zero-iteration one and the polisher's), the stage
     times and the group's start-up; (b)
     graft_entry.dryrun_multichip(MESH_RANKS = 4): four spawned ranks on this
     card over gloo, dp = 2, rp = 2, every check of the multi-chip dry run in
     every rank (>= 0.5 certified in the production stage at B = 2048, R =
     4, certified sets agreeing >= 0.999 with the unsharded solver, the
     sharded ks equal to monodromy_ks_batch at B = 10240), each rank's
     device, backend, lanes and launches printed and its launches added to
     the counted runs'; (c) graft_entry.entry(): one batched cost and
     gradient on the card, finite; (d) outside the counted runs, the kernels
     at the mesh's shapes against their plain versions, timed: the
     zero-iteration polish at (a)'s 10000 lanes and (b)'s 1024, and (b)'s
     production shard (2048 Adam and LM lanes, 1024 polish lanes) with
     phase 3's limits;
 17. the studies (tools/ ported from the JAX package's scripts), counted
     like the main path: (a) make_solver(..., top_m=2) on one chunk of
     10000 targets of each depth k = 2, 3 of phase 4's haar_sample(100000,
     seed=456), R = 4: one launch of Adam's cost instance, of the LM at
     10000 x 2 lanes and of the polish a k, every loss the f64 square cost
     of its x, top_m=4 (= R) equal to top_m=None bit for bit, each k's
     certified share and seconds at top_m 0 and 2; then, on the same inputs,
     Adam's cost instance at the 40000 lanes and the LM at the 20000 kept
     lanes against their plain versions with phase 3's limits; (b)
     tools/profile_solver.profile at B = 1000, k = 2: the phase split by
     subtraction beside the kernels' own CUDA-event times; (c)
     tools/bench_analytic.bench at CH = 10000: the variational solve, the
     analytic init + polish and the init alone, timed, with the certified
     counts and every loss the f64 cost of its x;
 18. result: a JSON line of the kernels (launches summed over the counted
     runs of phases 4 to 17, the mesh ranks' included) and the whole run's
     seconds, then the device line.

Phase 3's Adam limit (5e-5 after 25 steps on 99.5% of lanes) was read at
n <= 78. The depth-generic programs (depth 13 on) are held after
ADAM_GENERIC_ITERS steps instead, and a lane counts within the limit where
the kernel lies within 5e-5 of the plain version, or within the plain
result's own shift under a one-ulp move of its start where that is larger:
on deep chains Adam's normalised step turns f32 rounding of a near-zero
gradient component into a full step, in the plain version as much as in
the kernel (tools/inputs.adam_ulp_spread; the lane shares within 5e-5 alone
are printed beside it), and past ~25 steps at n >= 390 the spread itself
no longer bounds what rounding does (tools/adam_steps.py, PERF.md section 6).

Any failure exits non-zero before the result lines. There is no CPU path:
without CUDA the script exits with status 1.
"""

import ctypes
import json
import math
import re
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

B, CHUNK, RESTARTS, THRESH, SEED = 100_000, 10_000, 4, 1e-10, 456
WANT_HIST = {2: 79029, 3: 20971}
REPLACES = {
    "adam_chain": "slam_decomposition_tpu/ops/pallas_chain.py:753",
    "lm_chain": "slam_decomposition_tpu/ops/pallas_chain.py:299",
    "polish_chain": "slam_decomposition_tpu/ops/pallas_chain.py:611",
}
SOURCES = {
    name: f"slam_decomposition_torch/csrc/{name}.cu" for name in REPLACES
}
# the depth-generic programs (K = 13..79), which the entry points above hand deep chains to
GENERIC_SOURCES = {name: f"slam_decomposition_torch/csrc/{name}_generic.cu" for name in REPLACES}
# every kernel wrapper whose launches the run sums (ops/_build.WRAPPERS)
COUNTED = (*REPLACES, "gamma_eigenphases")
# the generic LM's and polish's slot buckets (csrc/lm_generic.cuh lm_gen_bucket): one kernel each
LM_GEN_BUCKETS = (3, 4, 8, 16)
# the generic Adam's layer buckets (csrc/adam_generic.cuh adam_gen_bucket), each
# with its register cap of lanes an SM (adam_gen_lanes_cap): two kernels each
ADAM_GEN_BUCKETS = {1: 40, 2: 32, 3: 32, 4: 24, 5: 24}


def adam_gen_lanes_cap(k):
    """The lanes an SM that the generic Adam's register budget holds at
    depth k: its layer bucket's cap (layers t, t + 16, ... a thread)."""
    return ADAM_GEN_BUCKETS[(k + 16) // 16]


def lm_gen_lanes_cap(k):
    """The lanes an SM that the generic LM's and polish's register budget
    holds at depth k (csrc/lm_generic.cuh lm_gen_lanes_cap: 8 to the
    8-slot bucket, K <= 41, then 4)."""
    return 8 if (6 * (k + 1) + 31) // 32 <= 8 else 4
# stated tolerances (see each check for the reason; the readings they were
# set from are in PERF.md)
ADAM_PARITY_ITERS, ADAM_ATOL, ADAM_LANE_FRAC = 25, 5e-5, 0.995
# the depth-generic programs' Adam lanes, within the one-ulp spread: after 5
# steps 0.99920-1.00000 of lanes at every depth 13..79 read; after 25, 0.98720
# at K = 79 (tools/adam_steps.py, PERF.md section 6). Their later steps are
# held lane by lane over 25 steps against the K = 12 instance
# (phase_generic_vs_instance)
ADAM_GENERIC_ITERS = 5
ADAM_COST_FRAC_TOL = 0.01
ADAM_WITH_COST_ATOL = 1e-5  # the kernel's f32 cost against the plain f32 cost of its x
# bytes of stack frame an instance may have: the scratch of sincosf's / sincos's
# slow-path range reduction (32 / 72 B; with those two calls replaced every
# instance builds with a 0 B frame, PERF.md section 6), no array of the kernels'
STACK_MAX = 72
LM_RTOL, LM_ATOL, LM_LANE_FRAC = 1e-3, 1e-5, 0.99
POLISH_VERDICT_FRAC, POLISH_COST_ATOL, POLISH_COST_FRAC, CERT_ATOL = 0.999, 1e-11, 0.995, 1e-13
# transpile phase. QFT-64's reference values are the JAX package's own
# (pass_manager_basic on its CPU backend, command in PERF.md): the host loop
# emits 2722 sqiSwaps; the batched path counts the 38 blocks cp(pi/2^26)
# (chamber x = 7.5e-9, under the count's 1e-8 identity tolerance) as k=0
# and emits them as certified products, hence 2646 there, in both packages
# (tests/test_torch_transpile.py::test_tiny_cp_blocks_take_the_product_path)
QFT_Q, QFT_BLOCKS, QFT_HIST, QFT_DURATION = 64, 2048, {0: 741, 2: 1275, 3: 32}, 190.0
QFT_GATES_HOST = {"u1q": 5508, "riswap": 2722}
QFT_GATES_BATCHED = {"u1q": 5356, "riswap": 2646}
SYNTH_ATOL = 1e-10  # the host routine's trace-infidelity bar (transpile/kak.py)
SYNTH_FALLBACK_MAX = 10  # host fallbacks allowed in the Haar batch (PERF.md)
# the API, depth and general-solver phases (sizes here so that a rehearsal
# on the CPU can shrink them; the limits' readings are in PERF.md)
API_RESTARTS = 5  # the optimizer's default
API_SUCCESS_MIN = 0.999  # share of the 100000 targets solved at <= 1e-10
# A target within ~1e-5 of the depth-2 region has a depth-2 circuit at cost <=
# 1e-10 (the cost is quadratic in the distance) although its exact depth is 3:
# such a target may be solved at depth 2 if |c3| - (c1 - c2) in the folded
# chamber, which the depth-2 region bounds by 0, is at most this (read 4.25e-06
# at three seeds of the starts: the same two targets)
API_BOUNDARY_SLACK = 2e-5
DEPTH_TILE, DEPTH_CNOT_B, DEPTH_CNOT_MIN, DEPTH_DEEP_B = 250, 10_000, 0.99, 500
# share of a gate's copies solved at its least depth: sqiSwap's at depth 1
# read 246, 245, 249 of 250 at three seeds, the others 250 of 250
DEPTH_LEAST_MIN = (0.96, 0.99, 0.99, 0.99)
GENERAL_CLASS_B, GENERAL_CLASS_THRESH, GENERAL_CLASS_MIN = 10_000, 1e-9, 0.99
GENERAL_LBFGS_B, GENERAL_LBFGS_MIN = 2000, 0.99
GENERAL_V2_RESTARTS = 256
GENERAL_CHAIN_B, GENERAL_VERDICT_FRAC = 2000, 0.99
# depths 4 to 12 and eight of 13..kMaxK on 500 Haar targets on the kernels
# (1..12 as template instances, 13..kMaxK through the depth-generic
# programs), the last the deepest chain whose blocks fit in shared memory
# (csrc/chain_common.cuh kMaxK = ops/chain_kernels.KERNEL_KS[-1]); and
# kMaxK + 1, a routing check only (no solve), on the general solver by rule
DEEP_KS = (*range(4, 13), 13, 16, 20, 24, 32, 48, 64)


def depth_deep():
    """DEEP_KS and kMaxK on the kernels, then kMaxK + 1 on the general
    solver: (depth, path by rule) each."""
    from slam_decomposition_torch.ops.chain_kernels import KERNEL_KS

    return (*((k, "kernels") for k in (*DEEP_KS, KERNEL_KS[-1])), (KERNEL_KS[-1] + 1, "general"))


def depth_parity():
    """The depths whose kernels are held to their plain versions at the
    depth runs' lanes: 4..16 and kMaxK (the plain versions of a deep chain
    take tens of seconds; 20, 24, 32 and 48 were cut to make room for phase
    15, and K = 64 is held by tests/test_torch_kernels.py on the card)."""
    from slam_decomposition_torch.ops.chain_kernels import KERNEL_KS

    return tuple(k for k, path in depth_deep() if path == "kernels" and (k <= 16 or k == KERNEL_KS[-1]))


class Basis(NamedTuple):
    """A conversion-gain basis phase: conversion_gain_gate(0, 0, g1, g2, 1)
    templates over ``depths`` for ``drives`` (g1, g2); ``hist`` the
    monodromy depth histogram of haar_sample(B, seed=SEED) (the port's
    monodromy_ks_batch on the CPU; the JAX package gives the same depths,
    tests/test_torch_fractional.py, tests/test_torch_eighth_iswap.py and
    tests/test_torch_coverage.py); ``success_min`` the success share's
    limit (readings in PERF.md); ``chains`` (k, targets, least depth): the
    depth-k chain through both solver paths on the first ``targets`` targets
    whose monodromy depth lies in [least depth, k]; ``parity_ks`` the depths
    whose kernels are held to their plain versions at the lanes this phase
    launched."""

    tag: str
    name: str
    drives: tuple
    depths: tuple
    hist: dict
    success_min: float
    chains: tuple
    parity_ks: tuple


QUARTER_ISWAP = Basis("frac", "quarter-iSwap", (0.0, math.pi / 8), (2, 3, 4, 5, 6),
                      {2: 756, 3: 18734, 4: 76556, 5: 3937, 6: 17}, 0.9999, ((5, 1000, 5),), (5, 6))
EIGHTH_ISWAP = Basis("eighth", "eighth-iSwap", (0.0, math.pi / 16), tuple(range(2, 13)),
                     {2: 3, 3: 88, 4: 865, 5: 4460, 6: 14074, 7: 30125, 8: 46431, 9: 3554, 10: 383, 11: 17},
                     0.9999, ((8, 1000, 8), (10, 500, 9)), (8, 10, 12))
# depths 4..22 (the JAX package's too, tests/test_torch_sixteenth_iswap.py);
# parity at the first generic depth, at 81920 lanes, and a small late run
# (16 and 19 cut, as 7, 9, 11 of the eighth-iSwap's, to make room for phase
# 15: phase 11 holds every depth 4..16 at its own lanes)
SIXTEENTH_ISWAP = Basis("sixteenth", "sixteenth-iSwap", (0.0, math.pi / 32), tuple(range(2, 25)),
                        {4: 4, 5: 23, 6: 64, 7: 252, 8: 613, 9: 1540, 10: 2920, 11: 5354, 12: 8720, 13: 12870,
                         14: 17255, 15: 21618, 16: 24813, 17: 2555, 18: 999, 19: 314, 20: 69, 21: 15, 22: 2},
                        0.9999, ((13, 1000, 13), (16, 500, 15)), (13, 22))
# both drives on: no cached coverage set exists, so phase_coverage builds it
# first (4 entries: the identity and depths 1..3); its depths and expected
# cost are the JAX package's (tests/test_torch_coverage.py)
PARALLEL_DRIVE = Basis("parallel", "parallel-drive", (math.pi / 8, math.pi / 4), (2, 3), {2: 95897, 3: 4103},
                       0.9999, ((3, 1000, 3),), (2, 3))
PARALLEL_EXPECTED_COST, EXPECTED_COST_ATOL = 2.041729136984176, 1e-12
# the sets phase_coverage builds without their caches and holds to them
# (quarter-iSwap: the basis of phase 7; the eighth-iSwap build, 22.5 s of
# the same code, cut to make room for phase 15)
COVERAGE_BUILDS = (("sqiswap", None), ("quarter-iSwap", (0.0, math.pi / 8)))
# the chain's restarts through both paths (tools/optimizer_readings.ranking_agreement)
RANK_LANES_MIN, RANK_SINGLE_MIN, RANK_WINNER_MIN = 0.999, 0.99, 0.999
# the driven path (phase 13): the card's f64 against the CPU's, the
# certification bars of the pulse solves, and the extended-coverage gates
DRIVEN_PARITY_ATOL = 1e-12
DRIVEN_CERT, VSWAP_LOSS_MAX = 1e-10, 1e-8
# improved_cx at seed 0 (cut from seeds 0, 1, 2 to make room for phase 15)
DRIVEN_SEEDS, DRIVEN_RESTARTS, SWAP_EXACT_RESTARTS = (0,), 32, 16
SMUSH_SAMPLES, SMUSH_SAMPLE_KS = 3000, (1, 2, 3)
# iSwap (its k=2 SWAP flag hangs on the JAX draws) and B (the cheapest), cut
# from four gates to make room for phase 15
EXTENDED_GATES = ("iSwap", "B")
# an extended volume's limit against extended_results.json: 0.02, or the JAX
# package's own spread over the seeds 7, 8, 9 where wider: CNOT k=2 reads
# 0.87186 / 0.932355 / 0.935165 (scripts/jax_extended_spread.py on the CPU;
# every other row spreads 0.0189 or less, PERF.md section 6)
EXT_VOL_ATOL = 0.02
EXT_VOL_SPREAD = {("CNOT", "2"): 0.063305}
EXT_BASE_ATOL = 1e-9  # the exact base volume against the file's

# the SLAM pass (phase 14). The JAX package's own values on the CPU (PERF.md
# section 6): the winners of the linear speed limit at duration_1q 0
# and 0.25 (parameters, scaled duration, E[Haar] score), QFT-64's duration
# and gate counts, and per group of winner applications its blocks and the
# blocks its fit certified at 1e-10 (8 restarts, seed 0)
SLAM_WINNERS = {0.0: ((0.0, 0.0, 0.0, 0.09817477042468103, 1.0), 0.0625, 0.8837168724994596),
                0.25: ((0.0, 0.0, 0.039269908169872414, 0.7461282552275759, 1.0), 0.5, 1.8524037105377018)}
SLAM_D1Q, SLAM_RESTARTS, SLAM_DURATION = 0.25, 8, 190.75
SLAM_GATES = {"u": 2984, "winner2q": 2828, "u1q": 2736}
SLAM_JAX_FITS = {2: (830, 1350), 4: (32, 32)}  # applications: (fitted, blocks)
SLAM_FIT_SLACK = 0.01  # the card may fit fewer than the JAX package by 1% of a group's blocks
SLAM_BLOCK_DIST = 1e-9  # 1 - |tr(V^dag U)| / 4 of every fitted block
# the parallel-drive pass with its driven fit (phase 15):
# transpile.passes.pass_manager_optimized_sqiswap(..., fit_1q=True) on QFT-64
# and on QV-16 routed on the 4x4 grid at seed 0. The split of the blocks by
# path in the port's own CPU run of the same calls (PERF.md section 6):
# exact path, then per pulse count m (fitted, blocks) of the class fit, then
# (fitted, blocks) of the exact 3-segment fallback
PD_D1Q = 0.25
PD_SPLIT = {
    "qft64": {"exact": 253, "class_fit": {1: (1249, 1763), 2: (0, 32)}, "fallback": (484, 546)},
    "qv16": {"exact": 1, "class_fit": {1: (102, 102), 2: (18, 109)}, "fallback": (91, 91)},
}
# the card may class-fit fewer blocks than the CPU by 1% of a group, and keep
# more placeholders after the fallback by 3% of the CPU's fallback blocks: the
# fallback's starts follow the rescue's draws, whose number follows the class
# fit's failures, so the card draws other starts than the CPU there, and a
# share of ~0.88 certified over ~546 blocks spreads by ~1.4% of them (one
# standard deviation)
PD_FIT_SLACK, PD_FALLBACK_SLACK = 0.01, 0.03
PD_BLOCK_DIST = 1e-9  # fit_substituted_pd's threshold: 1 - |tr(V^dag U)| / 4 of every fitted block
PD_RESTARTS = 16  # fit_substituted_pd's default
# certify_frontier.certify_row on B k = 1 at 32 targets, beside the JAX
# package's row (slam_decomposition_tpu/data/frontier_certification.json:
# 96 of 100 certified)
FRONTIER_ROW, FRONTIER_JAX_FRAC = ("B", 1, 32), 0.96
FRONTIER_RECOMPUTE_ATOL = 1e-12  # a certified loss against the CPU's f64 Makhlin functional of its x
# the headline protocol cut to 1 x 1 route seed and 20 Haar targets
# (slam_decomposition_torch/tools/headline.py; cut from 1 x 2 and 50 to make
# room for phase 15), the JAX package's values from
# scripts/headline_benchmarks.py main(16, 1, 1, 20) on the CPU
ZERO_POLISH_ATOL = 1e-12  # the zero-iteration polish: its x (angles mod 4 pi) and ||r||^2 against the plain version's
MESH_RANKS = 4  # phase 16 (b): ranks of the dry run, all on the one card (dp = 2, rp = 2)
TOPM_M = 2  # phase 17 (a): restarts of each target that enter the f32 LM
PROFILE_B, ANALYTIC_CH = 1000, 10_000  # phase 17 (b), (c)
HEADLINE_REDUCED = (16, 1, 1, 20)
HEADLINE_JAX = {
    "SWAP": {"basic": 2.5, "optimized": 2.25},
    "haar_avg": {"basic": 2.0125, "optimized": 1.6625},
    "QV": {"basic": 125.5, "optimized": 108.0, "basic_ref_metric": 125.5, "optimized_ref_metric": 107.75},
    "VQE(Linear)": {"basic": 25.75, "optimized": 21.5, "basic_ref_metric": 25.75, "optimized_ref_metric": 21.5},
    "VQE(Full)": {"basic": 263.5, "optimized": 226.75, "basic_ref_metric": 263.5, "optimized_ref_metric": 226.75},
    "QFT": {"basic": 135.25, "optimized": 104.7421875, "basic_ref_metric": 135.25,
            "optimized_ref_metric": 104.7421875},
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def timed_ms(fn, warm=True):
    """Result and device milliseconds of fn() after one warm call (without
    ``warm``, of its first call: the plain versions of the deep chains, one
    run of which takes seconds, after a shorter run of the same shapes)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def phase_device():
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    card = q[torch.cuda.current_device()] if len(q) > torch.cuda.current_device() else q[0]
    print(card)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
          f"{torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()})")
    return card


def phase_build():
    from slam_decomposition_torch.ops import _build
    from slam_decomposition_torch.ops.chain_kernels import INSTANCE_KS

    info = _build.build()
    print(f"[build] {info['seconds']:.1f} s nvcc -> {info['path'].name}")
    regs = _build.ptxas_summary(info["ptxas"])
    for entry, r in sorted(regs.items()):
        m = re.search(r"([a-z_]+_kernel)(?:I([fd])?(?:Li(\d+)E)?(?:Lb(\d)E)?E)?", entry)
        # lm_gen_kernel<R, SB>: the generic LM (f) or polish (d) program of slot bucket SB
        typ = {"f": "float, ", "d": "double, "}.get(m.group(2) or "", "") if m else ""
        templated = m is not None and entry[m.end(1):m.end(1) + 1] == "I"
        name = (f"{m.group(1)}<{typ}{m.group(3) or 'k'}{', cost' if m.group(4) == '1' else ''}>" if templated
                else m.group(1) if m else entry)
        print(f"[build] ptxas {name}: {r.get('registers')} registers, "
              f"{r.get('stack_frame')} B stack, {r.get('spill_stores')} B spill stores, "
              f"{r.get('spill_loads')} B spill loads")
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0 and r.get("stack_frame", 1 << 30) <= STACK_MAX,
              f"{name} spills or keeps arrays in local memory")
    # Adam with and without the cost, the LM and the polish, each at every k
    # of an instance; the generic Adam with and without the cost, the
    # generic LM and polish, once a slot bucket, and the LM's and polish's
    # two gate-list kernels; and the eigenphase kernel
    want = 4 * len(INSTANCE_KS) + 2 * len(ADAM_GEN_BUCKETS) + 2 * len(LM_GEN_BUCKETS) + 2 + 1
    check(len(regs) == want, f"expected {want} kernel instances in the ptxas report, got {len(regs)}")
    lib = _build.load()
    blocks, threads, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    err = lib.slam_gamma_eigenphases_occupancy(*map(ctypes.byref, (blocks, threads, smem)))
    check(err == 0, f"slam_gamma_eigenphases_occupancy failed: {_build.error_string(err)} ({err})")
    print(f"[build] occupancy gamma_eigenphases: {blocks.value} resident blocks x {threads.value} threads = "
          f"{blocks.value * threads.value // 32} warps per SM; {smem.value} B of static shared memory a block")
    # its launch bounds ask for 4 blocks of 128 threads (128 registers a thread)
    check(blocks.value >= 4, f"gamma_eigenphases keeps {blocks.value} blocks per SM resident, needs 4")
    generic_ks = (12, *(k for k, path in depth_deep() if path == "kernels" and k > max(INSTANCE_KS)))
    for name in REPLACES:
        for generic, ks in ((False, INSTANCE_KS), (True, generic_ks)):
            for k in ks:
                o = _build.occupancy(name, k, generic=generic)
                print(f"[build] occupancy {name}{'_generic' if generic else ''}<{k}>: {o['blocks']} resident blocks x "
                      f"{o['threads']} threads ({o['lanes']} lanes) = {o['warps']} warps per SM (room for {o['room']} "
                      f"by shared memory); {o['smem']} B of {'dynamic' if o['dynamic'] else 'static'} shared memory a block")
                # 12 resident warps, or where a block's shared memory leaves
                # room for fewer (Adam from K = 9, the polish from K = 10, the
                # generic programs' blocks of up to 227 KB), every block that
                # room holds: the registers must not cost a resident block.
                # The generic programs: every block of their bucket's register
                # cap of lanes an SM that shared memory has room for
                need = min(max(12 // (o["threads"] // 32), 1), o["room"])
                if generic:
                    cap = adam_gen_lanes_cap(k) if name == "adam_chain" else lm_gen_lanes_cap(k)
                    need = min(cap // o["lanes"], o["room"])
                check(o["blocks"] >= need, f"{name}<{k}> keeps {o['blocks']} blocks per SM resident, needs {need}")
    return regs


def bound_line(name, label, bound, ms):
    """Print and return the instance's bound against its measured time."""
    print(f"[bound] {name} {label}: {bound['flops']:.4e} flops, {bound['bytes']} B -> bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}); kernel {ms:.3f} ms = {bound['bound_ms'] / ms:.1%} of the bound")
    return bound


def phase_parity(stats, ks=(2, 3), targets=CHUNK, restarts=RESTARTS, tag="", gate=None):
    """Each kernel's depth-k instance against its plain version at ``targets``
    x ``restarts`` f32 lanes (``targets`` f64 lanes for the polish) of the
    chain of ``gate`` (default sqiSwap); fills stats[kernel] with max_abs_err
    and, under the label "k<k><tag>", lanes, ms, plain_ms and bound."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import adam_ulp_spread, best_restart, fresh_iterations, kernel_inputs
    from slam_decomposition_torch.utils import mfu

    dev = torch.device("cuda")
    for k in ks:
        g64, g32, T, lanes_t, x0, sched = kernel_inputs(k, targets, restarts, dev, gate).values()
        label = f"k{k}{tag}"
        generic = k > max(ck.INSTANCE_KS)  # the depth-generic programs; their plain runs take seconds

        # Adam: f32 association order differs, and Adam's m/sqrt(v) step
        # amplifies it on lanes whose gradient components sit near zero
        # (0.08-0.1% of lanes beyond 5e-5 after 25 steps on the H100 at
        # n <= 78, more on deeper chains), so lanes are compared after 25
        # steps with a lane fraction, and the 100-step results by their cost
        # distribution. The depth-generic programs are compared after
        # ADAM_GENERIC_ITERS steps, a lane's bound the larger of 5e-5 and the
        # plain result's own shift under a one-ulp move of its start.
        steps = ADAM_GENERIC_ITERS if generic else ADAM_PARITY_ITERS
        s_lane = sched[:steps].contiguous()
        ref_lane = ck.adam_chain_ref(x0, lanes_t, g32, s_lane)
        d = (ck.adam_chain(x0, lanes_t, g32, s_lane) - ref_lane).abs().amax(1)
        frac = frac_atol = (d <= ADAM_ATOL).float().mean().item()
        spread = ""
        if generic:
            bound = adam_ulp_spread(x0, lanes_t, g32, s_lane, ref_lane).clamp_min(ADAM_ATOL)
            frac = (d <= bound).float().mean().item()
            spread = (f", within the plain result's one-ulp spread where larger {frac:.5f} (spread beyond "
                      f"{ADAM_ATOL:g} on {(bound > ADAM_ATOL).float().mean().item():.5f} of lanes)")
        xa, ms = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched))
        xa_ref, plain_ms = timed_ms(lambda: ck.adam_chain_ref(x0, lanes_t, g32, sched), warm=not generic)
        ca = ck.square_cost(xa, lanes_t, g32)
        ca_ref = ck.square_cost(xa_ref, lanes_t, g32)
        dfrac = abs((ca < 1e-2).float().mean().item() - (ca_ref < 1e-2).float().mean().item())
        print(f"[parity] adam_chain {label} L={x0.shape[0]}: {steps} steps max|dx| {d.max().item():.3e}, "
              f"{frac_atol:.5f} of lanes within {ADAM_ATOL:g}{spread} (need >= {ADAM_LANE_FRAC}); 100 steps "
              f"|d frac(cost<1e-2)| {dfrac:.4f} (need <= {ADAM_COST_FRAC_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(frac >= ADAM_LANE_FRAC and dfrac <= ADAM_COST_FRAC_TOL, f"adam_chain {label} disagrees with its plain version")
        st = stats["adam_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], d.max().item())
        st[label] = {"lanes": x0.shape[0], "ms": ms, "plain_ms": plain_ms,
                     "bound": bound_line("adam_chain", label, mfu.adam_launch(k, x0.shape[0], sched.shape[0]), ms)}
        # the instance that also returns the square cost: the same program
        # up to the last step, so its x must be the default instance's (held
        # to the plain version above) bit for bit
        (xc, cost), ms_c = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched, with_cost=True))
        cerr = (cost - ck.square_cost(xc, lanes_t, g32)).abs().max().item()
        print(f"[parity] adam_chain with_cost {label}: max|dx| to the default instance {(xc - xa).abs().max().item():.3e} "
              f"(need 0), max|cost - plain cost of its x| {cerr:.3e} (need <= {ADAM_WITH_COST_ATOL:g}); kernel {ms_c:.3f} ms")
        check(torch.equal(xc, xa), f"adam_chain with_cost {label}: x differs from the default instance's")
        check(cerr <= ADAM_WITH_COST_ATOL, f"adam_chain with_cost {label}: cost disagrees with the plain cost of its x")

        # LM: compare ||r||^2 per lane; accept/reject decisions near the f32
        # floor may differ, hence the lane fraction (the JAX kernel test's bound)
        (xl, fl), ms = timed_ms(lambda: ck.lm_chain(xa, lanes_t, g32))
        (_, fl_ref), plain_ms = timed_ms(lambda: ck.lm_chain_ref(xa, lanes_t, g32), warm=not generic)
        ok = torch.isclose(fl, fl_ref, rtol=LM_RTOL, atol=LM_ATOL).float().mean().item()
        err = (fl - fl_ref).abs().max().item()
        print(f"[parity] lm_chain {label} L={xa.shape[0]}: max|d||r||^2| {err:.3e}, {ok:.5f} of lanes within "
              f"rtol {LM_RTOL:g} atol {LM_ATOL:g} (need >= {LM_LANE_FRAC}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        check(ok >= LM_LANE_FRAC, f"lm_chain {label} disagrees with its plain version")
        st = stats["lm_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        fresh = fresh_iterations(ck.lm_chain, xa, lanes_t, g32, ck.LM32_ITERS)
        print(f"[bound] lm_chain {label}: {fresh:.3f} of {ck.LM32_ITERS} iterations per lane rebuild J")
        st[label] = {"lanes": xa.shape[0], "ms": ms, "plain_ms": plain_ms,
                     "bound": bound_line("lm_chain", label, mfu.lm_launch(k, xa.shape[0], ck.LM32_ITERS, fresh), ms)}

        # polish from each target's best restart
        xb = best_restart(xl, fl, restarts)
        err, ms, plain_ms = polish_parity(label, xb, T, g64, warm_plain=not generic)
        st = stats["polish_chain"]
        st["max_abs_err"] = max(st["max_abs_err"], err)
        fresh = fresh_iterations(ck.polish_chain, xb, T, g64, ck.LM_ITERS)
        print(f"[bound] polish_chain {label}: {fresh:.3f} of {ck.LM_ITERS} iterations per lane rebuild J")
        st[label] = {"lanes": xb.shape[0], "ms": ms, "plain_ms": plain_ms,
                     "bound": bound_line("polish_chain", label, mfu.polish_launch(k, xb.shape[0], ck.LM_ITERS, fresh), ms)}


def polish_parity(label, x, T, g64, warm_plain=True):
    """The polish kernel against its plain version from the same x (L, n)
    f64: the certificates must give the same <= THRESH verdicts and, on
    POLISH_COST_FRAC of the lanes both certify, agree within 10% of the bar,
    and the kernel's certificate must match the true f64 cost of its x. J
    is f32 in both, so the few lanes whose LM stalls between 1e-13 and the
    bar (1 to 24 a launch, PERF.md) end wherever the rounding of J takes
    them: there the two costs have read up to 1.3e-11 apart, on every other
    lane under 1e-13. Returns (max |d cost| where both certify, kernel ms,
    plain ms)."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import certificate

    (xp, fp), ms = timed_ms(lambda: ck.polish_chain(x, T, g64))
    (_, fp_ref), plain_ms = timed_ms(lambda: ck.polish_chain_ref(x, T, g64), warm=warm_plain)
    c, c_ref = certificate(fp), certificate(fp_ref)
    verdict = ((c <= THRESH) == (c_ref <= THRESH)).double().mean().item()
    both = (c <= THRESH) & (c_ref <= THRESH)
    err = (c - c_ref)[both].abs().max().item() if both.any() else 0.0
    close = ((c - c_ref)[both].abs() <= POLISH_COST_ATOL).double().mean().item() if both.any() else 1.0
    true = ck.square_cost(xp, T, g64)
    cert = c <= THRESH
    cert_err = (c - true)[cert].abs().max().item() if cert.any() else 0.0
    print(f"[parity] polish_chain {label} L={x.shape[0]}: certified {int(cert.sum())} vs plain "
          f"{int((c_ref <= THRESH).sum())}, same verdict on {verdict:.5f} of lanes (need >= {POLISH_VERDICT_FRAC}), "
          f"max|d cost| where both certify {err:.3e}, within {POLISH_COST_ATOL:g} on {close:.5f} of those lanes (need >= "
          f"{POLISH_COST_FRAC}), certificate vs true f64 cost "
          f"{cert_err:.3e} (need <= {CERT_ATOL:g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(verdict >= POLISH_VERDICT_FRAC and close >= POLISH_COST_FRAC and cert_err <= CERT_ATOL,
          f"polish_chain {label} disagrees with its plain version")
    return err, ms, plain_ms


def phase_generic_vs_instance(stats, k=12, targets=DEPTH_DEEP_B, restarts=API_RESTARTS):
    """At depth k, where both exist, the depth-generic programs (their C
    entries: the wrappers take them from k = 13) against the depth-k
    instances on the same inputs, within phase 3's limits, both timed (one
    launch after a warm one each). Fills stats[kernel]["generic_k<k>"]."""
    from slam_decomposition_torch.ops import _build
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import certificate
    from slam_decomposition_torch.tools.inputs import best_restart, kernel_inputs

    dev = torch.device("cuda")
    g64, g32, T, lanes_t, x0, sched = kernel_inputs(k, targets, restarts, dev).values()
    L, p, i = x0.shape[0], _build.ptr, ctypes.c_int

    def adam_generic(s):
        out = torch.empty_like(x0)
        _build.launch(None, "slam_adam_chain_generic", p(x0), p(lanes_t), p(g32), p(s), i(s.shape[0]), i(k), i(L), p(out), None)
        return out

    def lm_generic(x):
        xo, fo = torch.empty_like(x), torch.empty(L, device=dev)
        _build.launch(None, "slam_lm_chain_generic", p(x), p(lanes_t), p(g32), i(ck.LM32_ITERS), i(k), i(L), p(xo),
                      p(fo), None)
        return xo, fo

    def polish_generic(x):
        xo, fo = torch.empty_like(x), torch.empty(x.shape[0], device=dev, dtype=torch.float64)
        _build.launch(None, "slam_polish_chain_generic", p(x), p(T), p(g64), i(ck.LM_ITERS), i(k), i(x.shape[0]),
                      p(xo), p(fo), None)
        return xo, fo

    s25 = sched[:ADAM_PARITY_ITERS].contiguous()
    d = (adam_generic(s25) - ck.adam_chain(x0, lanes_t, g32, s25)).abs().amax(1)
    frac = (d <= ADAM_ATOL).float().mean().item()
    xg, ms_g = timed_ms(lambda: adam_generic(sched))
    xi, ms_i = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched))
    dfrac = abs((ck.square_cost(xg, lanes_t, g32) < 1e-2).float().mean().item()
                - (ck.square_cost(xi, lanes_t, g32) < 1e-2).float().mean().item())
    print(f"[generic] adam_chain k={k} L={L}, generic program against the instance: {ADAM_PARITY_ITERS} steps max|dx| "
          f"{d.max().item():.3e}, {frac:.5f} of lanes within {ADAM_ATOL:g} (need >= {ADAM_LANE_FRAC}); 100 steps |d frac("
          f"cost<1e-2)| {dfrac:.4f} (need <= {ADAM_COST_FRAC_TOL}); generic {ms_g:.3f} ms, instance {ms_i:.3f} ms")
    check(frac >= ADAM_LANE_FRAC and dfrac <= ADAM_COST_FRAC_TOL, f"adam_chain k={k}: the generic program disagrees with the instance")
    stats["adam_chain"][f"generic_k{k}"] = {"lanes": L, "generic_ms": ms_g, "instance_ms": ms_i}
    (_, flg), ms_g = timed_ms(lambda: lm_generic(xi))
    (xl, fli), ms_i = timed_ms(lambda: ck.lm_chain(xi, lanes_t, g32))
    ok = torch.isclose(flg, fli, rtol=LM_RTOL, atol=LM_ATOL).float().mean().item()
    print(f"[generic] lm_chain k={k} L={L}: max|d||r||^2| {(flg - fli).abs().max().item():.3e}, {ok:.5f} of lanes within "
          f"rtol {LM_RTOL:g} atol {LM_ATOL:g} (need >= {LM_LANE_FRAC}); generic {ms_g:.3f} ms, instance {ms_i:.3f} ms")
    check(ok >= LM_LANE_FRAC, f"lm_chain k={k}: the generic program disagrees with the instance")
    stats["lm_chain"][f"generic_k{k}"] = {"lanes": L, "generic_ms": ms_g, "instance_ms": ms_i}
    xb = best_restart(xl, fli, restarts)
    (xpg, fpg), ms_g = timed_ms(lambda: polish_generic(xb))
    (_, fpi), ms_i = timed_ms(lambda: ck.polish_chain(xb, T, g64))
    c, c_i = certificate(fpg), certificate(fpi)
    verdict = ((c <= THRESH) == (c_i <= THRESH)).double().mean().item()
    both = (c <= THRESH) & (c_i <= THRESH)
    close = ((c - c_i)[both].abs() <= POLISH_COST_ATOL).double().mean().item() if both.any() else 1.0
    cert = c <= THRESH
    cert_err = (c - ck.square_cost(xpg, T, g64))[cert].abs().max().item() if cert.any() else 0.0
    print(f"[generic] polish_chain k={k} L={xb.shape[0]}: certified {int(cert.sum())} vs instance {int((c_i <= THRESH).sum())}, "
          f"same verdict on {verdict:.5f} of lanes (need >= {POLISH_VERDICT_FRAC}), within {POLISH_COST_ATOL:g} on {close:.5f} "
          f"of those both certify (need >= {POLISH_COST_FRAC}), certificate vs true f64 cost {cert_err:.3e} (need <= "
          f"{CERT_ATOL:g}); generic {ms_g:.3f} ms, instance {ms_i:.3f} ms")
    check(verdict >= POLISH_VERDICT_FRAC and close >= POLISH_COST_FRAC and cert_err <= CERT_ATOL,
          f"polish_chain k={k}: the generic program disagrees with the instance")
    stats["polish_chain"][f"generic_k{k}"] = {"lanes": xb.shape[0], "generic_ms": ms_g, "instance_ms": ms_i}


def polish_parity_on_init(label, U, ks, dev):
    """polish_parity at the transpile path's shapes and inputs: per k-class
    of U, the analytic init's x (the seeds the batched synthesis polishes).
    Returns the largest max |d cost|."""
    from slam_decomposition_torch.opt.gauss_newton import make_analytic_solver

    worst = 0.0
    for k in (2, 3):
        solver = make_analytic_solver(k, dev)
        T = torch.as_tensor(U[ks == k]).to(dev).contiguous()
        x = solver.init_only(T).to(torch.float64).contiguous()
        err, _, _ = polish_parity(f"{label} k={k} (analytic-init seeds)", x, T, solver.base.gates64)
        worst = max(worst, err)
    return worst


def phase_weyl(stats):
    """The magic-basis eigenphase kernel on the main path's targets against
    the plain chain on the CPU; fills stats["gamma_eigenphases"]."""
    from slam_decomposition_torch.coverage.coverage import KS_CHUNK, load_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.ops import _build, weyl
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.utils import mfu

    def launches():
        return _build.launch_counts()["gamma_eigenphases"]

    U = torch.as_tensor(haar_sample(B, seed=SEED))
    T = U.cuda()
    before = launches()
    ph, ms = timed_ms(lambda: weyl.gamma_eigenphases(T))
    check(launches() == before + 2, "gamma_eigenphases did not launch its kernel once a call")
    _, plain_ms = timed_ms(lambda: weyl.gamma_eigenphases_ref(T))
    want = weyl.gamma_eigenphases_ref(U)
    err = (torch.remainder(ph.cpu() - want + math.pi, 2 * math.pi) - math.pi).abs().max().item()
    rep_err = (weyl.monodromy_coords(T).cpu() - weyl.monodromy_coords(U)).abs().max().item()
    cov = load_coverage(gates.cg_sqiswap())
    before = launches()
    ks = monodromy_ks_batch(cov, T)
    chunks = launches() - before
    same = bool((ks == monodromy_ks_batch(cov, U, device="cpu")).all())
    hist = {int(k): int(n) for k, n in zip(*np.unique(ks, return_counts=True))}
    bound = bound_line("gamma_eigenphases", f"{B} targets", mfu.gamma_eigenphases_launch(B), ms)
    print(f"[weyl] phases within {err:.3e} (mod 2 pi), representatives within {rep_err:.3e} of the CPU's plain chain; "
          f"ks equal to the CPU's: {same}, histogram {hist}, {chunks} launches; plain chain on the card {plain_ms:.3f} ms")
    check(err <= 1e-12 and rep_err <= 1e-12, f"eigenphases {err:.3e} / representatives {rep_err:.3e} off the plain chain")
    check(same and hist == WANT_HIST, f"ks differ from the CPU's or histogram {hist} != {WANT_HIST}")
    check(chunks == math.ceil(B / KS_CHUNK), f"{chunks} eigenphase launches for {B} targets")
    stats["gamma_eigenphases"] = {"max_abs_err": max(err, rep_err), "ms": ms, "plain_ms": plain_ms, "bound": bound}


def phase_main_path(card):
    from slam_decomposition_torch.coverage.coverage import KS_CHUNK
    from slam_decomposition_torch.ops import _build
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.pipeline import decompose_haar

    ck.reset_launch_counts()
    t0 = time.perf_counter()
    r = decompose_haar(B=B, chunk=CHUNK, restarts=RESTARTS, thresh=THRESH, seed=SEED, device="cuda")
    wall = time.perf_counter() - t0
    counts = _build.launch_counts()
    hist = r.k_histogram()
    worst = float(np.max(r.losses))
    # one launch of each chain kernel per solved chunk: one warm-up chunk per
    # k, the chunks of each k bucket, and the chunks of each rescue round;
    # one eigenphase launch per KS_CHUNK of the warm-up's and the batch's k
    # assignments (the sqiSwap coverage set comes from its cache)
    chunks = sum(math.ceil(n / CHUNK) for n in [*hist.values(), *r.rescued])
    want = len(WANT_HIST) + chunks
    want_eig = math.ceil(CHUNK / KS_CHUNK) + math.ceil(B / KS_CHUNK)
    print(f"[main] k histogram {hist}; certified {r.n_certified}/{B} at <= {THRESH:g}; worst loss {worst:.3e}; "
          f"rescued {r.rescued}; launches {counts} (expected {want} of each chain kernel, {want_eig} eigenphase)")
    t = r.times
    print(f"[main] {card}: ranges {t['ranges']:.3f} s, solve {t['solve']:.3f} s, rescue {t['rescue']:.3f} s, "
          f"total {t['total']:.3f} s -> {r.n_certified / t['total']:.1f} targets/s "
          f"(call incl. warm-up {wall:.1f} s)")
    check(r.losses.shape == (B,) and np.isfinite(r.losses).all(), "losses are not finite of shape (B,)")
    check(hist == WANT_HIST, f"k histogram {hist} != {WANT_HIST}")
    check(r.n_certified == B, f"certified {r.n_certified} of {B}")
    check(worst <= THRESH, f"worst loss {worst} > {THRESH}")
    check(all(counts[name] == want for name in REPLACES), f"launches {counts}, expected {want} of each chain kernel")
    check(counts["gamma_eigenphases"] == want_eig, f"{counts['gamma_eigenphases']} eigenphase launches, expected {want_eig}")
    return counts, r


def contract(results, U):
    """How many (steps, n) results meet the synthesis contract, and the worst
    phase-sensitive trace infidelity 1 - Re tr(V^dag U)/4: V =
    steps_to_matrix(steps) reproduces its target within SYNTH_ATOL, global
    phase included, with n sqiswap steps. Vectorized: blocks are grouped by
    step structure, so the matrix products run once per structure."""
    from slam_decomposition_torch.transpile.kak import SQISWAP_M

    groups = {}
    for i, (steps, _) in enumerate(results):
        groups.setdefault(tuple(kind for kind, _ in steps), []).append(i)
    infid = np.empty(len(U))
    n_sq = np.empty(len(U), dtype=np.int64)
    for kinds, idx in groups.items():
        V = np.broadcast_to(np.eye(4, dtype=complex), (len(idx), 4, 4))
        for j, kind in enumerate(kinds):
            if kind == "sqiswap":
                V = SQISWAP_M @ V
            elif kind == "1q":
                l = np.stack([results[i][0][j][1][0] for i in idx])
                r = np.stack([results[i][0][j][1][1] for i in idx])
                V = np.einsum("mab,mcd->macbd", l, r).reshape(-1, 4, 4) @ V
            else:
                V = np.exp(1j * np.array([results[i][0][j][1] for i in idx]))[:, None, None] * V
        infid[idx] = 1.0 - np.einsum("mij,mij->m", V.conj(), U[idx]).real / 4.0
        n_sq[idx] = kinds.count("sqiswap")
    ok = (infid <= SYNTH_ATOL) & (n_sq == np.array([n for _, n in results]))
    return int(ok.sum()), float(infid.max())


def _hist(ns):
    vals, cnt = np.unique(np.asarray(ns), return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, cnt)}


def phase_transpile(card, main_rate):
    from slam_decomposition_torch.ops import _build
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.batch_synth import sqiswap_decompose_batch
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.passes import pass_manager_basic

    dev = torch.device("cuda")
    total = {name: 0 for name in COUNTED}

    def counted(fn):
        """fn() with the launch counts set to 0 before and read after."""
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _build.launch_counts()
        for name in total:
            total[name] += got[name]
        return out, wall, ck.launch_counts()

    def pass_twice(batched, stats=None):
        run = lambda: pass_manager_basic(circ, "sqiswap", 0.25, batched=batched, device=dev, stats=stats)  # noqa: E731
        run()
        torch.cuda.synchronize()
        if not batched:
            t0 = time.perf_counter()
            return run(), time.perf_counter() - t0, None
        return counted(run)

    # (a) QFT-64, the repo's largest transpile circuit
    circ = library.qft(QFT_Q)
    Us = np.stack([b.unitary for b in consolidate_2q_blocks(circ)])
    ks = sqiswap_count_batch(Us, device=dev)
    hist = _hist(ks)
    print(f"[transpile] qft({QFT_Q}): {len(Us)} blocks, sqiswap counts {hist}")
    check(len(Us) == QFT_BLOCKS, f"qft({QFT_Q}) consolidates to {len(Us)} blocks, not {QFT_BLOCKS}")
    check(hist == QFT_HIST, f"qft({QFT_Q}) counts {hist} != {QFT_HIST}")
    stats = {}
    (_, m_b), t_b, launches = pass_twice(True, stats)
    emitted = stats.pop("results")  # the timed pass's (steps, n) per block
    (_, m_h), t_h, _ = pass_twice(False)
    print(f"[transpile] qft({QFT_Q}) batched: duration {m_b['duration']}, gates {m_b['gate_counts']}, stats {stats}, "
          f"launches {launches}; host loop: duration {m_h['duration']}, gates {m_h['gate_counts']}")
    print(f"[transpile] {card}: qft({QFT_Q}) pass_manager_basic warm {t_b:.3f} s batched vs {t_h:.3f} s host loop")
    check(m_b["duration"] == QFT_DURATION == m_h["duration"], "qft-64 duration differs from the reference")
    check(m_b["gate_counts"] == QFT_GATES_BATCHED, f"batched gate counts {m_b['gate_counts']} != {QFT_GATES_BATCHED}")
    check(m_h["gate_counts"] == QFT_GATES_HOST, f"host gate counts {m_h['gate_counts']} != {QFT_GATES_HOST}")
    check(stats == {"device": QFT_BLOCKS - QFT_HIST[0], "fallback": 0, "trivial": QFT_HIST[0]},
          f"qft-64 stats {stats}")
    check(launches["polish_chain"] == 2 and launches["adam_chain"] == launches["lm_chain"] == 0,
          f"qft-64 batched pass launches {launches}, expected 2 polish")
    # the timed pass's emitted steps, re-certified on the host
    ok, worst = contract(emitted, Us)
    hist = _hist([n for _, n in emitted])
    print(f"[transpile] qft({QFT_Q}) emitted steps: {ok}/{len(Us)} meet the contract, worst trace infidelity "
          f"{worst:.3e} (need <= {SYNTH_ATOL:g}); emitted counts {hist}")
    check(ok == len(Us), f"{len(Us) - ok} qft-64 blocks miss the contract")
    check(hist == QFT_HIST, f"qft-64 emitted counts {hist} != {QFT_HIST}")
    # the polish kernel against its plain version at this path's shapes
    err_a = polish_parity_on_init(f"qft({QFT_Q})", Us, ks, dev)

    # (b) full width: the Haar batch of the main path
    U = haar_sample(B, seed=SEED)
    sqiswap_decompose_batch(haar_sample(B, seed=SEED + 1), device=dev)  # warm-up on other data
    stats, times = {}, {}
    res, wall, launches = counted(lambda: sqiswap_decompose_batch(U, stats=stats, device=dev, times=times))
    ks = np.array([n for _, n in res])
    hist = _hist(ks)
    ok, worst = contract(res, U)
    print(f"[transpile] haar {B} (seed {SEED}): counts {hist}; {ok}/{B} meet the contract (worst trace infidelity "
          f"{worst:.3e}); stats {stats} (fallback limit {SYNTH_FALLBACK_MAX}); launches {launches}")
    print(f"[transpile] {card}: haar {B} warm count {times['count']:.3f} s, init {times['init']:.3f} s, "
          f"polish {times['polish']:.3f} s, host emit {times['emit']:.3f} s; total {wall:.3f} s -> "
          f"{B / wall:.1f} blocks/s (main path: {main_rate:.1f} targets/s)")
    check(hist == WANT_HIST, f"haar counts {hist} != {WANT_HIST}")
    check(ok == B, f"{B - ok} of {B} blocks miss the contract")
    check(stats["fallback"] <= SYNTH_FALLBACK_MAX, f"fallback {stats['fallback']} > {SYNTH_FALLBACK_MAX}")
    check(launches["polish_chain"] == 2 and launches["adam_chain"] == launches["lm_chain"] == 0,
          f"haar batch launches {launches}, expected 2 polish")
    err_b = polish_parity_on_init(f"haar {B}", U, ks, dev)
    print(f"[transpile] launches summed over the transpile runs: {total}")
    return total, max(err_a, err_b)


class Counted:
    """Runs callables with the kernels' launch counts and the general
    solver's call count set to 0 just before and read just after, and sums
    the kernels' launches over its runs."""

    def __init__(self):
        self.total = {name: 0 for name in COUNTED}

    def __call__(self, fn):
        from slam_decomposition_torch.ops import _build
        from slam_decomposition_torch.ops import chain_kernels as ck
        from slam_decomposition_torch.opt.gauss_newton import GeneralSolver

        ck.reset_launch_counts()
        GeneralSolver.calls = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _build.launch_counts()
        for name in self.total:
            self.total[name] += got[name]
        return out, wall, ck.launch_counts(), GeneralSolver.calls, torch.cuda.max_memory_allocated() / 2**20


def _sqiswap_basis():
    from slam_decomposition_torch.models.gates import SQISWAP
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates

    return lambda k: build_ansatz(cycle_gates([SQISWAP], k))


def certified_share(basis, res, U, dev):
    """The share of targets whose reported loss is at or under THRESH and is
    confirmed by the f64 square cost of the reported parameters."""
    from slam_decomposition_torch.opt.costs import square_cost as cost

    T = torch.as_tensor(U).to(dev)
    ok = np.zeros(len(U), dtype=bool)
    for k in np.unique(res.cycles[res.cycles > 0]):
        a = basis(int(k))
        idx = np.where(res.cycles == k)[0]
        x = torch.as_tensor(res.params[idx, : a.n_params]).to(dev)
        true = cost(a.eval_fn(x), T[torch.as_tensor(idx, device=dev)]).cpu().numpy()
        claimed = res.loss[idx]
        check((np.abs(true - claimed)[claimed <= THRESH] <= CERT_ATOL).all(),
              f"depth {k}: a reported loss <= {THRESH:g} is not the f64 cost of its parameters")
        ok[idx] = (claimed <= THRESH) & (true <= THRESH + CERT_ATOL)
    return ok.mean()


def active_targets(res, k, lo=None):
    """How many targets the optimizer solved at depth k, from its result:
    those that no smaller depth solved and, with per-target ranges starting
    at ``lo`` (m,), whose range reaches k."""
    active = ~(res.success & (res.cycles < k))
    return int((active if lo is None else active & (lo <= k)).sum())


def expected_chunks(res, ks, chunk, lo=None):
    """How many chunks of ``chunk`` targets the optimizer must solve over the
    depths ks (``active_targets`` at each). Every chunk launches each kernel
    once on the kernel path and is one call of the general solver on the
    other."""
    return sum(math.ceil(active_targets(res, k, lo) / chunk) for k in ks)


def check_counts(what, launches, general, want_launches, want_general):
    check(all(v == want_launches for v in launches.values()) and general == want_general,
          f"{what}: launches {launches} (expected {want_launches} of each kernel), general-solver calls {general} "
          f"(expected {want_general})")


def phase_api(card, counted, stats):
    """The README's first quick-start on the card at full width."""
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.opt.optimizer import CHUNK as API_CHUNK, TemplateOptimizer
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.tools.optimizer_readings import depth2_excess

    basis = _sqiswap_basis()
    U = haar_sample(B, seed=SEED)
    warm = TemplateOptimizer(basis, objective="square", spanning_range=[2, 3], override_fail=True)
    warm.approximate_from_distribution(haar_sample(1024, seed=SEED + 1))
    opt = TemplateOptimizer(basis, objective="square", spanning_range=[2, 3], override_fail=True)
    check(opt.training_restarts == API_RESTARTS, f"default restarts {opt.training_restarts} != {API_RESTARTS}")
    res, wall, launches, general, peak = counted(lambda: opt.approximate_from_distribution(U))
    ks = np.maximum(monodromy_ks_batch(gate_set_to_coverage(gates.cg_sqiswap()), U, torch.device("cuda")), 2)
    share = float(res.success.mean())
    certified = certified_share(basis, res, U, torch.device("cuda"))
    late = int(((res.cycles == 3) & (ks == 2)).sum())  # depth-2 targets whose restarts all missed at depth 2
    early = np.where((res.cycles == 2) & (ks == 3) & res.success)[0]  # depth 3, yet a depth-2 circuit at <= 1e-10
    outside = depth2_excess(U[early], torch.device("cuda"))  # > 0: outside the depth-2 region
    hist = _hist(res.cycles)
    want = expected_chunks(res, (2, 3), API_CHUNK)
    print(f"[api] paths {opt.solver_paths}; launches {launches} (expected {want} each: one per chunk of {API_CHUNK} targets); "
          f"general-solver calls {general}; cycles {hist} "
          f"(monodromy {_hist(ks)}: {late} depth-2 targets solved at depth 3, {len(early)} depth-3 targets solved at depth 2, "
          f"at most {outside.max(initial=0.0):.2e} outside the depth-2 region, allowed {API_BOUNDARY_SLACK:g}); "
          f"success {int(res.success.sum())}/{B} = {share:.5f} (need >= {API_SUCCESS_MIN}), confirmed in f64 {certified:.5f}; "
          f"worst loss {res.loss.max():.3e}")
    print(f"[api] {card}: " + ", ".join(f"k={k} {t:.3f} s" for k, t in opt.k_seconds.items())
          + f", call {wall:.3f} s -> {res.success.sum() / wall:.1f} targets/s; peak device memory {peak:.0f} MiB")
    check(opt.solver_paths == {2: "kernels", 3: "kernels"}, f"paths {opt.solver_paths}")
    check_counts("api", launches, general, want, 0)
    check(_hist(ks) == WANT_HIST, f"monodromy histogram {_hist(ks)} != {WANT_HIST}")
    check((outside <= API_BOUNDARY_SLACK).all(),
          f"a target {outside.max(initial=0.0):.2e} outside the depth-2 region is reported solved at depth 2")
    check(set(res.cycles[res.success]) <= {2, 3}, "a solved target's cycles is neither 2 nor 3")
    check(share >= API_SUCCESS_MIN and certified == share, f"success share {share}, confirmed {certified}")
    # the kernels against their plain versions at the lanes of one full chunk
    # of this path, outside the counted run
    phase_parity(stats, ks=(2, 3), targets=API_CHUNK, restarts=API_RESTARTS, tag="_api")


def phase_basis(card, counted, stats, basis_spec):
    """A conversion-gain basis at full width: its monodromy depths, then the
    optimizer with each target's own range (its depth to the deepest), every
    depth on the kernels; then chains through both solver paths and the
    kernels against their plain versions at the lanes the run launched.
    Returns the targets and their monodromy depths."""
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.gauss_newton import ChainSolver, GeneralSolver
    from slam_decomposition_torch.opt.optimizer import CHUNK as API_CHUNK, TemplateOptimizer
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.tools.optimizer_readings import ranking_agreement

    dev = torch.device("cuda")
    tag, name, depths, hist = f"[{basis_spec.tag}]", basis_spec.name, basis_spec.depths, basis_spec.hist
    q = gates.conversion_gain_gate(0, 0, *basis_spec.drives, 1.0)
    basis = lambda k: build_ansatz(cycle_gates([q], k))  # noqa: E731
    cov = gate_set_to_coverage(q, device=dev)
    U = haar_sample(B, seed=SEED)
    ks = monodromy_ks_batch(cov, U, dev)
    ks_cpu = monodromy_ks_batch(cov, U, torch.device("cpu"))
    print(f"{tag} {q}: monodromy depths of haar {B} (seed {SEED}) on the card {_hist(ks)}, on the CPU {_hist(ks_cpu)}")
    check(np.array_equal(ks, ks_cpu) and _hist(ks) == hist, f"{name} depths {_hist(ks)} != {hist}")
    lo = np.maximum(ks, min(depths))  # each target's range: its depth to the deepest
    ranges_of = lambda lo: [list(range(k, max(depths) + 1)) for k in lo]  # noqa: E731
    Uw = haar_sample(1024, seed=SEED + 1)
    warm = TemplateOptimizer(basis, objective="square", spanning_range=list(depths), override_fail=True)
    warm.approximate_from_distribution(Uw, spanning_ranges=ranges_of(np.maximum(monodromy_ks_batch(cov, Uw, dev), 2)))
    opt = TemplateOptimizer(basis, objective="square", spanning_range=list(depths), override_fail=True)
    draws = []  # host seconds of each depth's draw of starts (for all B targets, in the JAX package's order)
    init = opt._init_params

    def timed_init(*args):
        t0 = time.perf_counter()
        out = init(*args)
        draws.append(time.perf_counter() - t0)
        return out

    opt._init_params = timed_init
    res, wall, launches, general, peak = counted(lambda: opt.approximate_from_distribution(U, spanning_ranges=ranges_of(lo)))
    share = float(res.success.mean())
    certified = certified_share(basis, res, U, dev)
    want = expected_chunks(res, depths, API_CHUNK, lo)
    active = {k: active_targets(res, k, lo) for k in depths}
    print(f"{tag} paths {opt.solver_paths}; targets solved at each depth {active}; launches {launches} (expected {want} "
          f"each: one per chunk of {API_CHUNK} targets at each depth); general-solver calls {general}; cycles "
          f"{_hist(res.cycles)} (monodromy {_hist(ks)}); success {int(res.success.sum())}/{B} = {share:.5f} (need >= "
          f"{basis_spec.success_min}), confirmed in f64 {certified:.5f}; worst loss {res.loss.max():.3e}")
    print(f"{tag} {card}: " + ", ".join(f"k={k} {t:.3f} s" for k, t in opt.k_seconds.items())
          + f", call {wall:.3f} s -> {res.success.sum() / wall:.1f} targets/s; peak device memory {peak:.0f} MiB; "
          f"drawing starts on the host {sum(draws):.3f} s over {len(draws)} depths ({sum(draws) / wall:.1%} of the call)")
    check(opt.solver_paths == {k: "kernels" for k in depths if active[k]}, f"paths {opt.solver_paths}")
    check_counts(name, launches, general, want, 0)
    check((res.cycles[res.success] >= lo[res.success]).all(), "a target is solved below its monodromy depth")
    check(share >= basis_spec.success_min and certified == share, f"success share {share}, confirmed {certified}")
    # chains through both paths from the same starts, restart by restart (as
    # phase 12 (d) holds the sqiSwap chain)
    for k, n_targets, least in basis_spec.chains:
        a = basis(k)
        T = torch.as_tensor(U[(ks >= least) & (ks <= k)][:n_targets]).to(dev)
        gen = torch.Generator()
        gen.manual_seed(9)
        x0 = (torch.rand((T.shape[0], API_RESTARTS, a.n_params), generator=gen, dtype=torch.float64) * (2 * math.pi)).to(dev)
        kernel, general_solver = ChainSolver(a.chain_gates), GeneralSolver(a.eval_fn, a.n_params)
        (_, fk), wall_k, launches, _, _ = counted(lambda: kernel.solve(x0, T))
        (xg, fg), wall_g, _, general, peak = counted(lambda: general_solver.solve(x0, T))
        verdict = ((fk <= THRESH) == (fg <= THRESH)).double().mean().item()
        r = ranking_agreement(kernel, general_solver, x0, T)
        print(f"{tag} {card}: chain k={k}, {T.shape[0]} targets of depth {least}..{k} x {API_RESTARTS} restarts, kernel "
              f"path against general path from the same starts: certified {(fk <= THRESH).double().mean().item():.5f} / "
              f"{(fg <= THRESH).double().mean().item():.5f}, same verdict {verdict:.5f} (need >= {GENERAL_VERDICT_FRAC}); "
              f"restarts converged in both or neither {r['lanes_same']:.5f} (need >= {RANK_LANES_MIN}), lanes by the "
              f"kernels' score in decades from 1e-10 {[round(v, 5) for v in r['decades']]}; same best restart "
              f"{r['same_best']:.5f}, on the {r['single']:.5f} of targets with one converged restart "
              f"{r['same_best_single']:.5f} (need >= {RANK_SINGLE_MIN}), general path's winner converged by the kernels' "
              f"score {r['winner_converged']:.5f} (need >= {RANK_WINNER_MIN}); {wall_k:.3f} s ({launches}) against "
              f"{wall_g:.3f} s ({general} general call), peak {peak:.0f} MiB")
        check(verdict >= GENERAL_VERDICT_FRAC, f"chain k={k}: the two paths certify different targets")
        check(r["lanes_same"] >= RANK_LANES_MIN and r["same_best_single"] >= RANK_SINGLE_MIN
              and r["winner_converged"] >= RANK_WINNER_MIN, f"chain k={k}: the two paths rank the restarts differently")
        check(all(v == 1 for v in launches.values()) and general == 1, f"chain k={k}: launches {launches}, general {general}")
        check((general_solver.certify(xg, T)[fg <= THRESH] <= THRESH + CERT_ATOL).all(), "general path's cost is not its x's")
    # the kernels against their plain versions at the lanes the deep runs
    # launched (a chunk's at most), outside the counted runs
    for k in basis_spec.parity_ks:
        if active[k]:
            phase_parity(stats, ks=(k,), targets=min(active[k], API_CHUNK), restarts=API_RESTARTS,
                         tag=f"_{basis_spec.tag}", gate=q)
    return U, ks


def same_coverage(built, cached):
    """Whether two coverage sets are equal row for row: the operations, the
    cost, and every convex subpolytope's name and exact Fraction rows, in
    order."""
    return len(built) == len(cached) and all(
        a.operations == b.operations and a.cost == b.cost
        and [(c.name, c.inequalities, c.equalities) for c in a.polytope.convex_subpolytopes]
        == [(c.name, c.inequalities, c.equalities) for c in b.polytope.convex_subpolytopes]
        for a, b in zip(built, cached)
    )


def phase_coverage(card, counted, stats):
    """The coverage engine on the card's host, coordinates on the card:
    (a) the sqiSwap and quarter-iSwap sets built without their caches, each
    equal row for row to the JAX package's cached pickle, and
    the main path's depths over the built sqiSwap set; (b) the
    parallel-drive basis, which has no cache: its set built from nothing,
    its expected cost, then phase_basis over it, and the coverage-backed
    template's cost of the 100000 targets."""
    from slam_decomposition_torch.config import coverage_cache_dir, data_dir
    from slam_decomposition_torch.convert import coverage_from_jax_pickle
    from slam_decomposition_torch.coverage import coverage as cov
    from slam_decomposition_torch.coverage.haar import expected_cost
    from slam_decomposition_torch.coverage.mixed import MixedOrderBasisTemplate
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.opt.samplers import haar_sample

    dev = torch.device("cuda")
    t_phase, build_s = time.perf_counter(), 0.0
    U = haar_sample(B, seed=SEED)
    for name, drives in COVERAGE_BUILDS:
        g = gates.cg_sqiswap() if drives is None else gates.conversion_gain_gate(0, 0, *drives, 1.0)
        t0 = time.perf_counter()
        built = cov.gate_set_to_coverage(g, use_cache=False, device=dev)
        seconds = time.perf_counter() - t0
        build_s += seconds
        # the JAX package's own pickle, not the port's build cache, which
        # the build above has just written
        check(cov.coverage_path(g).exists(), f"no cached {name} set in the JAX package's data")
        same = same_coverage(built, coverage_from_jax_pickle(cov.coverage_path(g)))
        print(f"[coverage] {card}: {name} {g}: built {len(built)} entries in {seconds:.3f} s "
              f"({sum(len(c.polytope.convex_subpolytopes) for c in built)} convex subpolytopes), equal row for row "
              f"to the JAX package's cached set: {same}")
        check(same, f"the {name} set built here differs from the cached one")
        if drives is None:
            ks = np.maximum(cov.monodromy_ks_batch(built, U, dev), 2)
            print(f"[coverage] depths of haar {B} (seed {SEED}) over the built sqiswap set on the card: {_hist(ks)}")
            check(_hist(ks) == WANT_HIST, f"depths over the built sqiswap set {_hist(ks)} != {WANT_HIST}")
    # (b) the parallel-drive basis, built from nothing
    q = gates.conversion_gain_gate(0, 0, *PARALLEL_DRIVE.drives, 1.0)
    name = cov._cache_name([str(q)], False)
    check(not (data_dir() / name).exists(), f"{q} has a cached set in the JAX package's data")
    (coverage_cache_dir() / name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = cov.gate_set_to_coverage(q, device=dev)
    seconds = time.perf_counter() - t0
    build_s += seconds
    t0 = time.perf_counter()
    cost = expected_cost(built)
    cost_s = time.perf_counter() - t0
    depths = [len(c.operations) for c in built]
    print(f"[coverage] {card}: parallel-drive {q}: built {len(built)} entries (depths {depths}) in {seconds:.3f} s, "
          f"written to the port's cache: {(coverage_cache_dir() / name).exists()}; expected cost {cost!r} (JAX package "
          f"{PARALLEL_EXPECTED_COST!r}, need within {EXPECTED_COST_ATOL:g}) in {cost_s:.3f} s")
    check(depths == [0, 1, 2, 3] and (coverage_cache_dir() / name).exists(), f"parallel-drive set depths {depths}")
    check(abs(cost - PARALLEL_EXPECTED_COST) <= EXPECTED_COST_ATOL, f"expected cost {cost!r}")
    U, ks = phase_basis(card, counted, stats, PARALLEL_DRIVE)
    t0 = time.perf_counter()
    total = MixedOrderBasisTemplate([q], device=dev).cost_from_distribution(U)
    print(f"[coverage] {card}: MixedOrderBasisTemplate cost of haar {B}: {total} (sum of depths {int(ks.sum())}) "
          f"in {time.perf_counter() - t0:.3f} s")
    check(total == float(ks.sum()), f"template cost {total} != {int(ks.sum())}")
    wall = time.perf_counter() - t_phase
    print(f"[coverage] {card}: phase {wall:.1f} s, of which the {len(COVERAGE_BUILDS) + 1} builds {build_s:.1f} s on the host "
          f"({build_s / wall:.1%})")


def phase_depth(card, counted, stats):
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.gauss_newton import takes_kernels
    from slam_decomposition_torch.opt.optimizer import CHUNK as API_CHUNK, TemplateOptimizer
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.ops.chain_kernels import INSTANCE_KS, KERNEL_KS

    dev = torch.device("cuda")
    basis = _sqiswap_basis()
    # (a) early exit over depths 1, 2, 3
    zoo = np.stack([g.to_numpy() for g in (gates.SQISWAP, gates.ISWAP, gates.CNOT, gates.SWAP)])
    U = np.tile(zoo, (DEPTH_TILE, 1, 1))
    opt = TemplateOptimizer(basis, spanning_range=[1, 2, 3], override_fail=True)
    res, wall, launches, general, _ = counted(lambda: opt.approximate_from_distribution(U))
    cyc = res.cycles.reshape(DEPTH_TILE, 4)
    print(f"[depth] sqiswap/iswap/cnot/swap x {DEPTH_TILE}: cycles {[_hist(cyc[:, j]) for j in range(4)]}, success "
          f"{res.success.mean():.5f}, paths {opt.solver_paths}, launches {launches}, general calls {general}, {wall:.3f} s")
    # 1, 2, 2, 3 are the least depths: no copy may be solved below its own, and
    # a copy whose restarts all miss there (a few of sqiSwap's at depth 1) is
    # solved one deeper
    least = np.array([1, 2, 2, 3])
    at_least = (cyc == least).mean(axis=0)
    check(res.success.all() and (cyc >= least).all() and (at_least >= np.array(DEPTH_LEAST_MIN)).all(),
          f"cycles are not 1, 2, 2, 3: shares at the least depth {at_least}")
    check(opt.solver_paths == {1: "kernels", 2: "kernels", 3: "kernels"}, f"paths {opt.solver_paths}")
    check_counts("depths 1, 2, 3", launches, general, expected_chunks(res, (1, 2, 3), API_CHUNK), 0)
    certified_share(basis, res, U, dev)
    # (b) the CNOT basis at depth 3
    cnot = lambda k: build_ansatz(cycle_gates([gates.CNOT], k))  # noqa: E731
    U = haar_sample(DEPTH_CNOT_B, seed=2)
    opt = TemplateOptimizer(cnot, spanning_range=[3], override_fail=True)
    res, wall, launches, general, _ = counted(lambda: opt.approximate_from_distribution(U))
    share = certified_share(cnot, res, U, dev)
    print(f"[depth] cnot basis k=3, haar {DEPTH_CNOT_B} (seed 2): success {share:.5f} (need >= {DEPTH_CNOT_MIN}), "
          f"launches {launches}, {wall:.3f} s")
    check(share >= DEPTH_CNOT_MIN, "cnot basis at depth 3")
    check_counts("cnot basis at depth 3", launches, general, math.ceil(DEPTH_CNOT_B / API_CHUNK), 0)
    # (c) depths 4 to kMaxK on the kernels, and kMaxK + 1 routed by rule
    U = haar_sample(DEPTH_DEEP_B, seed=7)
    for k, want in depth_deep():
        if want == "general":  # a routing check: the kernels cover depths 1..kMaxK
            opt = TemplateOptimizer(basis, spanning_range=[k], override_fail=True)
            path = opt._solver_for(k, basis(k))[1]
            print(f"[depth] sqiswap k={k}: path {path} (by rule: the kernels cover k in {KERNEL_KS[0]}..{KERNEL_KS[-1]}, "
                  f"n = {6 * (k + 1)} parameters; no solve)")
            check(path == want and not takes_kernels(basis(k).chain_gates),
                  f"depth {k}: path {path}, kernels to depth {KERNEL_KS[-1]}")
            continue
        opt = TemplateOptimizer(basis, spanning_range=[k], override_fail=True)
        res, wall, launches, general, peak = counted(lambda: opt.approximate_from_distribution(U))
        share = certified_share(basis, res, U, dev)
        program = "instance" if k in INSTANCE_KS else "depth-generic program"
        print(f"[depth] sqiswap k={k}, haar {DEPTH_DEEP_B}: path {opt.solver_paths[k]} ({program}, n = {6 * (k + 1)} "
              f"parameters), success {share:.5f}, launches {launches}, general calls {general}, {wall:.3f} s, peak {peak:.0f} MiB")
        check(opt.solver_paths[k] == want and share >= DEPTH_CNOT_MIN, f"depth {k}: path {opt.solver_paths[k]}, success {share}")
        check_counts(f"depth {k}", launches, general, math.ceil(DEPTH_DEEP_B / API_CHUNK), 0)
    # (d) the kernels against their plain versions at the lanes (a), (b) and
    # (c) launch them with, outside the counted runs
    phase_parity(stats, ks=(1,), targets=4 * DEPTH_TILE, restarts=API_RESTARTS)
    phase_parity(stats, ks=(3,), targets=DEPTH_CNOT_B, restarts=API_RESTARTS, tag="_cnot", gate=gates.CNOT)
    phase_parity(stats, ks=depth_parity(), targets=DEPTH_DEEP_B, restarts=API_RESTARTS)


def phase_general(card, counted):
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models.templates import build_ansatz, build_ansatz_v2, cycle_gates
    from slam_decomposition_torch.opt.gauss_newton import ChainSolver, GeneralSolver
    from slam_decomposition_torch.opt.optimizer import CHUNK as API_CHUNK, TemplateOptimizer
    from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch
    from slam_decomposition_torch.tools.optimizer_readings import ranking_agreement

    dev = torch.device("cuda")
    basis = _sqiswap_basis()
    # (a) the local-equivalence objectives: Adam + LM on the Makhlin residual
    U = haar_sample(GENERAL_CLASS_B, seed=4)
    for obj in ("square_reduced", "makhlin_functional"):
        opt = TemplateOptimizer(basis, objective=obj, spanning_range=[3], success_threshold=GENERAL_CLASS_THRESH,
                                override_fail=True)
        res, wall, launches, general, peak = counted(lambda: opt.approximate_from_distribution(U))
        share = float(res.success.mean())
        print(f"[general] {card}: {obj}, sqiswap k=3, haar {GENERAL_CLASS_B}: success {share:.5f} at <= "
              f"{GENERAL_CLASS_THRESH:g} (need >= {GENERAL_CLASS_MIN}), path {opt.solver_paths[3]}, kernel launches "
              f"{launches}, general calls {general}, {wall:.3f} s, peak {peak:.0f} MiB")
        check(opt.solver_paths == {3: "general"}, f"{obj}: wrong path")
        check_counts(obj, launches, general, 0, math.ceil(GENERAL_CLASS_B / API_CHUNK))
        check(share >= GENERAL_CLASS_MIN and np.isfinite(res.loss).all(), f"{obj}: success {share}")
    # (b) the batched L-BFGS
    cnot = lambda k: build_ansatz(cycle_gates([gates.CNOT], k))  # noqa: E731
    U = haar_sample(GENERAL_LBFGS_B, seed=2)
    opt = TemplateOptimizer(cnot, spanning_range=[3], method="lbfgs", override_fail=True)
    res, wall, launches, general, peak = counted(lambda: opt.approximate_from_distribution(U))
    share = certified_share(cnot, res, U, dev)
    st = opt.lbfgs_stats[0]
    print(f"[general] {card}: lbfgs, cnot k=3, haar {GENERAL_LBFGS_B} x {opt.training_restarts} restarts: success "
          f"{share:.5f} (need >= {GENERAL_LBFGS_MIN}), {st['evals']} batched evaluations, {st['syncs']} host reads, "
          f"{st['iters']} lane-iterations, {wall:.3f} s, peak {peak:.0f} MiB")
    check(opt.solver_paths == {3: "lbfgs"}, "lbfgs: wrong path")
    check_counts("lbfgs", launches, general, 0, 0)
    check(share >= GENERAL_LBFGS_MIN, f"lbfgs: success {share}")
    # (c) a parameterized gate under bounds
    bounds = (np.zeros(2), np.full(2, np.pi / 2))
    ansatz = build_ansatz_v2(lambda q, dtype: ham.conversion_gain_u(q[..., 0], q[..., 1], t=1.0, dtype=dtype),
                             n_gate_params=2, k=1, gate_bounds=bounds)
    opt = TemplateOptimizer(ansatz, training_restarts=GENERAL_V2_RESTARTS, override_fail=True)
    res, wall, launches, general, _ = counted(lambda: opt.approximate_target_U(gates.CNOT.to_numpy()))
    q = res.params[0, ansatz.n_params_1q:]
    print(f"[general] {card}: free conversion-gain gate -> CNOT at k=1, {GENERAL_V2_RESTARTS} restarts under bounds: loss "
          f"{res.loss[0]:.3e}, (gc, gg) = ({q[0]:.6f}, {q[1]:.6f}), path {opt.solver_paths[1]}, {wall:.3f} s")
    check(res.success.all() and opt.solver_paths == {1: "general"}, f"v2: loss {res.loss}")
    check_counts("v2", launches, general, 0, 1)
    check((q >= -1e-12).all() and (q <= np.pi / 2 + 1e-12).all(), f"v2: gate parameters {q} leave their bounds")
    # (d) the chain template forced through the general solver, against the
    # kernel path from the same starts
    U = haar_sample(GENERAL_CHAIN_B, seed=9)
    ks = np.maximum(sqiswap_count_batch(U, device=dev), 2)
    gen = torch.Generator()
    gen.manual_seed(9)
    for k in (2, 3):
        a = basis(k)
        T = torch.as_tensor(U[ks == k]).to(dev)
        x0 = (torch.rand((T.shape[0], API_RESTARTS, a.n_params), generator=gen, dtype=torch.float64) * (2 * math.pi)).to(dev)
        kernel, general_solver = ChainSolver(a.chain_gates), GeneralSolver(a.eval_fn, a.n_params)
        (xk, fk), wall_k, launches, _, _ = counted(lambda: kernel.solve(x0, T))
        (xg, fg), wall_g, _, general, peak = counted(lambda: general_solver.solve(x0, T))
        verdict = ((fk <= THRESH) == (fg <= THRESH)).double().mean().item()
        both = ((fk <= THRESH) & (fg <= THRESH)).double().mean().item()
        # restart by restart, outside the counted runs: both paths must find
        # the same restarts converged. Which of several converged restarts
        # ranks best is decided by f32 rounding (their scores tie at the
        # floor), so the best restart is held to be the same one only on the
        # targets with a single converged restart, and elsewhere the general
        # path's winner must be one the kernel path's score finds converged
        r = ranking_agreement(kernel, general_solver, x0, T)
        print(f"[general] {card}: chain k={k}, {T.shape[0]} targets x {API_RESTARTS} restarts, kernel path against "
              f"general path from the same starts: certified {(fk <= THRESH).double().mean().item():.5f} / "
              f"{(fg <= THRESH).double().mean().item():.5f}, both {both:.5f}, same verdict {verdict:.5f} (need >= "
              f"{GENERAL_VERDICT_FRAC}); restarts converged in both or neither {r['lanes_same']:.5f} (need >= "
              f"{RANK_LANES_MIN}), lanes by the kernels' score in decades from 1e-10 {[round(v, 5) for v in r['decades']]}; "
              f"same best restart {r['same_best']:.5f}, on the {r['single']:.5f} of targets with one converged restart "
              f"{r['same_best_single']:.5f} (need >= {RANK_SINGLE_MIN}), general path's winner converged by the kernels' "
              f"score {r['winner_converged']:.5f} (need >= {RANK_WINNER_MIN}); {wall_k:.3f} s ({launches}) against "
              f"{wall_g:.3f} s ({general} general call), peak {peak:.0f} MiB")
        check(verdict >= GENERAL_VERDICT_FRAC, f"chain k={k}: the two paths certify different targets")
        check(r["lanes_same"] >= RANK_LANES_MIN and r["same_best_single"] >= RANK_SINGLE_MIN
              and r["winner_converged"] >= RANK_WINNER_MIN, f"chain k={k}: the two paths rank the restarts differently")
        check(all(v == 1 for v in launches.values()) and general == 1, f"chain k={k}: launches {launches}, general {general}")
        check((general_solver.certify(xg, T)[fg <= THRESH] <= THRESH + CERT_ATOL).all(), "general path's cost is not its x's")


def _trace_infidelity(target, U):
    return 1.0 - abs(np.trace(np.asarray(target).conj().T @ U)) / 4.0


def device_launches(fn):
    """(device kernels launched, device seconds) of fn() under torch.profiler
    (after one warm call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    return sum(e.count for e in device), sum(e.device_time_total for e in device) / 1e6


def driven_parity(card):
    """13 (a): the propagators on the card against the port's CPU f64, the
    prefix products by doubling against the running product, the launches
    of one driven evaluation, Adam step and LM iteration (the class fit of
    improved_cx at 32 lanes), and the Monte-Carlo sampler's seconds."""
    from slam_decomposition_torch.explore.smush_volume import NAMED_GATES, sample_smush_coords
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models.trajectory import prefix_products, smush_prefix_unitaries
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import makhlin_residual

    dev = torch.device("cuda")
    rng = np.random.default_rng(13)
    x = rng.uniform(-4 * np.pi, 4 * np.pi, (4096, 10))  # drives to the sampler's largest bound
    xs = [torch.as_tensor(x, device=d) for d in (dev, "cpu")]
    U = [ham.smush_u(a[:, 0], a[:, 1], np.pi / 4, np.pi / 4, a[:, 2:6], a[:, 6:], t=1.0) for a in xs]
    err_u = (U[0].cpu() - U[1]).abs().max().item()
    gx, gy = rng.uniform(-4, 4, (2, 64))
    psi = torch.zeros(4, dtype=torch.complex128)
    psi[1] = 1.0
    S = [ham.evolve_smush(0.3, 0.1, np.pi / 2, 0.2, torch.as_tensor(gx, device=d), torch.as_tensor(gy, device=d),
                          psi.to(d)) for d in (dev, "cpu")]
    err_s = (S[0].cpu() - S[1]).abs().max().item()
    P = [smush_prefix_unitaries(0.3, 0.1, np.pi / 2, 0.2, gx, gy, device=d) for d in (dev, "cpu")]
    err_p = (P[0].cpu() - P[1]).abs().max().item()
    # the prefix products: log-depth doubling against the running product,
    # on one explorer trajectory (50 slices) and on 4096 pulses of 64 slices
    times = {}
    for label, Us in (("50", ham.smush_slices(0.3, 0.1, np.pi / 2, 0.2, torch.as_tensor(gx[:50], device=dev),
                                              torch.as_tensor(gy[:50], device=dev))),
                      ("4096x64", ham.smush_slices(0.0, 0.0, np.pi / 2, 0.0, torch.as_tensor(
                          rng.uniform(-4, 4, (4096, 64)), device=dev), torch.zeros(4096, 64, device=dev,
                                                                                   dtype=torch.float64)))):
        def running(Us=Us):
            out = [Us[..., 0, :, :]]
            for i in range(1, Us.shape[-3]):
                out.append(Us[..., i, :, :] @ out[-1])
            return torch.stack(out, dim=-3)

        (pd, ms_d), (pr, ms_r) = timed_ms(lambda Us=Us: prefix_products(Us)), timed_ms(running)
        check((pd - pr).abs().max().item() <= DRIVEN_PARITY_ATOL, f"prefix products {label}: doubling != running")
        times[label] = (ms_d, ms_r)
    print(f"[driven] {card}: (a) smush_u 4096 x 4 slices (drives to 4 pi) card vs CPU f64 max|d| {err_u:.3e}, "
          f"evolve_smush 64 slices {err_s:.3e}, smush_prefix_unitaries 64 slices {err_p:.3e} (need <= "
          f"{DRIVEN_PARITY_ATOL:g}); prefix products, doubling against the running product: "
          + ", ".join(f"{k} slices {d:.3f} / {r:.3f} ms" for k, (d, r) in times.items()))
    check(max(err_u, err_s, err_p) <= DRIVEN_PARITY_ATOL, "driven propagators on the card differ from the CPU's")
    # launches of the class fit's pieces at improved_cx's 32 lanes
    x32 = torch.as_tensor(rng.uniform(-4, 4, (32, 10)), device=dev)
    cnot = torch.as_tensor(gates.CNOT.to_numpy(), device=dev).expand(32, 4, 4)

    def pulse(x):
        return ham.smush_u(x[..., 0], x[..., 1], np.pi / 2, 0.0, x[..., 2:6], x[..., 6:], t=1.0)

    def adam_step():
        xg = x32.float().detach().requires_grad_(True)
        r = makhlin_residual(pulse, xg, cnot.to(torch.complex64))
        torch.autograd.grad((r * r).sum(), xg)

    def lm_iteration():
        ck.lm_loop(lambda a: makhlin_residual(pulse, a, cnot), lambda a: makhlin_residual(pulse, a, cnot), x32, 1)

    reads = {name: device_launches(fn) for name, fn in
             (("evaluation", lambda: pulse(x32)), ("Adam step", adam_step), ("LM iteration", lm_iteration))}
    print(f"[driven] {card}: (a) launches at 32 lanes, 4 slices (torch.profiler): "
          + ", ".join(f"{k} {n} kernels, {s * 1e3:.3f} ms device" for k, (n, s) in reads.items())
          + f"; the class fit's 400 Adam steps + 32 LM iterations ~ "
          f"{400 * reads['Adam step'][0] + 32 * reads['LM iteration'][0]} kernels")
    gc, gg, t, _ = NAMED_GATES["iSwap"]
    sample_smush_coords(gc, gg, t, 1, 30, device=dev)  # warm
    for k in SMUSH_SAMPLE_KS:
        t0 = time.perf_counter()
        c = sample_smush_coords(gc, gg, t, k, SMUSH_SAMPLES, seed=k, device=dev)
        torch.cuda.synchronize()
        print(f"[driven] {card}: (a) sample_smush_coords iSwap k={k} {SMUSH_SAMPLES} samples "
              f"{time.perf_counter() - t0:.3f} s")
        check(c.shape == (SMUSH_SAMPLES, 3) and np.isfinite(c).all(), f"sample_smush_coords k={k}")


def driven_solves(card, counted, stats):
    """13 (b)-(f): the pulse solves and the circulator synthesis."""
    from slam_decomposition_torch.config import data_dir
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models import trajectory as traj
    from slam_decomposition_torch.models.templates import hamiltonian_ansatz
    from slam_decomposition_torch.opt.optimizer import TemplateOptimizer

    def line(part, what, wall, launches, general, peak, extra=""):
        print(f"[driven] {card}: ({part}) {what}: {extra}{wall:.3f} s, kernel launches {launches}, general-solver "
              f"calls {general}, peak device memory {peak:.0f} MiB")

    # (b) the parallel-driven CX: one application + exact locals
    cnot = gates.CNOT.to_numpy()
    for seed in DRIVEN_SEEDS:
        (x, loss, locs), wall, launches, general, peak = counted(
            lambda: traj.improved_cx(seed=seed, restarts=DRIVEN_RESTARTS))
        rebuilt = _trace_infidelity(cnot, traj.evaluate_drive_sequence(x, [1.0], np.pi / 2, 0.0, 4, locs))
        line("b", f"improved_cx seed {seed}, {DRIVEN_RESTARTS} restarts", wall, launches, general, peak,
             f"loss {loss:.3e}, locals rebuild CNOT at trace infidelity {rebuilt:.3e} (need <= {DRIVEN_CERT:g}), "
             f"path general, ")
        check(loss <= DRIVEN_CERT and rebuilt <= DRIVEN_CERT, f"improved_cx seed {seed}: loss {loss}, rebuilt {rebuilt}")
        check_counts(f"improved_cx seed {seed}", launches, general, 0, 1)
    # (c) the exact SWAP: three zero-drive pulses, the chain kernels at K = 3
    swap = gates.SWAP.to_numpy()
    (p, loss, locs), wall, launches, general, peak = counted(
        lambda: traj.improved_swap(exact=True, restarts=SWAP_EXACT_RESTARTS))
    U = traj.evaluate_drive_sequence(p, [0.5, 0.5, 0.5], np.pi / 2, 0.0, 4, locs)
    rebuilt = _trace_infidelity(swap, U)
    line("c", f"improved_swap(exact=True), {SWAP_EXACT_RESTARTS} restarts", wall, launches, general, peak,
         f"loss {loss:.3e}, locals rebuild SWAP at {rebuilt:.3e}, path kernels, ")
    check(loss <= DRIVEN_CERT and rebuilt <= DRIVEN_CERT, f"improved_swap exact: loss {loss}, rebuilt {rebuilt}")
    check_counts("improved_swap exact", launches, general, 1, 0)
    zero = np.zeros(4)
    pd_sq = gates._const_gate("pd_sq_zero", 2, ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, zero, zero, t=0.5).numpy())
    phase_parity(stats, ks=(3,), targets=1, restarts=SWAP_EXACT_RESTARTS, tag="_pdswap", gate=pd_sq)
    # (d) the golden two-pulse SWAP
    art = json.loads((data_dir() / "improved_swap_2pulse.json").read_text())
    locs = [np.array([[complex(re, im) for re, im in row] for row in L]) for L in art["locals"]]
    golden = _trace_infidelity(swap, traj.evaluate_drive_sequence(
        art["params"], art["plan"], art["gc"], art["gg"], art["n_slices"], locs))
    print(f"[driven] {card}: (d) golden improved_swap_2pulse.json through evaluate_drive_sequence: trace infidelity "
          f"{golden:.3e} (need < {DRIVEN_CERT:g})")
    check(golden < DRIVEN_CERT, f"golden artifact {golden}")
    # (e) the two-pulse SWAP solved fresh
    (x, loss, locs), wall, launches, general, peak = counted(lambda: traj.improved_swap_two_pulse(seed=0))
    rebuilt = _trace_infidelity(swap, traj.evaluate_drive_sequence(x, [1.0, 1.0], np.pi / 2, 0.0, 4, locs))
    line("e", "improved_swap_two_pulse seed 0", wall, launches, general, peak,
         f"loss {loss:.3e}, locals rebuild SWAP at {rebuilt:.3e} (need <= {DRIVEN_CERT:g}), path general, ")
    check(loss <= DRIVEN_CERT and rebuilt <= DRIVEN_CERT, f"improved_swap_two_pulse: loss {loss}, rebuilt {rebuilt}")
    check(all(v == 0 for v in launches.values()) and general in (1, 2), f"two-pulse: {launches}, {general}")
    # (f) VSWAP from the circulator's own parameters
    ansatz = hamiltonian_ansatz(
        lambda p1, p2, p3, g1, g2, g3, t: ham.circulator_u(p1, p2, p3, g1, g2, g3, t=t), 7,
        lower=np.array([-np.pi, -np.pi, -np.pi, 0, 0, 0, 0.5]), upper=np.array([np.pi, np.pi, np.pi, 1.5, 1.5, 1.5, 1.5]),
        n_qubits=3,
    )
    opt = TemplateOptimizer(ansatz, objective="square", training_restarts=12, override_fail=True, max_iters=300)
    res, wall, launches, general, peak = counted(lambda: opt.approximate_target_U(gates.vswap().to_numpy()))
    line("f", "VSWAP from hamiltonian_ansatz(circulator_u, 7), 12 restarts", wall, launches, general, peak,
         f"loss {res.loss[0]:.3e} (need < {VSWAP_LOSS_MAX:g}), path {opt.solver_paths[1]}, ")
    check(res.loss[0] < VSWAP_LOSS_MAX, f"VSWAP loss {res.loss[0]}")
    check_counts("vswap", launches, general, 0, 1)


def driven_oct(card, counted):
    """13 (g): GRAPE on CNOT."""
    from slam_decomposition_torch.explore.oct import make_smush_eval, optimize_pulses
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.ops import weyl

    cnot = gates.CNOT.to_numpy()
    ev = make_smush_eval(np.pi / 2, 0.0, n_slices=8)
    res, wall, _, _, peak = counted(
        lambda: optimize_pulses(ev, 8, functional="hs", target=cnot, restarts=8, iters=300, seed=3))
    print(f"[driven] {card}: (g) GRAPE hs CNOT, 8 restarts x 300 iterations, 8 slices: value {float(res.value):.4e} "
          f"(not gated), {wall:.3f} s, peak {peak:.0f} MiB")
    check(np.isfinite(res.value) and res.history.shape == (301,), "GRAPE hs")
    ev = make_smush_eval(np.pi / 2, 0.0, n_slices=16)
    res, wall, _, _, peak = counted(
        lambda: optimize_pulses(ev, 16, functional="li", target=cnot, restarts=8, iters=400, lr=0.15, seed=2))
    c = weyl.c1c2c3(res.U).cpu().numpy()
    print(f"[driven] {card}: (g) GRAPE li CNOT, 8 restarts x 400 iterations, 16 slices: value {float(res.value):.4e} "
          f"(need < 1e-3), coordinates {np.round(c, 5).tolist()} (need within 0.05 of [0.5, 0, 0]), {wall:.3f} s, "
          f"peak {peak:.0f} MiB")
    check(float(res.value) < 1e-3 and np.abs(c - [0.5, 0.0, 0.0]).max() <= 0.05, "GRAPE li does not reach CNOT's class")


def driven_coverage(card, counted):
    """13 (h): extend_coverage of the named gates EXTENDED_GATES against
    extended_results.json."""
    from slam_decomposition_torch.config import data_dir
    from slam_decomposition_torch.explore.smush_volume import extend_coverage

    want = json.loads((data_dir() / "extended_results.json").read_text())
    t_phase = time.perf_counter()
    for name in EXTENDED_GATES:
        res, wall, launches, general, peak = counted(lambda: extend_coverage(name, save=False))
        rows = []
        for k, row in want[name].items():
            got = res[k]
            lim = max(EXT_VOL_ATOL, EXT_VOL_SPREAD.get((name, k), 0.0))
            ok = (got[2:] == row[2:] and abs(got[1] - row[1]) <= lim and abs(got[0] - row[0]) <= EXT_BASE_ATOL)
            rows.append(f"k={k} base {got[0]:.6f} ext {got[1]:.6f} (file {row[1]:.6f}, limit {lim:g}) "
                        f"cnot/swap/b {got[2:]} (file {row[2:]}){'' if ok else ' MISMATCH'}")
            check(ok, f"extend_coverage {name} k={k}: {got} against {row}")
        print(f"[driven] {card}: (h) extend_coverage {name}: {wall:.3f} s, peak {peak:.0f} MiB; " + "; ".join(rows))
    print(f"[driven] {card}: (h) {len(EXTENDED_GATES)} gates in {time.perf_counter() - t_phase:.1f} s")


def phase_driven(card, counted, stats):
    """13. The driven (Trotter) path: (a) propagators, prefix products,
    launches and the sampler; (b)-(f) the pulse solves and the circulator;
    (g) GRAPE; (h) the extended coverage."""
    t0 = time.perf_counter()
    driven_parity(card)
    t1 = time.perf_counter()
    driven_solves(card, counted, stats)
    t2 = time.perf_counter()
    driven_oct(card, counted)
    t3 = time.perf_counter()
    driven_coverage(card, counted)
    t4 = time.perf_counter()
    print(f"[driven] {card}: phase {t4 - t0:.1f} s: (a) {t1 - t0:.1f}, (b)-(f) {t2 - t1:.1f}, (g) {t3 - t2:.1f}, "
          f"(h) {t4 - t3:.1f}")


def slam_fit_checks(stats, blocks):
    """Per structure group: fitted no fewer than the JAX package's less
    SLAM_FIT_SLACK of the group, and every fitted block rebuilding its
    block's unitary within SLAM_BLOCK_DIST."""
    check(sorted(g["applications"] for g in stats) == sorted(SLAM_JAX_FITS),
          f"structure groups {[g['applications'] for g in stats]}, expected {sorted(SLAM_JAX_FITS)}")
    worst = 0.0
    for g in stats:
        j_fit, j_blocks = SLAM_JAX_FITS[g["applications"]]
        least = math.ceil(j_fit - SLAM_FIT_SLACK * j_blocks)
        for i, sub in g["circuits"].items():
            U, V = blocks[i].unitary, sub.to_matrix()
            worst = max(worst, 1 - abs(np.trace(V.conj().T @ U)) / 4)
        print(f"[slam] group of {g['applications']} winner applications: {g['blocks']} blocks (JAX {j_blocks}), "
              f"fitted {g['fitted']} (JAX {j_fit}, need >= {least}), worst certified cost {g['worst']:.3e}, "
              f"path {g['path']}, {g['seconds']:.3f} s")
        check(g["blocks"] == j_blocks and g["fitted"] >= least and g["path"] == "kernels",
              f"group of {g['applications']}: {g['fitted']} of {g['blocks']} fitted on {g['path']}")
    check(worst <= SLAM_BLOCK_DIST, f"a fitted block is {worst:.3e} from its unitary (limit {SLAM_BLOCK_DIST:g})")
    return worst


def phase_slam(card, counted, stats):
    """14. The speed-limit transpilation path: (a) the kernels on the 0.25
    winner's chain at QFT-64's lanes; (b) winner selection; (c)
    pass_manager_slam(qft(64), fit_1q=True) cold and warm, counted; (d) the
    headline rows, the reduced protocol against the JAX package's values."""
    from slam_decomposition_torch.explore.candidates import load_candidates
    from slam_decomposition_torch.explore.scaling import atomic_cost_scaling
    from slam_decomposition_torch.explore.winners import pick_winner
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.tools import headline
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.ir import unroll_3q_or_more
    from slam_decomposition_torch.transpile.passes import pass_manager_slam
    from slam_decomposition_torch.transpile.route import grid_coupling, route

    t0 = time.perf_counter()
    winner = gates.conversion_gain_gate(*SLAM_WINNERS[SLAM_D1Q][0])
    for k, (_, blocks) in sorted(SLAM_JAX_FITS.items()):
        phase_parity(stats, ks=(k,), targets=blocks, restarts=SLAM_RESTARTS, tag="_slam", gate=winner)
    t1 = time.perf_counter()

    bare = {tuple(p): s for p, s in load_candidates()}
    for d1q, (params, duration, score) in SLAM_WINNERS.items():
        g, scaled = pick_winner(f"linear_scaling_1q{d1q}", metric=0, device="cuda")
        got = float(atomic_cost_scaling(g.params, bare[tuple(g.params)][0], "linear", d1q)[1])
        print(f"[slam] pick_winner linear_scaling_1q{d1q}: {tuple(float(p) for p in g.params)}, scaled duration "
              f"{scaled.duration}, score {got!r} (JAX {params}, {duration}, {score!r})")
        check(np.allclose(g.params, params, rtol=0, atol=1e-12) and scaled.duration == duration
              and abs(got - score) <= 1e-12, f"pick_winner linear_scaling_1q{d1q} differs from the JAX package's")
    t2 = time.perf_counter()

    qft = library.qft(QFT_Q)
    blocks = consolidate_2q_blocks(unroll_3q_or_more(qft))
    walls = {}
    for run in ("cold", "warm"):
        fit_stats = []
        (out, m), wall, launches, general, peak = counted(
            lambda: pass_manager_slam(qft, duration_1q=SLAM_D1Q, fit_1q=True, device="cuda", stats=fit_stats))
        walls[run] = wall
        print(f"[slam] {card}: pass_manager_slam(qft({QFT_Q}), duration_1q={SLAM_D1Q}, fit_1q=True) {run} "
              f"{wall:.3f} s (the fit {sum(g['seconds'] for g in fit_stats):.3f} s of it), peak {peak:.0f} MiB: "
              f"duration {m['duration']} (ref metric {m['duration_ref_metric']}), gates {m['gate_counts']}, "
              f"depth {m['depth']}; launches {launches}, general-solver calls {general}")
        check(m["duration"] == SLAM_DURATION and m["gate_counts"] == SLAM_GATES,
              f"qft({QFT_Q}) SLAM pass: duration {m['duration']}, gates {m['gate_counts']}")
        check_counts(f"slam {run}", launches, general, len(fit_stats), 0)
        worst = slam_fit_checks(fit_stats, blocks)
        print(f"[slam] {run}: every fitted block within {worst:.3e} of its unitary")
    t3 = time.perf_counter()

    db, do = headline.gate_duration(gates.SWAP.to_numpy(), "cuda")
    c = route(library.vqe_linear(16, seed=0), grid_coupling(4, 4), seed=0, rows_cols=(4, 4))
    mb, mo = headline.managers(c, "cuda")
    print(f"[slam] headline SWAP {db} -> {do} (2.5 -> 2.25); VQE(Linear)-16 seed 0 {mb['duration']} -> "
          f"{mo['duration']} (25.75 -> 21.5)")
    check((db, do) == (2.5, 2.25) and abs(mb["duration"] - 25.75) <= 1e-9 and abs(mo["duration"] - 21.5) <= 1e-9,
          "headline SWAP / VQE(Linear)-16 rows differ")
    res = headline.main(*HEADLINE_REDUCED, device="cuda", log=lambda line: print(f"[slam] headline {line}"))
    for row, want in HEADLINE_JAX.items():
        for key, val in want.items():
            check(abs(res[row][key] - val) <= 1e-9, f"headline {row} {key}: {res[row][key]!r}, JAX {val!r}")
    t4 = time.perf_counter()
    print(f"[slam] {card}: QFT-{QFT_Q} fit_1q wall clock cold {walls['cold']:.3f} s, warm {walls['warm']:.3f} s")
    print(f"[slam] {card}: phase {t4 - t0:.1f} s: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, "
          f"(d) {t4 - t3:.1f}")


def pd_split(stats):
    """(exact blocks, {m: (fitted, blocks)}, (fitted, blocks) of the
    fallback) of one fit_substituted_pd run's records."""
    exact = sum(r["blocks"] for r in stats if r["stage"] == "exact")
    fits = {r["m"]: (r["fitted"], r["blocks"]) for r in stats if r["stage"] == "class_fit"}
    fb = [(r["fitted"], r["blocks"]) for r in stats if r["stage"] == "fallback"]
    return exact, fits, fb[0] if fb else (0, 0)


def pd_fit_checks(card, label, stats, blocks, launches, general, want):
    """One fit_substituted_pd run against the CPU's split ``want``: the exact
    path equal, each class-fit group's blocks equal and its fitted blocks no
    fewer than the CPU's less PD_FIT_SLACK of the group, every block that
    does not fit there in the fallback, placeholders no more than the CPU's
    plus PD_FALLBACK_SLACK of its fallback blocks, the fallback on the chain
    kernels at one launch of each, one general-solver call per class-fit
    group and one more per group with failures (its rescue), and every
    fitted block rebuilding its block's unitary within PD_BLOCK_DIST.
    Returns the fallback's blocks and the worst distance."""
    exact, fits, (fb_fit, fb_blocks) = pd_split(stats)
    w_exact, w_fits, w_fb = want["exact"], want["class_fit"], want["fallback"]
    worst = 0.0
    for r in stats:
        for i, sub in r["circuits"].items():
            U, V = blocks[i].unitary, sub.to_matrix()
            worst = max(worst, 1 - abs(np.trace(V.conj().T @ U)) / 4)
    placeholders = fb_blocks - fb_fit
    print(f"[pd] {card}: {label}: {len(blocks)} blocks: exact path {exact} (CPU {w_exact}), "
          + ", ".join(f"class fit m={m} {f} of {b} (CPU {w_fits.get(m)})" for m, (f, b) in sorted(fits.items()))
          + f", fallback {fb_fit} of {fb_blocks} (CPU {tuple(w_fb)}), placeholders {placeholders}; every fitted block "
          f"within {worst:.3e} of its unitary (need <= {PD_BLOCK_DIST:g})")
    for r in stats:
        extra = f", stages {{{', '.join(f'{k}: {v:.3f}' for k, v in r['stage_seconds'].items())}}}" \
            if "stage_seconds" in r else ""
        rescue = f" ({r['failed']} failed the polish, {r['rescued']} of them rescued)" if "failed" in r else ""
        print(f"[pd] {card}: {label}: {r['stage']}{' m=' + str(r['m']) if 'm' in r else ''}: {r['blocks']} blocks, "
              f"fitted {r['fitted']}{rescue}, path {r['path']}, {r['seconds']:.3f} s{extra}")
    check(exact == w_exact, f"{label}: {exact} blocks on the exact path, the CPU {w_exact}")
    check(sorted(fits) == sorted(w_fits), f"{label}: class-fit groups {sorted(fits)}, the CPU {sorted(w_fits)}")
    for m, (f, b) in fits.items():
        least = math.ceil(w_fits[m][0] - PD_FIT_SLACK * w_fits[m][1])
        check(b == w_fits[m][1] and f >= least, f"{label}: m={m} fitted {f} of {b}, need >= {least} of {w_fits[m][1]}")
    check(fb_blocks == sum(b - f for f, b in fits.values()), f"{label}: fallback blocks {fb_blocks}")
    most = math.floor(w_fb[1] - w_fb[0] + PD_FALLBACK_SLACK * w_fb[1])
    check(placeholders <= most, f"{label}: {placeholders} placeholders, need <= {most} (the CPU {w_fb[1] - w_fb[0]})")
    check(all(r["path"] == "general" for r in stats if r["stage"] == "class_fit"), f"{label}: a class fit off the general path")
    want_general = sum(1 + (r["failed"] > 0) for r in stats if r["stage"] == "class_fit")
    check_counts(f"{label} fit", launches, general, 1 if fb_blocks else 0, want_general)
    check(worst <= PD_BLOCK_DIST, f"{label}: a fitted block is {worst:.3e} from its unitary (limit {PD_BLOCK_DIST:g})")
    return fb_blocks, worst


def phase_pd_fit(card, counted, stats):
    """15. The parallel-drive pass with its driven fit: (a) QFT-64 through
    pass_manager_optimized_sqiswap(fit_1q=True) cold and warm, counted; (b)
    the kernels against their plain versions on the fallback's chain at its
    lanes; (c) QV-16 routed on the 4x4 grid at seed 0, once, counted; (d)
    certify_frontier.certify_row on B k = 1."""
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models import hamiltonians as ham
    from slam_decomposition_torch.models.trajectory import _eval_np
    from slam_decomposition_torch.explore.smush_volume import NAMED_GATES, _smush_eval
    from slam_decomposition_torch.opt.costs import makhlin_functional_cost
    from slam_decomposition_torch.tools import certify_frontier
    from slam_decomposition_torch.transpile import library
    from slam_decomposition_torch.transpile.consolidate import consolidate_2q_blocks
    from slam_decomposition_torch.transpile.ir import unroll_3q_or_more
    from slam_decomposition_torch.transpile.passes import pass_manager_optimized_sqiswap
    from slam_decomposition_torch.transpile.route import grid_coupling, route

    def run(label, circ, tag):
        blocks = consolidate_2q_blocks(unroll_3q_or_more(circ))
        fit_stats = []
        (out, m), wall, launches, general, peak = counted(
            lambda: pass_manager_optimized_sqiswap(circ, duration_1q=PD_D1Q, fit_1q=True, device="cuda",
                                                   stats=fit_stats))
        print(f"[pd] {card}: {label}: pass_manager_optimized_sqiswap(duration_1q={PD_D1Q}, fit_1q=True) {wall:.3f} s "
              f"(the fit {sum(r['seconds'] for r in fit_stats):.3f} s of it), peak device memory {peak:.0f} MiB: "
              f"duration {m['duration']} (ref metric {m['duration_ref_metric']}), gates {m['gate_counts']}, depth "
              f"{m['depth']}; fallback launches {launches}, general-solver calls {general}")
        fb, _ = pd_fit_checks(card, label, fit_stats, blocks, launches, general, PD_SPLIT[tag])
        return wall, fb

    t0 = time.perf_counter()
    qft = library.qft(QFT_Q)
    walls = {}
    for run_name in ("cold", "warm"):
        walls[run_name], fb = run(f"QFT-{QFT_Q} {run_name}", qft, "qft64")
    t1 = time.perf_counter()
    zero = np.zeros(4)
    pd_sq = gates._const_gate("pd_sq_zero", 2, ham.smush_u(0.0, 0.0, np.pi / 2, 0.0, zero, zero, t=0.5).numpy())
    if fb:
        phase_parity(stats, ks=(3,), targets=fb, restarts=PD_RESTARTS, tag="_pdfb", gate=pd_sq)
    t2 = time.perf_counter()
    qv = route(library.qv(16, seed=0), grid_coupling(4, 4), seed=0, rows_cols=(4, 4))
    walls["qv"], _ = run("QV-16 seed 0", qv, "qv16")
    t3 = time.perf_counter()

    name, k, n = FRONTIER_ROW
    row, wall, launches, general, peak = counted(lambda: certify_frontier.certify_row(name, k, n, device="cuda",
                                                                                      detail=True))
    gc, gg, t, _ = NAMED_GATES[name]
    eval_fn, _ = _smush_eval(gc, gg, t, k)
    again = makhlin_functional_cost(torch.as_tensor(_eval_np(eval_fn, row["x"], "cpu")),
                                    torch.as_tensor(row["targets"])).numpy()
    err = float(np.abs(again - row["losses"])[row["certified"]].max()) if row["certified"].any() else 0.0
    print(f"[pd] {card}: (d) certify_row {name} k={k}: {row['frontier_sampled']} frontier targets, certified fraction "
          f"{row['certified_frac']} (JAX {FRONTIER_JAX_FRAC} at n = 100), median loss {row['median_loss']:.3e}, worst "
          f"{row['worst_loss']:.3e}, {row['rounds']} solve rounds, {row['seconds']} s, {wall:.3f} s in all, peak "
          f"{peak:.0f} MiB, general-solver calls {general}; certified losses against the CPU's f64 Makhlin functional "
          f"of x: max|d| {err:.3e} (need <= {FRONTIER_RECOMPUTE_ATOL:g})")
    check(row["frontier_sampled"] == n and np.isfinite(row["losses"]).all(), f"certify_row {name} k={k}: {row}")
    check(err <= FRONTIER_RECOMPUTE_ATOL, f"certify_row {name} k={k}: a certified loss is off by {err:.3e}")
    check_counts(f"certify_row {name} k={k}", launches, general, 0, row["rounds"])
    t4 = time.perf_counter()
    print(f"[pd] {card}: QFT-{QFT_Q} fit_1q wall clock cold {walls['cold']:.3f} s, warm {walls['warm']:.3f} s; QV-16 "
          f"{walls['qv']:.3f} s")
    print(f"[pd] {card}: phase {t4 - t0:.1f} s: (a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, "
          f"(d) {t4 - t3:.1f}")


def zero_polish_timing(stats, label, lanes, k=2):
    """The polish at zero iterations (the mesh's local-winner certificate)
    at ``lanes`` f64 lanes against its plain version, timed, under
    stats["polish_chain"][label]."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.tools.inputs import kernel_inputs
    from slam_decomposition_torch.utils import mfu

    g64, _, T, _, x0, _ = kernel_inputs(k, lanes, 1, torch.device("cuda")).values()
    x = x0.double().contiguous()
    (xp, f), ms = timed_ms(lambda: ck.polish_chain(x, T, g64, 0))
    (xp_ref, f_ref), plain_ms = timed_ms(lambda: ck.polish_chain_ref(x, T, g64, 0))
    err = (f - f_ref).abs().max().item()
    dx = (xp - xp_ref).abs().max().item()
    print(f"[parity] polish_chain zero iterations {label} L={lanes}: max|d||r||^2| {err:.3e}, max|dx| {dx:.3e} "
          f"(need <= {ZERO_POLISH_ATOL:g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(err <= ZERO_POLISH_ATOL and dx <= ZERO_POLISH_ATOL, f"polish_chain {label} disagrees with its plain version")
    st = stats["polish_chain"]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st[label] = {"lanes": lanes, "ms": ms, "plain_ms": plain_ms,
                 "bound": bound_line("polish_chain", label, mfu.polish_launch(k, lanes, 0), ms)}


def phase_mesh(card, counted, main, stats):
    """(a) the main path on a one-rank mesh, against phase 4's result; (b)
    the multi-chip dry run in MESH_RANKS ranks on this card; (c) the
    single-chip compile check; then the kernels at the mesh's shapes against their plain
    versions: the zero-iteration polish at (a)'s 10000 lanes ("k2_mesh1"),
    and (b)'s production shard at k = 2 ("k2_mesh4x1": 2048 Adam and LM
    lanes, 1024 polish lanes, and the zero-iteration polish at 1024)."""
    from slam_decomposition_torch import graft_entry
    from slam_decomposition_torch.parallel.mesh import make_mesh
    from slam_decomposition_torch.pipeline import decompose_haar

    # (a) a one-rank group, started by make_mesh(1)
    t0 = time.perf_counter()
    mesh = make_mesh(1)
    t_group = time.perf_counter() - t0
    try:
        print(f"[mesh] (a) one-rank mesh {mesh.shape}: backend {mesh.backend}, device {mesh.device}; group start-up "
              f"{t_group:.3f} s")
        r, wall, launches, general, peak = counted(
            lambda: decompose_haar(B=B, chunk=CHUNK, restarts=RESTARTS, thresh=THRESH, seed=SEED, mesh=mesh)
        )
    finally:
        mesh.close()
    hist = r.k_histogram()
    # per solved chunk (warm-up, k buckets, rescue rounds) one launch of Adam
    # and of the LM, and two of the polish: the local winner's zero-iteration
    # one, then the polisher's
    chunks = len(WANT_HIST) + sum(math.ceil(n / CHUNK) for n in [*hist.values(), *r.rescued])
    want = {"adam_chain": chunks, "lm_chain": chunks, "polish_chain": 2 * chunks}
    same = bool(np.array_equal(r.losses, main.losses))
    t = r.times
    print(f"[mesh] (a) k histogram {hist}; certified {r.n_certified}/{B}; rescued {r.rescued}; launches {launches} "
          f"(expected {want}); general-solver calls {general}; losses equal to phase main's bit for bit: {same}")
    print(f"[mesh] (a) {card}: ranges {t['ranges']:.3f} s, solve {t['solve']:.3f} s, rescue {t['rescue']:.3f} s, "
          f"total {t['total']:.3f} s -> {r.n_certified / t['total']:.1f} targets/s (phase main: total "
          f"{main.times['total']:.3f} s); call incl. warm-up {wall:.1f} s; peak device memory {peak:.0f} MiB")
    check(mesh.backend == "nccl", f"a one-rank group on the card runs {mesh.backend}, not nccl")
    check(hist == WANT_HIST, f"k histogram {hist} != {WANT_HIST}")
    check(r.n_certified == B, f"certified {r.n_certified} of {B}")
    check(same, "the one-rank mesh's losses differ from the unsharded main path's")
    check(launches == want and general == 0, f"launches {launches}, general {general}; expected {want}, 0")

    # (b) the dry run: MESH_RANKS ranks on this card over gloo, dp = 2, rp = 2
    t0 = time.perf_counter()
    ranks = graft_entry.dryrun_multichip(MESH_RANKS)
    t_dry = time.perf_counter() - t0
    bl, rl = 2048 // 2, 4 // 2  # the production stage's (B, R) over (dp, rp)
    lanes_want = {"adam_chain": [bl * rl], "lm_chain": [bl * rl], "polish_chain": [bl, bl]}
    for rk in ranks:
        print(f"[mesh] (b) rank {rk['rank']} {rk['index']} on {rk['device']} ({rk['backend']}): production lanes "
              f"{rk['production_shards']['lanes']}, its launches {rk['production_shards']['launches']}; the dry run's "
              f"launches {rk['launches']}; certified {rk['certified']:.4f}, agreement {rk['agreement']:.4f}, "
              f"max loss delta {rk['max_loss_delta']:.1e}")
        check(rk["backend"] == "gloo" and rk["device"] == "cuda:0", f"rank {rk['rank']} on {rk['device']}")
        check(rk["production_shards"]["launches"] == {"adam_chain": 1, "lm_chain": 1, "polish_chain": 2},
              f"rank {rk['rank']}'s production launches {rk['production_shards']['launches']}")
        check(all(v > 0 for v in rk["launches"].values()), f"rank {rk['rank']} launched {rk['launches']}")
        check(rk["production_shards"]["lanes"] == lanes_want, f"rank {rk['rank']} lanes {rk['production_shards']['lanes']}")
        check(rk["certified"] >= 0.5 and rk["agreement"] >= 0.999, f"rank {rk['rank']}: {rk}")
        for name in REPLACES:  # a rank reports its chain kernels' launches
            counted.total[name] += rk["launches"][name]
    print(f"[mesh] (b) {card}: dryrun_multichip({MESH_RANKS}) {t_dry:.1f} s, rank start-up included")

    # (c) the compile check: one batched cost and gradient
    fn, args = graft_entry.entry()
    cost, grad = fn(*args)
    torch.cuda.synchronize()
    print(f"[mesh] (c) entry(): cost {tuple(cost.shape)} on {cost.device}, gradient {tuple(grad.shape)}; "
          f"finite {bool(cost.isfinite().all() and grad.isfinite().all())}")
    check(cost.shape == (64,) and grad.shape == (64, args[0].shape[1]), "entry() shapes")
    check(bool(cost.isfinite().all()) and bool(grad.isfinite().all()), "entry() gave a non-finite cost or gradient")
    zero_polish_timing(stats, "k2_zero_mesh1", CHUNK)
    phase_parity(stats, ks=(2,), targets=bl, restarts=rl, tag="_mesh4x1")
    zero_polish_timing(stats, "k2_zero_mesh4x1", bl)


def topm_parity(stats, k, x0, lanes_t, T, g32, sched, m=TOPM_M):
    """Phase 17 (a)'s kernels against their plain versions on its own
    inputs: Adam's cost instance at the B * R lanes (its x the default
    instance's bit for bit, its cost the plain cost of that x, and the x
    held to the plain Adam as phase 3 does), then the LM at the B * m lanes
    ``keep_top_m`` keeps. Fills stats under "k<k>_topm_cost" and
    "k<k>_topm"."""
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import gather_restarts, keep_top_m
    from slam_decomposition_torch.tools.inputs import fresh_iterations
    from slam_decomposition_torch.utils import mfu

    L = x0.shape[0]
    s_lane = sched[:ADAM_PARITY_ITERS].contiguous()
    d = (ck.adam_chain(x0, lanes_t, g32, s_lane) - ck.adam_chain_ref(x0, lanes_t, g32, s_lane)).abs().amax(1)
    frac = (d <= ADAM_ATOL).float().mean().item()
    (xc, cost), ms = timed_ms(lambda: ck.adam_chain(x0, lanes_t, g32, sched, with_cost=True))
    (xr, cost_ref), plain_ms = timed_ms(lambda: ck.adam_chain_ref(x0, lanes_t, g32, sched, with_cost=True))
    same = torch.equal(xc, ck.adam_chain(x0, lanes_t, g32, sched))
    cerr = (cost - ck.square_cost(xc, lanes_t, g32)).abs().max().item()
    dfrac = abs((cost < 1e-2).float().mean().item() - (cost_ref < 1e-2).float().mean().item())
    label = f"k{k}_topm"
    print(f"[parity] adam_chain with_cost {label} L={L}: {ADAM_PARITY_ITERS} steps max|dx| {d.max().item():.3e}, "
          f"{frac:.5f} of lanes within {ADAM_ATOL:g} (need >= {ADAM_LANE_FRAC}); x equal to the default instance's: "
          f"{same}; max|cost - plain cost of its x| {cerr:.3e} (need <= {ADAM_WITH_COST_ATOL:g}); |d frac(cost<1e-2)| "
          f"{dfrac:.4f} (need <= {ADAM_COST_FRAC_TOL}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(frac >= ADAM_LANE_FRAC and same and cerr <= ADAM_WITH_COST_ATOL and dfrac <= ADAM_COST_FRAC_TOL,
          f"adam_chain with_cost {label} disagrees with its plain version")
    st = stats["adam_chain"]
    st["max_abs_err"] = max(st["max_abs_err"], d.max().item())
    st[f"{label}_cost"] = {"lanes": L, "ms": ms, "plain_ms": plain_ms, "bound": bound_line(
        "adam_chain with_cost", label, mfu.adam_launch(k, L, sched.shape[0], with_cost=True), ms)}

    B, R = T.shape[0], L // T.shape[0]
    xg = gather_restarts(xc.view(B, R, -1), keep_top_m(cost.view(B, R), m))
    tg = T.to(torch.complex64).repeat_interleave(m, dim=0).contiguous()
    (_, fl), ms = timed_ms(lambda: ck.lm_chain(xg, tg, g32))
    (_, fl_ref), plain_ms = timed_ms(lambda: ck.lm_chain_ref(xg, tg, g32))
    ok = torch.isclose(fl, fl_ref, rtol=LM_RTOL, atol=LM_ATOL).float().mean().item()
    err = (fl - fl_ref).abs().max().item()
    print(f"[parity] lm_chain {label} L={xg.shape[0]}: max|d||r||^2| {err:.3e}, {ok:.5f} of lanes within rtol "
          f"{LM_RTOL:g} atol {LM_ATOL:g} (need >= {LM_LANE_FRAC}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    check(ok >= LM_LANE_FRAC, f"lm_chain {label} disagrees with its plain version")
    st = stats["lm_chain"]
    st["max_abs_err"] = max(st["max_abs_err"], err)
    fresh = fresh_iterations(ck.lm_chain, xg, tg, g32, ck.LM32_ITERS)
    print(f"[bound] lm_chain {label}: {fresh:.3f} of {ck.LM32_ITERS} iterations per lane rebuild J")
    st[label] = {"lanes": xg.shape[0], "ms": ms, "plain_ms": plain_ms,
                 "bound": bound_line("lm_chain", label, mfu.lm_launch(k, xg.shape[0], ck.LM32_ITERS, fresh), ms)}


def phase_studies(card, counted, stats, main):
    """(a) make_solver's top_m at the main path's shapes; (b) the solve's
    phase split (tools/profile_solver.py); (c) the analytic warm start
    against the variational solve (tools/bench_analytic.py)."""
    from slam_decomposition_torch.models.gates import SQISWAP
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import make_solver
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.tools import bench_analytic, profile_solver

    dev = torch.device("cuda")
    U = haar_sample(B, seed=SEED)
    one = {"adam_chain": 1, "lm_chain": 1, "polish_chain": 1}
    for k in (2, 3):
        a = build_ansatz(cycle_gates([SQISWAP], k))
        T = torch.as_tensor(U[np.where(main.ks == k)[0][:CHUNK]]).to(dev).contiguous()
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + k)
        x0 = torch.rand((CHUNK, RESTARTS, a.n_params), generator=gen, device=dev, dtype=torch.float64) * (2 * math.pi)
        solvers = {m: make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=dev, top_m=m)
                   for m in (None, TOPM_M, RESTARTS)}
        runs = {}
        for m, solver in solvers.items():
            solver.solve(x0, T)  # warm
            (x, loss), wall, launches, general, _ = counted(lambda: solver.solve(x0, T))
            lanes = ck.lane_counts()
            want = {"adam_chain": [CHUNK * RESTARTS], "lm_chain": [CHUNK * (m or RESTARTS)], "polish_chain": [CHUNK]}
            gap = (loss - solver.certify(x, T)).abs().max().item()
            runs[m] = (x, loss, wall)
            print(f"[studies] (a) k={k} top_m={m}: certified {(loss <= THRESH).float().mean().item():.5f} of "
                  f"{CHUNK}; {wall:.4f} s; launches {launches}, lanes {lanes}; max|loss - f64 cost of its x| "
                  f"{gap:.3e} (need <= {CERT_ATOL:g}) [{card}]")
            check(launches == one and general == 0 and lanes == want,
                  f"top_m={m} k={k}: launches {launches}, lanes {lanes}, general {general}; expected {one}, {want}, 0")
            check(gap <= CERT_ATOL, f"top_m={m} k={k}: a loss is not the f64 cost of its x")
        same = torch.equal(runs[None][0], runs[RESTARTS][0]) and torch.equal(runs[None][1], runs[RESTARTS][1])
        print(f"[studies] (a) k={k}: top_m={RESTARTS} (= R) equal to top_m=None bit for bit (x and losses): {same}; "
              f"top_m={TOPM_M} {runs[TOPM_M][2]:.4f} s against {runs[None][2]:.4f} s, certified "
              f"{(runs[TOPM_M][1] <= THRESH).sum().item()} against {(runs[None][1] <= THRESH).sum().item()}")
        check(same, f"k={k}: top_m=R differs from top_m=None")
        lanes_t = T.to(torch.complex64).repeat_interleave(RESTARTS, 0).contiguous()
        topm_parity(stats, k, x0.view(-1, a.n_params).float().contiguous(), lanes_t, T,
                    torch.as_tensor(a.chain_gates).to(dev, torch.complex64), ck.adam_schedule(device=dev))

    reps = profile_solver.REPS
    prof, wall, launches, general, _ = counted(lambda: profile_solver.profile(PROFILE_B, 2, dev))
    print(profile_solver.table(prof, card), end="")
    n = 3 * (1 + 2 * reps)  # a variant: one warm, reps timed and reps instrumented solves
    check(launches == {name: n for name in REPLACES} and general == 0,
          f"profile_solver: launches {launches}, general {general}; expected {n} each, 0")
    print(f"[studies] (b) profile_solver B={PROFILE_B} k=2: {wall:.1f} s, launches {launches}")

    rows, wall, launches, general, _ = counted(lambda: bench_analytic.bench(ANALYTIC_CH, dev))
    for r in rows:
        print(f"[studies] (c) bench_analytic k={r['k']} chunk={r['chunk']} [{card}]: variational "
              f"{r['variational_s'] * 1e3:.3f} ms ({r['variational_certified']} certified) | analytic "
              f"{r['analytic_s'] * 1e3:.3f} ms ({r['analytic_certified']} certified, init {r['init_s'] * 1e3:.3f} ms) | "
              f"speedup x{r['speedup']:.2f}; max|loss - f64 cost of its x| {r['variational_loss_vs_f64']:.3e} / "
              f"{r['analytic_loss_vs_f64']:.3e} (need <= {CERT_ATOL:g})")
        check(max(r["variational_loss_vs_f64"], r["analytic_loss_vs_f64"]) <= CERT_ATOL,
              f"bench_analytic k={r['k']}: a loss is not the f64 cost of its x")
    want = {"adam_chain": 8, "lm_chain": 8, "polish_chain": 16}  # a k: 4 variational solves, 4 analytic
    check(launches == want and general == 0, f"bench_analytic: launches {launches}, general {general}; expected {want}")
    print(f"[studies] (c) bench_analytic: {wall:.1f} s, launches {launches}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke test runs on a GPU only", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, fn, *args):
        """fn(*args), its seconds kept under ``name`` for the result line."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = timed("device", phase_device)
        timed("build", phase_build)
        stats = {name: {"max_abs_err": 0.0} for name in REPLACES}
        timed("parity", phase_parity, stats)
        timed("generic", phase_generic_vs_instance, stats)
        timed("weyl", phase_weyl, stats)
        counts, main = timed("main", phase_main_path, card)
        t_counts, t_polish_err = timed("transpile", phase_transpile, card, main.n_certified / main.times["total"])
        stats["polish_chain"]["max_abs_err"] = max(stats["polish_chain"]["max_abs_err"], t_polish_err)
        counted = Counted()
        timed("api", phase_api, card, counted, stats)
        for basis in (QUARTER_ISWAP, EIGHTH_ISWAP, SIXTEENTH_ISWAP):
            timed(basis.tag, phase_basis, card, counted, stats, basis)
        timed("coverage", phase_coverage, card, counted, stats)
        timed("depth", phase_depth, card, counted, stats)
        timed("general", phase_general, card, counted)
        timed("driven", phase_driven, card, counted, stats)
        timed("slam", phase_slam, card, counted, stats)
        timed("pd_fit", phase_pd_fit, card, counted, stats)
        timed("mesh", phase_mesh, card, counted, main, stats)
        timed("studies", phase_studies, card, counted, stats, main)
        print(f"[result] launches of the API, quarter-, eighth- and sixteenth-iSwap, parallel-drive, depth, "
              f"general-solver, driven, SLAM, driven-fit, mesh (the mesh ranks' included) and studies runs: "
              f"{counted.total}")
        print(f"[result] seconds by phase: {seconds}")
        counts = {name: counts[name] + t_counts[name] + counted.total[name] for name in counts}
    except (SmokeFailure, ImportError, RuntimeError, subprocess.CalledProcessError) as e:
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": SOURCES[name],
            "source_generic": GENERIC_SOURCES[name],
            "replaces": REPLACES[name],
            "launches": counts[name],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": stats[name]["k2"]["ms"],
            "plain_ms": stats[name]["k2"]["plain_ms"],
            "bound_ms": stats[name]["k2"]["bound"]["bound_ms"],
            "bound_by": stats[name]["k2"]["bound"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes a per-lane solve
            "flops": stats[name]["k2"]["bound"]["flops"],
            "lanes": stats[name]["k2"]["lanes"],
            # the generic program against the k = 12 instance on the same lanes
            "ms_k12_generic": stats[name]["generic_k12"]["generic_ms"],
            "ms_k12_instance": stats[name]["generic_k12"]["instance_ms"],
            # the other instances and shapes: k3 at the main path's lanes, the
            # others at the lanes the API, quarter-, eighth- and
            # sixteenth-iSwap and depth phases launch (k13 and deeper: the
            # depth-generic programs)
            **{
                f"{key}_{label}": val
                for label, shape in stats[name].items()
                if label != "k2" and isinstance(shape, dict) and "bound" in shape
                for key, val in (
                    ("lanes", shape["lanes"]),
                    ("ms", shape["ms"]),
                    ("plain_ms", shape["plain_ms"]),
                    ("bound_ms", shape["bound"]["bound_ms"]),
                    ("flops", shape["bound"]["flops"]),
                )
            },
        }
        for name in REPLACES
    ]
    g = stats["gamma_eigenphases"]
    kernels.append({
        "name": "gamma_eigenphases", "route": "cuda", "source": "slam_decomposition_torch/csrc/weyl_coords.cu",
        "replaces": None,  # the JAX package's ops/eig.joint_diag has no Pallas kernel
        "launches": counts["gamma_eigenphases"], "max_abs_err": g["max_abs_err"], "ms": g["ms"],
        "plain_ms": g["plain_ms"], "bound_ms": g["bound"]["bound_ms"], "bound_by": g["bound"]["bound_by"],
        "library_ms": None, "flops": g["bound"]["flops"], "lanes": B,
    })
    print(f"[result] whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
