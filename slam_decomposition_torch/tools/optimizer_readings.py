"""Readings of the TemplateOptimizer on a CUDA card that chip_smoke.py does
not take on every run, and the comparisons both share.

    python -m slam_decomposition_torch.tools.optimizer_readings [--seeds 1 2] [--lbfgs-targets 200]
        [--readings api depth chain frac eighth sixteenth parallel]

Per seed of the random starts (chip_smoke.py runs seed 0 of the first two and
seed 9 of the third; its limits were set from these readings beside its own):

* the API phase: the README quick-start (sqiSwap templates, objective
  "square", spanning_range [2, 3], 5 restarts) on haar_sample(100000,
  seed=456): the success share, the seconds per depth, and how far outside
  the depth-2 region the depth-3 targets lie that were solved at depth 2;
* the depth phase's early exit: spanning_range [1, 2, 3] on sqiSwap, iSwap,
  CNOT and SWAP tiled to 1000 targets: the share of each gate's copies
  solved at its least depth (1, 2, 2, 3);
* the kernel path against the general path on the sqiSwap chain from the
  same starts (2000 Haar targets x 5 restarts): ``ranking_agreement``;
* the quarter-iSwap phase: TemplateOptimizer on conversion_gain_gate(0, 0,
  0, pi/8, 1) templates over each target's range (its monodromy depth to 6)
  on haar_sample(100000, seed=456): the success share, the cycles and the
  seconds per depth; then the depth-5 chain through both paths from the same
  starts (1000 of its depth-5 targets x 5 restarts): ``ranking_agreement``;
* the eighth-iSwap phase: the same on conversion_gain_gate(0, 0, 0, pi/16,
  1) templates over each target's range to 12, then the depth-8 chain on
  1000 depth-8 targets and the depth-10 chain on 500 targets of depth 9 or
  10 through both paths;
* the sixteenth-iSwap phase: the same on conversion_gain_gate(0, 0, 0,
  pi/32, 1) templates over each target's range to 24 (depths 13 and more
  run the depth-generic kernels), then the depth-13 chain on 1000 depth-13
  targets and the depth-16 chain on 500 targets of depth 15 or 16 through
  both paths;
* the parallel-drive phase: the same on conversion_gain_gate(0, 0, pi/8,
  pi/4, 1) templates (both drives on; no cached coverage set, so the
  port builds it) over each target's range to 3, then the depth-3 chain on
  1000 depth-3 targets through both paths.

Then the launch count of one L-BFGS solve: the CNOT basis at depth 3 on
haar_sample(N, seed=2) x 5 restarts under torch.profiler (after one warm
solve), giving the device kernels launched and the device time beside the
solve's batched evaluations and host reads. N is small because the profiler
keeps every event (~0.9M at N = 200).
"""

from __future__ import annotations

import argparse
import functools
import math
import subprocess
import sys
import time

import numpy as np
import torch

from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops.weyl import c1c2c3
from slam_decomposition_torch.opt.gauss_newton import ChainSolver, GeneralSolver, certificate
from slam_decomposition_torch.opt.optimizer import TemplateOptimizer
from slam_decomposition_torch.opt.samplers import haar_sample, sqiswap_count_batch

B, SEED = 100_000, 456
DEPTH_TILE, LEAST_DEPTHS = 250, (1, 2, 2, 3)
CHAIN_B, RESTARTS = 2000, 5
# conversion-gain bases: (g1, g2), the depths of their templates, and the
# chains (depth, targets, least monodromy depth) taken through both solver
# paths
BASES = {
    "frac": ((0.0, math.pi / 8), (2, 3, 4, 5, 6), ((5, 1000, 5),)),
    "eighth": ((0.0, math.pi / 16), tuple(range(2, 13)), ((8, 1000, 8), (10, 500, 9))),
    "sixteenth": ((0.0, math.pi / 32), tuple(range(2, 25)), ((13, 1000, 13), (16, 500, 15))),
    "parallel": ((math.pi / 8, math.pi / 4), (2, 3), ((3, 1000, 3),)),
}
# A restart counts as converged where its f32 score, as a square cost, is at
# or under this: converged restarts sit at the f32 floor (1e-7 to 1e-5), the
# others in local minima (the readings print how many lie between)
CONVERGED_COST = 1e-4


def _basis(gate):
    return lambda k: build_ansatz(cycle_gates([gate], k))


def depth2_excess(U: np.ndarray, dev) -> np.ndarray:
    """How far outside the region of depth-2 sqiSwap circuits each target of
    U (m, 4, 4) lies: |c3| - (min(c1, 1 - c1) - c2) of its Weyl coordinates,
    which the region bounds by 0."""
    c = c1c2c3(torch.as_tensor(U).to(dev)).cpu().numpy().reshape(-1, 3)
    return np.abs(c[:, 2]) - (np.minimum(c[:, 0], 1.0 - c[:, 0]) - c[:, 1])


def ranking_agreement(kernel: ChainSolver, general: GeneralSolver, x0: torch.Tensor, T: torch.Tensor) -> dict:
    """Steps 1-2 (Adam and the f32 LM) of both paths from the same starts x0
    (B, R, n) against T (B, 4, 4), restart by restart. Each path scores a
    restart in f32 (the kernels by ||r||^2, the general path by the square
    cost); a restart is converged where its score, as a square cost, is at
    most CONVERGED_COST. Shares, of lanes or of targets:

    ``lanes_same``: lanes converged in both paths or in neither;
    ``decades``: lanes by kernel score: <= 1e-10, then up to 1e-8, 1e-6,
    1e-4, 1e-2, and above;
    ``same_best``: targets whose best restart is the same one in both;
    ``single``: targets with exactly one converged restart in both paths,
    and ``same_best_single``: of those, the same best restart;
    ``winner_converged``: targets whose general-path winner is converged by
    the kernel path's score (or that have no converged restart there)."""
    _, sk = kernel.rank(x0, T)
    _, sg = general.rank(x0, T)
    cost_k, cost_g = certificate(sk.double()), sg.double()
    conv_k, conv_g = cost_k <= CONVERGED_COST, cost_g <= CONVERGED_COST
    best_k, best_g = sk.argmin(dim=1), sg.argmin(dim=1)
    rows = torch.arange(T.shape[0], device=T.device)
    single = (conv_k.sum(1) == 1) & (conv_g.sum(1) == 1)
    share = lambda m: m.double().mean().item()  # noqa: E731
    return {
        "lanes_same": share(conv_k == conv_g),
        "decades": torch.histogram(
            cost_k.flatten().clamp(1e-12, 1.0).log10().cpu(), torch.tensor([-12.0, -10, -8, -6, -4, -2, 0.0], dtype=torch.float64)
        )[0].div(cost_k.numel()).tolist(),
        "same_best": share(best_k == best_g),
        "single": share(single),
        "same_best_single": share((best_k == best_g)[single]) if single.any() else 1.0,
        "winner_converged": share(conv_k[rows, best_g] | ~conv_k.any(1)),
    }


def same_parameters(xa: torch.Tensor, xb: torch.Tensor, atol: float) -> float:
    """The share of rows of (B, n) angles equal within atol modulo 2 pi."""
    d = torch.remainder(xa - xb + math.pi, 2 * math.pi) - math.pi
    return (d.abs().amax(1) <= atol).double().mean().item()


def api_reading(seed: int) -> None:
    dev = torch.device("cuda")
    U = haar_sample(B, seed=SEED)
    opt = TemplateOptimizer(_basis(gates.SQISWAP), objective="square", spanning_range=[2, 3], override_fail=True, seed=seed)
    t0 = time.perf_counter()
    res = opt.approximate_from_distribution(U)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals, cnt = np.unique(res.cycles, return_counts=True)
    ks = np.maximum(monodromy_ks_batch(gate_set_to_coverage(gates.cg_sqiswap(), device=dev), U, dev), 2)
    early = np.where((res.cycles == 2) & (ks == 3) & res.success)[0]
    print(f"[api] seed={seed}: success {int(res.success.sum())}/{B}, cycles {dict(zip(vals.tolist(), cnt.tolist()))}, "
          f"{len(early)} depth-3 targets solved at depth 2, at most {depth2_excess(U[early], dev).max(initial=0.0):.3e} "
          "outside the depth-2 region, "
          + ", ".join(f"k={k} {t:.3f} s" for k, t in opt.k_seconds.items()) + f", call {wall:.3f} s")


def depth_reading(seed: int) -> None:
    zoo = np.stack([g.to_numpy() for g in (gates.SQISWAP, gates.ISWAP, gates.CNOT, gates.SWAP)])
    opt = TemplateOptimizer(_basis(gates.SQISWAP), spanning_range=[1, 2, 3], override_fail=True, seed=seed)
    res = opt.approximate_from_distribution(np.tile(zoo, (DEPTH_TILE, 1, 1)))
    cyc = res.cycles.reshape(DEPTH_TILE, 4)
    print(f"[depth] seed={seed}: sqiswap/iswap/cnot/swap x {DEPTH_TILE}: success {res.success.mean():.5f}, copies solved "
          f"at the least depth {LEAST_DEPTHS}: {(cyc == np.array(LEAST_DEPTHS)).sum(axis=0).tolist()}, below it "
          f"{int((cyc < np.array(LEAST_DEPTHS)).sum())}")


def chain_reading(seed: int) -> None:
    dev = torch.device("cuda")
    U = haar_sample(CHAIN_B, seed=seed)
    ks = np.maximum(sqiswap_count_batch(U, device=dev), 2)
    gen = torch.Generator()
    gen.manual_seed(seed)
    for k in (2, 3):
        a = _basis(gates.SQISWAP)(k)
        T = torch.as_tensor(U[ks == k]).to(dev)
        x0 = (torch.rand((T.shape[0], RESTARTS, a.n_params), generator=gen, dtype=torch.float64) * (2 * math.pi)).to(dev)
        kernel, general = ChainSolver(a.chain_gates), GeneralSolver(a.eval_fn, a.n_params)
        (xk, fk), (xg, fg) = kernel.solve(x0, T), general.solve(x0, T)
        r = ranking_agreement(kernel, general, x0, T)
        print(f"[chain] seed={seed} k={k}, {T.shape[0]} targets x {RESTARTS} restarts: same verdict at 1e-10 "
              f"{((fk <= 1e-10) == (fg <= 1e-10)).double().mean().item():.5f}; "
              + ", ".join(f"{name} {val:.5f}" if isinstance(val, float) else f"{name} {[round(v, 5) for v in val]}"
                          for name, val in r.items())
              + "; polished parameters equal modulo 2 pi within 1e-3 / 1e-6 / 1e-9 / 0: "
              + " / ".join(f"{same_parameters(xk, xg, t):.5f}" for t in (1e-3, 1e-6, 1e-9, 0.0)))


def basis_reading(seed: int, name: str) -> None:
    (g1, g2), depths, chains = BASES[name]
    dev = torch.device("cuda")
    q = gates.conversion_gain_gate(0, 0, g1, g2, 1.0)
    U = haar_sample(B, seed=SEED)
    ks = monodromy_ks_batch(gate_set_to_coverage(q, device=dev), U, dev)
    ranges = [list(range(max(int(k), min(depths)), max(depths) + 1)) for k in ks]
    opt = TemplateOptimizer(_basis(q), objective="square", spanning_range=list(depths), override_fail=True, seed=seed)
    t0 = time.perf_counter()
    res = opt.approximate_from_distribution(U, spanning_ranges=ranges)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vals, cnt = np.unique(res.cycles, return_counts=True)
    print(f"[{name}] seed={seed}: success {int(res.success.sum())}/{B}, cycles {dict(zip(vals.tolist(), cnt.tolist()))}, "
          + ", ".join(f"k={k} {t:.3f} s" for k, t in opt.k_seconds.items()) + f", call {wall:.3f} s")
    gen = torch.Generator()
    gen.manual_seed(seed)
    for k, targets, least in chains:
        a = _basis(q)(k)
        T = torch.as_tensor(U[(ks >= least) & (ks <= k)][:targets]).to(dev)
        x0 = (torch.rand((T.shape[0], RESTARTS, a.n_params), generator=gen, dtype=torch.float64) * (2 * math.pi)).to(dev)
        kernel, general = ChainSolver(a.chain_gates), GeneralSolver(a.eval_fn, a.n_params)
        (_, fk), (_, fg) = kernel.solve(x0, T), general.solve(x0, T)
        r = ranking_agreement(kernel, general, x0, T)
        print(f"[{name}] seed={seed} chain k={k}, {T.shape[0]} targets x {RESTARTS} restarts: same verdict at 1e-10 "
              f"{((fk <= 1e-10) == (fg <= 1e-10)).double().mean().item():.5f}; "
              + ", ".join(f"{key} {val:.5f}" if isinstance(val, float) else f"{key} {[round(v, 5) for v in val]}"
                          for key, val in r.items()))


READINGS = {
    "api": api_reading,
    "depth": depth_reading,
    "chain": chain_reading,
    **{name: functools.partial(basis_reading, name=name) for name in BASES},
}


def lbfgs_reading(targets: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    U = haar_sample(targets, seed=2)
    mk = lambda: TemplateOptimizer(_basis(gates.CNOT), spanning_range=[3], method="lbfgs", override_fail=True)  # noqa: E731
    mk().approximate_from_distribution(U)  # warm
    opt = mk()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = opt.approximate_from_distribution(U)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA")]
    st = opt.lbfgs_stats[0]
    print(f"[lbfgs] cnot k=3, haar {targets} x {opt.training_restarts} restarts: success {res.success.mean():.5f}, "
          f"{st['evals']} batched evaluations, {st['syncs']} host reads, {st['iters']} lane-iterations, "
          f"{sum(e.count for e in device)} device kernels launched, device time "
          f"{sum(e.device_time_total for e in device) / 1e6:.3f} s of {wall:.3f} s under the profiler")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description="TemplateOptimizer readings on a CUDA card")
    ap.add_argument("--seeds", type=int, nargs="*", default=[1, 2], help="seeds of the random starts")
    ap.add_argument("--lbfgs-targets", type=int, default=200, help="targets of the profiled L-BFGS solve (0: skip)")
    ap.add_argument("--readings", nargs="*", choices=list(READINGS), default=list(READINGS), help="readings per seed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("optimizer_readings: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    for seed in args.seeds:
        for name in args.readings:
            READINGS[name](seed)
    if args.lbfgs_targets:
        lbfgs_reading(args.lbfgs_targets)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
