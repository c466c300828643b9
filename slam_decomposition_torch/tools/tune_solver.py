"""Solver throughput / convergence study (JAX scripts/tune_solver.py): per
configuration (R, adam_iters, lm32_iters, top_m, lm_iters), the first-pass
certified share and the steady-state wall clock of ``make_solver`` on N
exact-k Haar targets for k = 2 and 3 (sqiSwap chains, on the three chain
kernels on the card).

    python3 -m slam_decomposition_torch.tools.tune_solver [R ADAM_ITERS [LM32_ITERS [TOP_M [LM_ITERS [N [CHUNK]]]]]]
        [--device cuda|cpu] [--sweep] [--sweep-r 2 4 8] [--sweep-adam 100] [--sweep-top-m 0 1 2]

TOP_M = 0 means no restart cut; TOP_M = m runs the f32 LM ranking pass on
each target's m restarts of least cost after Adam (``make_solver``'s
``top_m``). The sample is the script's: ``haar_sample(3 N, seed=20260817)``,
each target's sqiSwap depth from the coverage set (at least 2), the first N
of each exact-k bucket, solved in chunks of CHUNK targets (the last padded
with copies of the bucket's first target), starts uniform in [0, 2 pi) from
a ``torch.Generator`` on the device (seed 0 for the warm pass, 1 for the
timed one). One warm pass, then one timed pass that ends in a synchronize.

One JSON line per k and configuration with the script's keys (``certify``
is always "f64": the port polishes in native f64), the card's name and
power limit (or "cpu"), and each kernel's launches and lanes in the timed
pass. ``--sweep`` runs the grid R x adam_iters x top_m (top_m <= R) in one
process. The lines also go to ``config.studies_dir()/tune_solver.jsonl``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import time

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import card, out_path, synchronize

SEED = 20260817
THRESH = 1e-10
DEFAULTS = (4, 100, 8, 0, 6, 10_000, 10_000)  # R, ADAM_ITERS, LM32_ITERS, TOP_M, LM_ITERS, N, CHUNK


def sample(n: int, device) -> tuple:
    """(targets (3n, 4, 4) on the device, {k: indices of the first n targets
    of exact depth k}) for k = 2, 3 (depth 0 and 1 count as 2)."""
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.opt.samplers import haar_sample

    coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=device)
    T = torch.as_tensor(haar_sample(3 * n, seed=SEED)).to(device)
    ks = np.maximum(monodromy_ks_batch(coverage, T, device), 2)
    return T, {k: np.where(ks == k)[0][:n] for k in (2, 3)}


def one_pass(solver, T, idx, R, chunk, seed, device) -> np.ndarray:
    """Every chunk launched before any loss is read; the losses of the
    bucket's targets (padding dropped)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    futs = []
    for s in range(0, len(idx), chunk):
        part = idx[s : s + chunk]
        valid = len(part)
        if valid < chunk:
            part = np.concatenate([part, np.repeat(part[:1], chunk - valid)])
        tgt = T[torch.as_tensor(part, device=device)]
        x0 = torch.rand((chunk, R, solver.n_params), generator=gen, device=device, dtype=torch.float64) * (2 * math.pi)
        _, bf = solver.solve(x0, tgt)
        futs.append((s, valid, bf))
    losses = np.empty(len(idx))
    for s, valid, bf in futs:
        losses[s : s + valid] = bf[:valid].cpu().numpy()
    synchronize(device)
    return losses


def run(T, buckets, R, adam_iters, lm32_iters, top_m, lm_iters, chunk, device, card_name) -> list:
    """The rows of one configuration, k = 2 then 3."""
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import make_solver

    rows = []
    for k, idx in buckets.items():
        a = build_ansatz(cycle_gates([gates.SQISWAP], k))
        solver = make_solver(a.eval_fn, a.n_params, adam_iters=adam_iters, lm32_iters=lm32_iters, lm_iters=lm_iters,
                             top_m=top_m if top_m > 0 else None, chain_gates=a.chain_gates, device=device)
        t0 = time.perf_counter()
        one_pass(solver, T, idx, R, chunk, 0, device)
        warmup = time.perf_counter() - t0
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        losses = one_pass(solver, T, idx, R, chunk, 1, device)
        dt = time.perf_counter() - t0
        n = len(idx)
        rows.append({
            "k": k, "R": R, "adam_iters": adam_iters, "lm32_iters": lm32_iters, "top_m": top_m, "lm_iters": lm_iters,
            "certify": "f64", "n": n, "chunk": chunk, "converged_frac": float((losses <= THRESH).mean()),
            "seconds": dt, "targets_per_s": n / dt, "warmup_s": warmup, "card": card_name, "path": solver.path,
            "launches": ck.launch_counts(), "lanes": ck.lane_counts(),
        })
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("args", nargs="*", type=int, help="R ADAM_ITERS LM32_ITERS TOP_M LM_ITERS N CHUNK")
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--sweep", action="store_true", help="run the grid of --sweep-r x --sweep-adam x --sweep-top-m")
    ap.add_argument("--sweep-r", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--sweep-adam", type=int, nargs="+", default=[100])
    ap.add_argument("--sweep-top-m", type=int, nargs="+", default=[0, 1, 2])
    a = ap.parse_args(argv)
    if len(a.args) > len(DEFAULTS):
        ap.error(f"at most {len(DEFAULTS)} positional arguments")
    R, adam, lm32, top_m, lm, n, chunk = (*a.args, *DEFAULTS[len(a.args):])
    device = resolve_device(a.device)
    card_name = card(device)
    T, buckets = sample(n, device)
    grid = [(R, adam, top_m)]
    if a.sweep:
        grid = [(r, it, m) for r, it, m in itertools.product(a.sweep_r, a.sweep_adam, a.sweep_top_m) if m <= r]
    rows = []
    path = out_path("tune_solver.jsonl")
    with path.open("a") as f:
        for r, it, m in grid:
            for row in run(T, buckets, r, it, lm32, m, lm, chunk, device, card_name):
                print(json.dumps(row), flush=True)
                f.write(json.dumps(row) + "\n")
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
