"""The analytic KAK warm start against the Adam multi-restart solve (JAX
scripts/bench_analytic.py), per chunk of CH targets of each sqiSwap depth
k = 2, 3:

  A. the variational ``make_solver`` (Adam x R = 4 restarts, the f32 LM
     ranking pass and the polish: the three chain kernels);
  B. ``make_analytic_solver(k).solve`` (the batched analytic init, then the
     polish kernel: no Adam, no restarts);
  C. the analytic init alone (``init_only``), to attribute B's time.

    python3 -m slam_decomposition_torch.tools.bench_analytic [CH] [--ks 2 3] [--device cuda|cpu]

Targets: ``haar_sample(3 CH, seed=7)`` bucketed by their sqiSwap depth (at
least 2), each bucket cut or cyclically filled to CH. Each time is the
median of 3 calls after a warm one, each ending in a synchronize. Reports
the certified count of A and B (loss <= 1e-10) beside the times, since a
faster path that certifies fewer targets is no gain, and the largest gap
between a returned loss and the f64 square cost of its x. The rows also go
to ``config.studies_dir()/bench_analytic.json``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.tools import card, synchronize, write_json

RESTARTS = 4
THRESH = 1e-10
REPS = 3


def timed(fn, device, reps=REPS):
    """(median seconds of ``reps`` calls after a warm one, the last output)."""
    out = fn()
    synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def buckets(ch: int, device) -> tuple:
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.opt.samplers import haar_sample

    coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=device)
    U = torch.as_tensor(haar_sample(3 * ch, seed=7)).to(device)
    ks = np.maximum(monodromy_ks_batch(coverage, U, device), 2)
    out = {}
    for k in (2, 3):
        idx = np.where(ks == k)[0]
        out[k] = np.resize(idx, ch) if len(idx) < ch else idx[:ch]
    return U, out


def bench(ch: int = 10_000, device=DEFAULT_DEVICE, ks=(2, 3)) -> list:
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.gauss_newton import make_analytic_solver, make_solver

    device = resolve_device(device)
    U, idx = buckets(ch, device)
    gen = torch.Generator(device=device)
    rows = []
    for k in ks:
        a = build_ansatz(cycle_gates([gates.SQISWAP], k))
        var = make_solver(a.eval_fn, a.n_params, chain_gates=a.chain_gates, device=device)
        ana = make_analytic_solver(k, device)
        T = U[torch.as_tensor(idx[k], device=device)].contiguous()
        gen.manual_seed(0)
        x0 = torch.rand((ch, RESTARTS, a.n_params), generator=gen, device=device, dtype=torch.float64) * (2 * math.pi)
        t_var, (x_var, bf_var) = timed(lambda: var(x0, T), device)
        t_ana, (x_ana, bf_ana) = timed(lambda: ana.solve(T), device)
        t_init, _ = timed(lambda: ana.init_only(T), device)
        rows.append({
            "k": k, "chunk": ch, "variational_s": t_var, "analytic_s": t_ana, "init_s": t_init,
            "variational_certified": int((bf_var <= THRESH).sum()), "analytic_certified": int((bf_ana <= THRESH).sum()),
            "speedup": t_var / t_ana,
            "variational_loss_vs_f64": float((bf_var - var.certify(x_var, T)).abs().max()),
            "analytic_loss_vs_f64": float((bf_ana - ana.base.certify(x_ana, T)).abs().max()),
        })
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("chunk", type=int, nargs="?", default=10_000)
    ap.add_argument("--ks", type=int, nargs="+", default=[2, 3], choices=[2, 3])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    a = ap.parse_args(argv)
    device = resolve_device(a.device)
    card_name = card(device)
    rows = bench(a.chunk, device, tuple(a.ks))
    for r in rows:
        print(f"k={r['k']} chunk={r['chunk']}: variational {r['variational_s'] * 1e3:8.1f} ms "
              f"({r['variational_certified']}/{r['chunk']} cert) | analytic {r['analytic_s'] * 1e3:8.1f} ms "
              f"({r['analytic_certified']}/{r['chunk']} cert, init {r['init_s'] * 1e3:.1f} ms) | "
              f"speedup x{r['speedup']:.2f} [{card_name}]")
        print(json.dumps({**r, "card": card_name}))
    write_json("bench_analytic.json", {"card": card_name, "rows": rows})
    return rows


if __name__ == "__main__":
    main()
