"""dp-axis strong-scaling curve of the mesh (JAX scripts/scaling_curve.py):
the sharded solve (``sharded_solver``: B = 256 Haar targets, R = 8
restarts, Adam 120 + polish 6 on the k = 2 sqiSwap chain) and the sharded
k-assignment (``sharded_ks``) at a fixed total batch over dp = 1, 2, 4.

    python3 -m slam_decomposition_torch.tools.scaling_curve [--device cuda|cpu] [--ranks 4] [--out FILE.md]

One ``run_ranks`` group of ``--ranks`` processes; the mesh of each dp takes
its first dp ranks, the others wait. Each row: one warm call, then the mean
of 3 calls on the host clock (each ending in a synchronize and a barrier
of the mesh). On one card the ranks share it over gloo, so the curve
measures the mesh's overhead, not a speed-up, as the JAX script's virtual
mesh does; the per-rank shard shapes are the evidence of the division of
work. With a card a rank (NCCL) the same run measures the scaling.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE

B, R = 256, 8
ADAM, LM = 120, 6
DPS = (1, 2, 4)
REPS = 3


def _timed(fn, mesh):
    import torch.distributed as dist

    def run():
        out = fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        return out

    run()  # warm
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = run()
    return out, (time.perf_counter() - t0) / REPS


def curve_rank(n_ranks: int, device=DEFAULT_DEVICE) -> dict:
    """In one rank of an ``n_ranks`` group: the solve and ks rows of every dp
    in DPS up to ``n_ranks`` (rank 0's rows; every rank's shard shapes)."""
    import torch.distributed as dist

    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.parallel.mesh import make_mesh, sharded_ks, sharded_solver

    ansatz = build_ansatz([gates.SQISWAP] * 2)
    tgt = torch.as_tensor(haar_sample(B, seed=0))
    x0s = torch.as_tensor(np.random.default_rng(1).uniform(-np.pi, np.pi, (B, R, ansatz.n_params)))
    tk = haar_sample(B, seed=3)
    solve_rows, ks_rows = [], []
    for dp in (d for d in DPS if d <= n_ranks):
        mesh = make_mesh(dp, rp=1, device=device)
        if mesh is not None:
            solver = sharded_solver(ansatz, mesh, adam_iters=ADAM, lm_iters=LM)
            (_, bf), wall = _timed(lambda: solver.solve(x0s, tgt), mesh)
            solve_rows.append({
                "dp": dp, "wall_s": wall, "targets_per_s": B / wall, "per_rank_batch": B // dp,
                "shards": solver.shards["x0s"], "out_shard": solver.shards["out"],
                "lanes": solver.shards["lanes"], "launches": solver.shards["launches"],
                "median_loss": float(bf.median()), "backend": mesh.backend, "device": str(mesh.device),
            })
            coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=mesh.device)
            ks_fn = sharded_ks(coverage, mesh)
            ks, wall = _timed(lambda: ks_fn(tk), mesh)
            vals, counts = np.unique(ks, return_counts=True)
            ks_rows.append({"dp": dp, "wall_s": wall, "per_rank_batch": B // dp,
                            "k_histogram": {int(v): int(c) for v, c in zip(vals, counts)}})
        dist.barrier()
    return {"rank": dist.get_rank(), "solve": solve_rows, "ks": ks_rows}


def table(rows, card: str) -> str:
    solve, ks = rows[0]["solve"], rows[0]["ks"]
    lines = [
        "# dp-axis strong scaling of the mesh (slam_decomposition_torch)",
        "",
        f"{card}; backend {solve[0]['backend']}; fixed total batch B={B}, R={R} restarts, Adam {ADAM} + f32 LM 8 + "
        f"polish {LM}, k = 2 sqiSwap chain; host clock, mean of {REPS} calls after a warm one.",
        "",
        "| dp | wall (s) | targets/s | per-rank batch | rank 0's shard (B/dp, R, n) | Adam / LM lanes | polish lanes |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in solve:
        lines.append(f"| {r['dp']} | {r['wall_s']} | {r['targets_per_s']} | {r['per_rank_batch']} | "
                     f"{tuple(r['shards'])} | {r['lanes']['adam_chain']} / {r['lanes']['lm_chain']} | "
                     f"{r['lanes']['polish_chain']} |")
    lines += ["", "## k-assignment (sharded_ks)", "", "| dp | wall (s) | per-rank batch | k histogram |",
              "|---|---|---|---|"]
    for r in ks:
        lines.append(f"| {r['dp']} | {r['wall_s']} | {r['per_rank_batch']} | {r['k_histogram']} |")
    return "\n".join(lines) + "\n"


def main() -> None:
    import subprocess

    from slam_decomposition_torch.config import resolve_device
    from slam_decomposition_torch.parallel.launch import run_ranks

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--ranks", type=int, default=max(DPS))
    ap.add_argument("--out", default=None, help="also write the tables as markdown here")
    args = ap.parse_args()
    if resolve_device(args.device).type == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    else:
        card = "CPU (not a device measurement)"
    rows = run_ranks(curve_rank, args.ranks, args.ranks, args.device, device=args.device)
    for r in rows[0]["solve"] + rows[0]["ks"]:
        print(json.dumps(r))
    for r in rows:
        print(json.dumps({"rank": r["rank"], "shards": {s["dp"]: s["shards"] for s in r["solve"]}}))
    md = table(rows, card)
    print(md)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(md)


if __name__ == "__main__":
    main()
