"""Entry points of the port: a one-card compile check and the mesh
dry run (the JAX package's ``__graft_entry__.py``, which stays the JAX
package's own).

    python3 -c "from slam_decomposition_torch import graft_entry as g; g.dryrun_multichip(4)"
    python3 -c "from slam_decomposition_torch import graft_entry as g; g.dryrun_multichip(4, device='cpu')"

``dryrun_multichip(n)`` starts ``n`` ranks (``parallel.launch.run_ranks``):
on a machine with n cards one card a rank over NCCL, else all on the one
card over gloo, or on the CPU when asked.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device


def entry(device=DEFAULT_DEVICE):
    """(fn, args): the batched square cost of the k = 3 sqiSwap chain against
    64 Haar targets and its gradient by autograd, the unit of work inside
    every optimizer step. ``fn(params (B, n) f64, targets (B, 4, 4)
    complex128) -> (cost (B,), gradient (B, n))``, on the card unless
    ``device`` names another."""
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.opt.samplers import haar_sample

    device = resolve_device(device)
    ansatz = build_ansatz(cycle_gates([gates.SQISWAP], 3))
    B = 64
    targets = torch.as_tensor(haar_sample(B, seed=0)).to(device)
    params = torch.as_tensor(np.random.default_rng(0).uniform(0, 2 * np.pi, (B, ansatz.n_params))).to(device)

    def fn(params, targets):
        x = params.detach().requires_grad_(True)
        t = (targets.conj() * ansatz.eval_fn(x)).sum(dim=(-2, -1))
        cost = 1.0 - (t.real**2 + t.imag**2 + 4.0) / 20.0
        (grad,) = torch.autograd.grad(cost.sum(), x)
        return cost.detach(), grad

    return fn, (params, targets)


def dryrun_multichip(n_devices: int, device=DEFAULT_DEVICE, init_file=None) -> list:
    """The full multi-start solve and k-assignment over an ``n_devices``-rank
    mesh, dp (targets) x rp (restarts), with every check of ``_dryrun_impl``
    in every rank; returns each rank's readings (rank 0 prints the summary
    line). Raises if any rank fails."""
    from slam_decomposition_torch.parallel.launch import run_ranks

    return run_ranks(_dryrun_impl, n_devices, n_devices, device, device=device, init_file=init_file)


def _check(cond, msg="dry-run check failed") -> None:
    if not cond:
        raise AssertionError(msg)


def _dryrun_impl(n_devices: int, device=DEFAULT_DEVICE) -> dict:
    """The mesh dry run in one rank of an ``n_devices``-rank group (JAX
    ``__graft_entry__._dryrun_impl``, every check kept): a tiny sharded solve
    in both forms, the sharded ks, then the production stage (B = 2048, R =
    4, Adam 100 / f32 LM 8 / polish 6 on the chain kernels) held against the
    unsharded solver, and the sharded ks against ``monodromy_ks_batch`` at
    B = 10240."""
    import torch.distributed as dist

    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.ops import chain_kernels as ck
    from slam_decomposition_torch.opt.gauss_newton import make_solver
    from slam_decomposition_torch.opt.samplers import haar_sample
    from slam_decomposition_torch.parallel.mesh import make_mesh, sharded_ks, sharded_solver, sharded_solver_smap

    ck.reset_launch_counts()
    rp = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, rp=rp, device=device)
    dp = n_devices // rp
    dev = mesh.device

    ansatz = build_ansatz(cycle_gates([gates.SQISWAP], 2))
    B, R = 2 * dp, 2 * rp
    targets = torch.as_tensor(haar_sample(B, seed=1))
    x0s = torch.as_tensor(np.random.default_rng(1).uniform(0, 2 * np.pi, (B, R, ansatz.n_params)))
    bx, bf = sharded_solver(ansatz, mesh, adam_iters=3, lm_iters=2).solve(x0s, targets)
    _check(bx.shape == (B, ansatz.n_params))
    _check(bool((bf >= 0.0).all()) and bool((bf <= 1.0 + 1e-9).all()))

    # the explicit-collective form, on the chain kernels in every rank
    smap = sharded_solver_smap(ansatz, mesh, adam_iters=3, lm_iters=2, lm32_iters=2, chain_gates=ansatz.chain_gates)
    bx2, _ = smap.solve(x0s, targets)
    _check(bx2.shape == (B, ansatz.n_params))

    coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=dev)
    ks = sharded_ks(coverage, mesh)(targets)
    _check(ks.shape == (B,) and set(np.unique(ks)) <= {0, 1, 2, 3})

    # production-shaped stage: one chunk at a realistic batch with the main
    # path's iteration counts (make_solver's defaults, so the unsharded
    # comparator below runs the same lane arithmetic)
    Bp, Rp = 2048, 4
    prod = sharded_solver_smap(ansatz, mesh, adam_iters=100, lm32_iters=8, lm_iters=6, chain_gates=ansatz.chain_gates)
    tp = torch.as_tensor(haar_sample(Bp, seed=2))
    xp = torch.as_tensor(np.random.default_rng(2).uniform(0, 2 * np.pi, (Bp, Rp, ansatz.n_params)))
    px, pf = prod.solve(xp, tp)
    _check(px.shape == (Bp, ansatz.n_params))
    pf_np = pf.cpu().numpy()
    frac = float((pf_np <= 1e-10).mean())
    _check(frac >= 0.5, f"production-shape convergence collapsed: {frac:.3f}")

    # sharded against unsharded at production shapes: the same lane
    # arithmetic, so the certified sets agree and the losses are close
    plain = make_solver(ansatz.eval_fn, ansatz.n_params, chain_gates=ansatz.chain_gates, device=dev)
    _, qf = plain.solve(xp.to(dev), tp.to(dev))
    qf_np = qf.cpu().numpy()
    agree = (pf_np <= 1e-10) == (qf_np <= 1e-10)
    _check(agree.mean() >= 0.999, f"mesh/plain certified-set mismatch on {(~agree).sum()} lanes")
    d = np.abs(pf_np - qf_np)
    _check(np.allclose(pf_np, qf_np, rtol=1e-2, atol=1e-9), f"mesh/plain loss divergence: max |delta| {d.max():.2e}")

    # the sharded ranges at B >= 10k against the unsharded call: equal ints
    Bk = 10240
    tk = haar_sample(Bk, seed=3)
    ks_mesh = sharded_ks(coverage, mesh)(tk)
    ks_plain = monodromy_ks_batch(coverage, tk, dev)
    _check((ks_mesh == ks_plain).all(), "sharded_ks != monodromy_ks_batch at B=10240")

    mine = {
        "rank": mesh.rank, "index": (mesh.dp_index, mesh.rp_index), "device": str(dev), "backend": mesh.backend,
        "production_shards": prod.shards, "launches": ck.launch_counts(), "certified": frac,
        "agreement": float(agree.mean()), "max_loss_delta": float(d.max()),
    }
    every = [None] * mesh.size
    dist.all_gather_object(every, mine, group=mesh.group)
    if mesh.rank == 0:
        for r in every:
            sh = r["production_shards"]
            print(f"[dryrun] rank {r['rank']} {r['index']} on {r['device']} ({r['backend']}): production shard "
                  f"{sh['x0s']} -> lanes {sh['lanes']}, launches {sh['launches']}; whole run launches {r['launches']}",
                  flush=True)
        print(
            f"dryrun_multichip OK: mesh={mesh.shape}, backend={mesh.backend}, B={B}, R={R} "
            f"(sharded_solver + sharded_solver_smap + sharded_ks); production shape B={Bp}, R={Rp}, "
            f"adam100/lm32x8/lm6: {frac:.1%} of k=2-coverable targets certified; mesh-vs-plain parity: "
            f"certified sets agree {100 * agree.mean():.2f}%, max loss delta {d.max():.1e}; "
            f"sharded_ks == unsharded ks at B={Bk} exactly",
            flush=True,
        )
    return mine
