"""The mesh's readings in every rank, on given inputs: the rank program
that holds ``parallel.mesh`` against the unsharded functions
(tests/test_torch_mesh.py runs it in 8 CPU ranks through ``run_ranks``:
a function of the port, so no rank imports jax or a test module)."""

from __future__ import annotations

import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE


def rank_readings(n_devices: int, rp: int, device=DEFAULT_DEVICE, solves=(), ks_targets=None) -> dict:
    """In one rank: the mesh of ``n_devices`` ranks at ``rp``, the errors of
    ``make_mesh`` at an rp that does not divide the ranks and at more ranks
    than the group has, each solve of ``solves`` and the sharded ks of
    ``ks_targets`` on the sqiSwap coverage set.

    A solve is a dict: "name", "form" ("smap": ``sharded_solver_smap`` on
    the chain kernels; "gspmd": ``sharded_solver``), "k" (sqiSwap chain
    depth), "x0s" (B, R, n) and "T" (B, 4, 4) numpy, "adam_iters",
    "lm_iters" and, for "smap", "lm32_iters". Returns numpy arrays and plain
    values."""
    from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage
    from slam_decomposition_torch.models import gates
    from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
    from slam_decomposition_torch.parallel.mesh import make_mesh, sharded_ks, sharded_solver, sharded_solver_smap

    errors = {}
    for label, kw in (("rp", dict(n_devices=n_devices, rp=3)), ("devices", dict(n_devices=8 * n_devices, rp=2))):
        try:
            make_mesh(device=device, **kw)
        except (ValueError, RuntimeError) as e:
            errors[label] = f"{type(e).__name__}: {e}"
    mesh = make_mesh(n_devices, rp=rp, device=device)
    out = {
        "rank": mesh.rank, "shape": dict(mesh.shape), "axis_names": mesh.axis_names, "backend": mesh.backend,
        "device": str(mesh.device), "index": (mesh.dp_index, mesh.rp_index), "errors": errors, "solves": {},
    }
    for s in solves:
        a = build_ansatz(cycle_gates([gates.SQISWAP], s["k"]))
        if s["form"] == "smap":
            solver = sharded_solver_smap(
                a, mesh, adam_iters=s["adam_iters"], lm_iters=s["lm_iters"], lm32_iters=s["lm32_iters"],
                chain_gates=a.chain_gates,
            )
        else:
            solver = sharded_solver(a, mesh, adam_iters=s["adam_iters"], lm_iters=s["lm_iters"])
        x, f = solver.solve(torch.as_tensor(s["x0s"]), torch.as_tensor(s["T"]))
        out["solves"][s["name"]] = {"x": x.cpu().numpy(), "f": f.cpu().numpy(), "shards": solver.shards}
    if ks_targets is not None:
        coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=mesh.device)
        out["ks"] = sharded_ks(coverage, mesh)(ks_targets)
    return out
