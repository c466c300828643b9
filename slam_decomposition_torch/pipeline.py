"""The Haar-decomposition main path (JAX bench.py:156-214), end to end.

``decompose_haar`` draws B Haar targets, assigns each its sqiSwap
application count k from the sqiSwap coverage set
(``coverage.gate_set_to_coverage``: a cache read, a build where no cache
holds it) (then max(k, 2)), solves
each k-bucket in fixed-size chunks of ``chunk`` targets x ``restarts``
restarts, and re-solves the targets still above ``thresh`` at k=3 in up to
three rescue rounds. The last chunk of a bucket is filled by cycling the
bucket's own targets, so padding lanes are extra restarts of real targets;
each target keeps its best loss.

With a ``mesh`` (``parallel.mesh.make_mesh``; JAX bench.py's BENCH_MESH=1
path, :101, :118-137) every rank of the mesh calls it with the same
arguments: the ranges run through ``sharded_ks`` and each chunk through
``sharded_solver_smap`` (Adam 100, f32 LM 8, polish 6, the chain kernels).
Every rank draws the same global starts from the same generator, so they
equal the unsharded call's, and every rank returns the same result.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from slam_decomposition_torch.config import DEFAULT_DEVICE, resolve_device
from slam_decomposition_torch.coverage.coverage import gate_set_to_coverage, monodromy_ks_batch
from slam_decomposition_torch.models import gates
from slam_decomposition_torch.models.templates import build_ansatz, cycle_gates
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.opt.gauss_newton import ChainSolver
from slam_decomposition_torch.opt.samplers import haar_sample

RESCUE_ROUNDS = 3
KS = (2, 3)


@dataclasses.dataclass
class HaarResult:
    losses: np.ndarray  # (B,) certified square cost of each target's best solve
    ks: np.ndarray  # (B,) max(k, 2)
    times: dict  # seconds: "ranges", "solve", "rescue", "total" (warm-up excluded)
    rescued: list  # targets re-solved in each rescue round
    thresh: float

    @property
    def n_certified(self) -> int:
        return int((self.losses <= self.thresh).sum())

    def k_histogram(self) -> dict:
        vals, counts = np.unique(self.ks, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _random_x0(n_targets, restarts, n_params, gen, device):
    u = torch.rand((n_targets, restarts, n_params), generator=gen, device=device, dtype=torch.float64)
    return u * (2 * math.pi)


def _launch_bucket(T, idx, solver, chunk, restarts, gen):
    """Solve targets T[idx] in chunks of exactly ``chunk``; returns
    [(target indices, loss tensor)] without waiting for the device."""
    out = []
    for s in range(0, len(idx), chunk):
        part = idx[s : s + chunk]
        if len(part) < chunk:
            part = np.resize(idx[s:], chunk)
        tgt = T[torch.as_tensor(part, device=T.device)]
        x0 = _random_x0(chunk, restarts, solver.n_params, gen, T.device)
        _, loss = solver.solve(x0, tgt)
        out.append((part, loss))
    return out


def _collect(losses, pending) -> None:
    """Min-reduce every chunk's losses into ``losses`` (duplicates from the
    cyclic padding keep their best; a NaN never replaces a number)."""
    if not pending:
        return
    got = torch.cat([l for _, l in pending]).cpu().numpy()
    np.fmin.at(losses, np.concatenate([p for p, _ in pending]), got)


def _mesh_parts(coverage, mesh):
    """(ks_fn(targets) -> ks, {k: solver}) of the mesh path."""
    from slam_decomposition_torch.parallel.mesh import sharded_ks, sharded_solver_smap

    sharded = sharded_ks(coverage, mesh)

    def ks_fn(T):  # padded to the mesh size by repeating the first target, on the device
        pad = T[:1].expand((-T.shape[0]) % mesh.size, *T.shape[1:])
        return sharded(torch.cat([T, pad]))[: T.shape[0]]

    solvers = {}
    for k in KS:
        a = build_ansatz(cycle_gates([gates.SQISWAP], k))
        solvers[k] = sharded_solver_smap(
            a, mesh, adam_iters=ck.ADAM_ITERS, lm_iters=ck.LM_ITERS, lm32_iters=ck.LM32_ITERS,
            chain_gates=a.chain_gates,
        )
    return ks_fn, solvers


def decompose_haar(
    B: int = 100_000,
    chunk: int = 10_000,
    restarts: int = 4,
    thresh: float = 1e-10,
    seed: int = 456,
    device=DEFAULT_DEVICE,
    mesh=None,
) -> HaarResult:
    """Decompose haar_sample(B, seed) into the sqiSwap basis, certified at
    square cost <= thresh. Before the clock starts, every solver shape runs
    once on a disjoint target set. Runs on the card unless ``device`` names
    another; with a ``mesh``, on every rank of it, on the rank's device
    (``chunk`` divisible by its dp, ``restarts`` by its rp)."""
    device = mesh.device if mesh is not None else resolve_device(device)
    coverage = gate_set_to_coverage(gates.cg_sqiswap(), device=device)
    if mesh is None:
        solvers = {
            k: ChainSolver(build_ansatz(cycle_gates([gates.SQISWAP], k)).chain_gates, device=device)
            for k in KS
        }

        def ks_fn(T):
            return monodromy_ks_batch(coverage, T, device)

    else:
        ks_fn, solvers = _mesh_parts(coverage, mesh)
    T = torch.as_tensor(haar_sample(B, seed=seed)).to(device)

    # warm-up: one chunk per solver shape and one k-assignment, on other data
    warm_gen = torch.Generator(device=device)
    warm_gen.manual_seed(seed + 1)
    T_warm = torch.as_tensor(haar_sample(chunk, seed=seed + 1)).to(device)
    ks_fn(T_warm)
    for s in solvers.values():
        s.solve(_random_x0(chunk, restarts, s.n_params, warm_gen, device), T_warm)
    _sync(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    t0 = time.perf_counter()
    ks = np.maximum(ks_fn(T), 2)
    t1 = time.perf_counter()
    losses = np.full(B, np.inf)
    pending = []
    for k in KS:
        idx = np.where(ks == k)[0]
        if len(idx):
            pending += _launch_bucket(T, idx, solvers[k], chunk, restarts, gen)
    _collect(losses, pending)
    t2 = time.perf_counter()
    rescued = []
    for _ in range(RESCUE_ROUNDS):
        stuck = np.where(~(losses <= thresh))[0]
        if len(stuck) == 0:
            break
        rescued.append(len(stuck))
        _collect(losses, _launch_bucket(T, stuck, solvers[3], chunk, restarts, gen))
    t3 = time.perf_counter()
    times = {"ranges": t1 - t0, "solve": t2 - t1, "rescue": t3 - t2, "total": t3 - t0}
    return HaarResult(losses=losses, ks=ks, times=times, rescued=rescued, thresh=thresh)
