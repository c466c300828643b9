"""Mesh sharding of the batched synthesis (JAX parallel/mesh.py), over the
ranks of a torch.distributed group.

The axes are the JAX package's:

* 'dp': the target batch (data parallel);
* 'rp': the optimizer restarts (the best-of-restarts argmin crosses 'rp'
  with one all-gather of (params, loss) per target row).

The JAX package shards one program over the devices of one process and lets
XLA insert the collectives. Here every rank is a process of its own
(``parallel.launch.run_ranks``) that runs the same code on its shard of the
global inputs and calls the collectives itself, on its device: the
``shard_map`` form of the JAX module. Each rank's solves run on the three
chain kernels when the template is a plain chain (``make_solver``'s
routing rule), on exactly (B/dp) x (R/rp) lanes for Adam and the LM and B/dp
lanes for the polish.

On gloo a collective takes host tensors: tensors on the card cross through
the host there (the ranks share one card). On NCCL they stay on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from slam_decomposition_torch.config import DEFAULT_DEVICE
from slam_decomposition_torch.coverage.coverage import monodromy_ks_unchecked
from slam_decomposition_torch.models.templates import Ansatz
from slam_decomposition_torch.ops import chain_kernels as ck
from slam_decomposition_torch.parallel import launch


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A dp x rp grid over ranks 0..dp*rp-1 of the default group: rank i sits
    at (dp, rp) index (i // rp, i % rp), as the JAX mesh places device i.
    ``group`` holds every rank of the mesh, ``rp_group`` the ranks of this
    rank's dp index (its target rows, all restarts), ``dp_group`` those of
    its rp index."""

    shape: dict
    rank: int
    device: torch.device
    backend: str
    group: object
    rp_group: object
    dp_group: object
    started_group: bool = False  # make_mesh(1) started the default group itself
    axis_names = ("dp", "rp")

    @property
    def size(self) -> int:
        return self.shape["dp"] * self.shape["rp"]

    @property
    def dp_index(self) -> int:
        return self.rank // self.shape["rp"]

    @property
    def rp_index(self) -> int:
        return self.rank % self.shape["rp"]

    def close(self) -> None:
        """Ends the default group if this mesh started it (``make_mesh(1)``
        without a group)."""
        if self.started_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, rp: int = 1, device=DEFAULT_DEVICE) -> Optional[Mesh]:
    """Mesh with ('dp', 'rp') axes over the first ``n_devices`` ranks of the
    default group (all of them by default). Every rank of the group calls it
    (subgroups are made collectively); a rank outside the mesh gets None.

    Without a group, ``make_mesh(1)`` (or ``make_mesh()``) starts a one-rank
    group on a file store in this process. ``device`` is the card unless the
    caller asks for the CPU; the rank's device and the backend follow
    ``launch.rank_device`` / ``launch.backend_for``. Raises instead of
    truncating when the group has fewer than ``n_devices`` ranks."""
    started = False
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if world < n:
        raise RuntimeError(
            f"make_mesh: requested {n} devices but only {world} ranks in the group. Start the ranks with "
            "slam_decomposition_torch.parallel.launch.run_ranks(fn, n, ...)."
        )
    if n % rp != 0:
        raise ValueError(f"make_mesh: n_devices={n} not divisible by rp={rp}")
    if not dist.is_initialized():
        launch.start_group(0, 1, device)
        started = True
    rank = dist.get_rank()
    dp = n // rp
    # every rank makes every group, in the same order (torch.distributed.new_group)
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rp_groups = [dist.new_group([d * rp + r for r in range(rp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * rp + r for d in range(dp)]) for r in range(rp)]
    if rank >= n:
        return None
    return Mesh(
        shape={"dp": dp, "rp": rp},
        rank=rank,
        device=launch.rank_device(rank, world, device),
        backend=dist.get_backend(),
        group=group,
        rp_group=rp_groups[rank // rp],
        dp_group=dp_groups[rank % rp],
        started_group=started,
    )


def _all_gather(t: torch.Tensor, group, mesh: Mesh) -> torch.Tensor:
    """(group size, *t.shape): every rank's t in group-rank order, on t's
    device."""
    through_host = mesh.backend == "gloo" and t.device.type != "cpu"
    src = t.detach().cpu() if through_host else t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return torch.stack(out).to(t.device)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0):
    """Pad a batch to a multiple of the mesh size by repeating its first
    entry; returns (padded, the original length)."""
    b = arr.shape[axis]
    rem = (-b) % multiple
    if rem == 0:
        return arr, b
    idx = [slice(None)] * arr.ndim
    idx[axis] = slice(0, 1)
    filler = np.repeat(arr[tuple(idx)], rem, axis=axis)
    return np.concatenate([arr, filler], axis=axis), b


def sharded_ks(coverage, mesh: Mesh):
    """Mesh-sharded k-assignment (``coverage.monodromy_ks_batch``): returns
    ``ks_fn(targets) -> (B,) int64 numpy`` for (B, 4, 4) complex targets
    (numpy or tensor, the same on every rank), B divisible by the mesh size
    (``pad_to_multiple``).

    The batch splits over both axes (the k-assignment has no restarts): rank
    i assigns rows [i B/n, (i + 1) B/n) on its device, then one all-gather
    gives every rank the global ks. Per target the same arithmetic as the
    unsharded call, so the ks are equal. A target outside every coverage
    polytope raises ValueError on every rank, after the all-gather."""

    def ks_fn(targets) -> np.ndarray:
        T = torch.as_tensor(targets)
        B = T.shape[0]
        if B % mesh.size:
            raise ValueError(f"sharded_ks: batch {B} is not divisible by the mesh's {mesh.size} ranks")
        n = B // mesh.size
        part = monodromy_ks_unchecked(coverage, T[mesh.rank * n : (mesh.rank + 1) * n], mesh.device)
        ks = _all_gather(torch.as_tensor(part, device=mesh.device), mesh.group, mesh).reshape(B).cpu().numpy()
        if (ks < 0).any():
            raise ValueError("no coverage polytope contains some targets")
        return ks

    return ks_fn


class ShardedSolver:
    """The solve of ``sharded_solver_smap``: ``solve(x0s (B, R, n), tgt (B,
    4, 4)) -> (x (B, n) f64, cost (B,) f64)``, the same global inputs and
    outputs on every rank of the mesh.

    Per rank: its (B/dp, R/rp) shard through the local solve (Adam, the f32
    LM and the local restart ranking: ``make_solver(..., lm_iters=0)``, whose
    cost is that of the local winner), one all-gather of (x, cost) over
    'rp' and the argmin, the polisher's ``polish_cert`` on the winner
    (redundantly on the rp ranks, so its rows agree), then one all-gather of
    the rows over 'dp'. ``shards`` records the last call's shard shapes, the
    lanes each kernel wrapper was given and the rank's kernel launches."""

    def __init__(self, ansatz: Ansatz, mesh: Mesh, adam_iters, lm_iters, lm32_iters, chain_gates):
        from slam_decomposition_torch.opt.gauss_newton import make_solver

        self.mesh = mesh
        self.n_params = ansatz.n_params
        self.local = make_solver(
            ansatz.eval_fn, ansatz.n_params, adam_iters=adam_iters, lm32_iters=lm32_iters, lm_iters=0,
            chain_gates=chain_gates, device=mesh.device,
        )
        self.polisher = make_solver(
            ansatz.eval_fn, ansatz.n_params, adam_iters=0, lm32_iters=0, lm_iters=lm_iters,
            chain_gates=chain_gates, device=mesh.device,
        )
        self.shards: dict = {}

    def solve(self, x0s: torch.Tensor, tgt: torch.Tensor):
        mesh = self.mesh
        dp, rp = mesh.shape["dp"], mesh.shape["rp"]
        x0s = torch.as_tensor(x0s)
        B, R, n = x0s.shape
        if B % dp or R % rp:
            raise ValueError(f"sharded solve: (B, R) = ({B}, {R}) is not divisible by (dp, rp) = ({dp}, {rp})")
        Bl, Rl = B // dp, R // rp
        rows = slice(mesh.dp_index * Bl, (mesh.dp_index + 1) * Bl)
        x = x0s[rows, mesh.rp_index * Rl : (mesh.rp_index + 1) * Rl].to(mesh.device).contiguous()
        t = torch.as_tensor(tgt)[rows].to(mesh.device).contiguous()
        launches0, lanes0 = ck.launch_counts(), ck.lane_counts()
        xs, bf = self.local.solve(x, t)
        xs_all = _all_gather(xs, mesh.rp_group, mesh)  # (rp, Bl, n)
        bf_all = _all_gather(bf, mesh.rp_group, mesh)  # (rp, Bl)
        best = torch.argmin(bf_all, dim=0)
        xw = xs_all[best, torch.arange(Bl, device=xs_all.device)].contiguous()
        xw, bfw = self.polisher.polish_cert(xw, t)
        self.shards = {
            "x0s": (Bl, Rl, n), "tgt": (Bl, *t.shape[1:]), "out": (Bl, n),
            "lanes": {w: v[len(lanes0[w]) :] for w, v in ck.lane_counts().items()},
            "launches": {w: v - launches0[w] for w, v in ck.launch_counts().items()},
        }
        x_out = _all_gather(xw, mesh.dp_group, mesh).reshape(B, n)
        f_out = _all_gather(bfw, mesh.dp_group, mesh).reshape(B)
        return x_out, f_out

    __call__ = solve


def sharded_solver_smap(
    ansatz: Ansatz, mesh: Mesh, adam_iters: int = 250, lm_iters: int = 10, lm32_iters: int = 8, chain_gates=None,
) -> ShardedSolver:
    """The mesh solve with explicit collectives (JAX ``sharded_solver_smap``,
    the shard_map form that runs the kernels per device): targets over
    'dp', restarts over 'rp'; see ``ShardedSolver``. Pass
    ``chain_gates=ansatz.chain_gates`` for the chain kernels (else the
    general path). The JAX module's ``certify="df64"`` has no counterpart:
    f64 is native here, and the certificate is the polish's f64 one."""
    return ShardedSolver(ansatz, mesh, adam_iters, lm_iters, lm32_iters, chain_gates)


def sharded_solver(ansatz: Ansatz, mesh: Mesh, adam_iters: int = 250, lm_iters: int = 10) -> ShardedSolver:
    """The JAX ``sharded_solver``'s computation: the multi-start solve over
    the mesh, targets over 'dp', restarts over 'rp', with the f32 LM at
    ``make_solver``'s default of 8 iterations and the template's own
    routing (the chain kernels for a plain chain).

    The JAX function is the GSPMD form: one jit with sharding annotations,
    in which XLA inserts the collectives. torch has no counterpart of that;
    this is the same computation through ``sharded_solver_smap``'s explicit
    collectives, the port's one collective scheme."""
    return ShardedSolver(ansatz, mesh, adam_iters, lm_iters, ck.LM32_ITERS, ansatz.chain_gates)
