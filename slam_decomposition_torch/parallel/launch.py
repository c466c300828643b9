"""One process per rank: how the port runs a mesh.

The JAX package is single-controller: one process drives every device of
its mesh and XLA inserts the collectives (parallel/mesh.py). PyTorch is
multi-controller: each rank is a process with its own device, joined to the
others by a ``torch.distributed`` group. ``run_ranks`` starts the ranks with
``torch.multiprocessing`` (spawn) over a ``file://`` store, runs the same
function in each and hands every rank's result back to the caller.

Devices and backends follow a rule, not a failed attempt
(``rank_device``, ``backend_for``):

* the card by default: rank r takes ``cuda:r`` when every rank has a card
  of its own, and the group runs on NCCL; otherwise every rank takes the one
  card, and the group runs on gloo (NCCL refuses two ranks on one GPU);
* the CPU only when the caller asks for it, on gloo, one intra-op thread a
  rank.

On the card rank 0 loads the kernel library (building it if it is missing)
before a barrier, and only then do the other ranks load it, so the ranks
never run nvcc side by side.
"""

from __future__ import annotations

import os
import pathlib
import queue
import time
import traceback
import uuid

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from slam_decomposition_torch.config import DEFAULT_DEVICE, cache_dir, resolve_device


def rank_device(rank: int, world: int, device=DEFAULT_DEVICE) -> torch.device:
    """The device of ``rank`` in a group of ``world`` ranks: ``cuda:rank``
    when the machine has a card for every rank, else the one card (CUDA
    device 0); the CPU only when ``device`` is the CPU."""
    device = resolve_device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"no mesh on device {device}")
    return torch.device("cuda", rank if torch.cuda.device_count() >= world else 0)


def backend_for(world: int, device=DEFAULT_DEVICE) -> str:
    """NCCL when every rank has a card of its own, gloo when the ranks share
    a card or run on the CPU."""
    device = resolve_device(device)
    return "nccl" if device.type == "cuda" and torch.cuda.device_count() >= world else "gloo"


def new_init_file() -> pathlib.Path:
    """A fresh path for a group's file store, under ``build/slam_mesh``."""
    d = cache_dir("slam_mesh")
    d.mkdir(parents=True, exist_ok=True)
    return d / f"store-{os.getpid()}-{uuid.uuid4().hex}"


def start_group(rank: int, world: int, device=DEFAULT_DEVICE, init_file=None) -> torch.device:
    """Join (or, at world 1, start) the default process group on the file
    store at ``init_file``, with the backend and device of the rule above;
    returns the rank's device (made current on the card)."""
    dev = rank_device(rank, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init_file = pathlib.Path(init_file) if init_file is not None else new_init_file()
    dist.init_process_group(
        backend_for(world, device), init_method=f"file://{init_file}", world_size=world, rank=rank
    )
    return dev


def _load_kernels_in_turn(rank: int) -> None:
    """Rank 0 loads (and if need be builds) the kernel library; the others
    load it after the barrier, from the file rank 0 left."""
    from slam_decomposition_torch.ops import _build

    if rank == 0:
        _build.load()
    dist.barrier()
    if rank != 0:
        _build.load()


def _rank_main(rank, world, fn, args, device, init_file, results) -> None:
    try:
        if resolve_device(device).type == "cpu":
            torch.set_num_threads(1)
        dev = start_group(rank, world, device, init_file)
        if dev.type == "cuda":
            _load_kernels_in_turn(rank)
        out = fn(*args)
        results.put((rank, True, out))
    except Exception:  # reported to the caller, which raises and stops the other ranks
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world: int, *args, device=DEFAULT_DEVICE, init_file=None, timeout: float = 1800.0) -> list:
    """``fn(*args)`` in each of ``world`` ranks, each a spawned process that
    has joined one group (``start_group``); returns the ranks' results in
    rank order.

    ``fn`` and its results cross process boundaries by pickling: ``fn`` is
    a module-level function of this package (a rank imports its module, so
    it never imports jax or a test module) and returns numpy arrays and
    plain Python values. ``init_file`` is the file store's path (it must not
    exist yet; default a fresh one under ``build/slam_mesh``). Raises
    RuntimeError with the rank's traceback when a rank fails, dies or does
    not finish within ``timeout`` seconds; the other ranks are stopped."""
    if world < 1:
        raise ValueError(f"run_ranks: world must be >= 1, got {world}")
    resolve_device(device)  # no card: raise here, not in every rank
    init_file = pathlib.Path(init_file) if init_file is not None else new_init_file()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, world, fn, args, device, str(init_file), results), daemon=True)
        for r in range(world)
    ]
    for p in procs:
        p.start()
    got, failure = {}, None
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world and failure is None:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in got and not p.is_alive()]
                if dead:
                    failure = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} without a result"
                elif time.monotonic() > deadline:
                    failure = f"the ranks did not finish within {timeout} s"
                continue
            if ok:
                got[rank] = payload
            else:
                failure = f"rank {rank} failed:\n{payload}"
    finally:
        for p in procs:
            if (failure is not None or len(got) < world) and p.is_alive():  # a failure or an interrupt
                p.terminate()
            p.join(timeout=60)
        results.close()
        init_file.unlink(missing_ok=True)
    if failure is not None:
        raise RuntimeError(f"run_ranks({getattr(fn, '__qualname__', fn)}, {world}): {failure}")
    return [got[r] for r in range(world)]
