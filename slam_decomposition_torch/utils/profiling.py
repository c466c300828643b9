"""Phase timers and device traces (JAX utils/profiling.py): structured
phase timers with the reference's per-phase log format, and a
``torch.profiler`` capture written as a Chrome trace."""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time
from typing import Dict

import torch

from slam_decomposition_torch.config import cache_dir

logger = logging.getLogger("slam_torch.profile")


class PhaseTimer:
    """Accumulating phase timer; its log line is the reference's
    'TIMING: haar: ..., cnot: ..., swap: ...'. Host clock: time device
    work only where it ends in a synchronize."""

    def __init__(self, name: str = ""):
        self.name = name
        self.phases: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.phases[label] = self.phases.get(label, 0.0) + dt
            self.counts[label] = self.counts.get(label, 0) + 1

    def log(self, level=logging.INFO):
        parts = ", ".join(f"{k}: {v:.3f}" for k, v in self.phases.items())
        logger.log(level, "TIMING%s: %s", f" [{self.name}]" if self.name else "", parts)

    def summary(self) -> Dict[str, float]:
        return dict(self.phases)


@contextlib.contextmanager
def device_trace(logdir=None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where CUDA is available) and write it as a Chrome trace
    (chrome://tracing, Perfetto) into ``logdir`` (default
    ``build/slam_trace``). Yields the trace file's path, written when the
    block ends."""
    logdir = pathlib.Path(logdir) if logdir is not None else cache_dir("slam_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))


@contextlib.contextmanager
def timed(label: str, level=logging.INFO):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.log(level, "%s: %.3fs", label, time.perf_counter() - t0)
