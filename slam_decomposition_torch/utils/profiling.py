"""The program's spans and counters, and device traces.

Tracing is on inside a ``tracing()`` block and while a ``torch.profiler``
session records (the benchmark's traced segment, ``device_trace``); it is off
otherwise, where ``span`` and ``count`` cost one flag check and allocate
nothing. While it is on:

* ``span(name)`` is a host range ``slam.<name>`` on the profiler's
  timeline, over the launches of the kernels it issues, and adds to the
  table, per name, the count, the host seconds, the self seconds (the
  seconds less those of the spans opened inside it) and the name of the
  span it was first opened in;
* ``count(name, n)`` adds n to a counter of the table;
* each chain-kernel call (``ops.chain_kernels``) adds its launch and lanes
  under (wrapper, k, iterations) with ``count_launch``, and the LM and the
  polish get that key's accumulator, an int64 on their device, to which each
  lane adds its number of iterations that built J, A and b.

``table()`` returns what was recorded since tracing last turned on (the
accumulators read with one copy a device); it resets on entry to
``tracing()``, on the first span or count that finds a profiler recording
after one that found none, and at ``reset()``. Spans nest on one stack: open
them from one thread. Nothing is written to disk except by ``device_trace``.
"""

from __future__ import annotations

import contextlib
import os
import pathlib
import time

import torch

from slam_decomposition_torch.config import cache_dir

_profiler_enabled = torch._C._autograd._profiler_enabled
# A host range (an operator's kind of event). ``torch.profiler.record_function``
# makes a user annotation, which the profiler also mirrors onto the card's
# timeline (``gpu_user_annotation``), where a reduction of device activity
# that tells events apart by name would count it as device work.
_host_range = torch._C._profiler._RecordFunctionFast
_NO_SPAN = contextlib.nullcontext()

_explicit = 0  # depth of open tracing() blocks
_profiled = False  # whether the last check found a profiler recording
_stack: list = []  # the open spans, innermost last
_spans: dict = {}  # name -> {"count", "seconds", "self_seconds", "parent"}
_counters: dict = {}  # name -> total
_kernels: dict = {}  # (wrapper, k, iters) -> {"launches", "lanes"}
_rebuilds: dict = {}  # (wrapper, k, iters) -> int64 (1,) accumulator on the kernel's device


def reset() -> None:
    """Clears the table."""
    _spans.clear()
    _counters.clear()
    _kernels.clear()
    _rebuilds.clear()


def enabled() -> bool:
    """Whether tracing is on: inside ``tracing()`` or while a profiler
    records (the first check that finds one recording resets the table)."""
    global _profiled
    if _explicit:
        return True
    on = _profiler_enabled()
    if on != _profiled:
        _profiled = on
        if on:
            reset()
    return on


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block, from an empty table."""
    global _explicit
    reset()
    _explicit += 1
    try:
        yield
    finally:
        _explicit -= 1


class _Span:
    __slots__ = ("name", "t0", "inner", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = _host_range("slam." + self.name)
        self.range.__enter__()
        self.inner = 0.0
        _stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        _stack.pop()
        self.range.__exit__(*exc)
        parent = _stack[-1] if _stack else None
        if parent is not None:
            parent.inner += dt
        rec = _spans.get(self.name)
        if rec is None:
            rec = _spans[self.name] = {"count": 0, "seconds": 0.0, "self_seconds": 0.0,
                                       "parent": parent.name if parent is not None else None}
        rec["count"] += 1
        rec["seconds"] += dt
        rec["self_seconds"] += dt - self.inner
        return False


def span(name: str):
    """A context manager: the span ``name`` while tracing is on, else
    nothing. Host clock: a span around device work ends when the host has
    issued it, unless it waits for the device inside."""
    return _Span(name) if enabled() else _NO_SPAN


def count(name: str, n=1) -> None:
    """Adds n to the counter ``name`` while tracing is on."""
    if enabled():
        _counters[name] = _counters.get(name, 0) + n


def count_launch(wrapper: str, k: int, iters: int, lanes: int, device=None):
    """While tracing is on, one launch of ``lanes`` lanes of ``wrapper`` at
    depth k and ``iters`` iterations into the table; with ``device``, also
    returns that key's accumulator of J builds there (an int64 (1,) tensor).
    Returns None while tracing is off or without ``device``."""
    if not enabled():
        return None
    key = (wrapper, k, iters)
    rec = _kernels.setdefault(key, {"launches": 0, "lanes": 0})
    rec["launches"] += 1
    rec["lanes"] += lanes
    if device is None:
        return None
    acc = _rebuilds.get(key)
    if acc is None:
        acc = _rebuilds[key] = torch.zeros(1, dtype=torch.int64, device=device)
    return acc


def table() -> dict:
    """{"spans": {name: {"count", "seconds", "self_seconds", "parent"}},
    "counters": {name: total}, "kernels": {(wrapper, k, iters): {"launches",
    "lanes", and for the LM and the polish "rebuilds"}}}: what was recorded
    since tracing last turned on."""
    kernels = {key: dict(rec) for key, rec in _kernels.items()}
    by_device: dict = {}
    for key, acc in _rebuilds.items():
        by_device.setdefault(acc.device, []).append((key, acc))
    for pairs in by_device.values():
        values = torch.cat([acc for _, acc in pairs]).tolist()  # one copy a device
        for (key, _), v in zip(pairs, values):
            kernels[key]["rebuilds"] = v
    return {"spans": {name: dict(rec) for name, rec in _spans.items()}, "counters": dict(_counters),
            "kernels": kernels}


@contextlib.contextmanager
def device_trace(logdir=None):
    """Profile the block with ``torch.profiler`` (host activity, and the
    card's kernels where CUDA is available) and write it as a Chrome trace
    (chrome://tracing, Perfetto) into ``logdir`` (default
    ``build/slam_trace``). Yields the trace file's path, written when the
    block ends. The program's spans are on in the block: each shows as a
    ``slam.<name>`` range on the host's row, over the launches it issued."""
    logdir = pathlib.Path(logdir) if logdir is not None else cache_dir("slam_trace")
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"trace-{os.getpid()}-{time.time_ns()}.json"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(str(path))
