"""The traced segment and its reduction: device operations, host spans, the
kernels' launches and their data-dependent work.

After the measured window has closed, a `--trace 1` run drives whole
batches more (at least `min_batches`, until `seconds` have passed) under
`torch.profiler` (host and CUDA activity, kept in memory, never exported).
From the profiler's events it keeps the device's kernels, copies and sets
(their names and times) and the benchmark's own host spans (`bench.<name>`
ranges). A flow that solves (one with `solvers`) records each chain-kernel
launch of the segment as (kernel, depth, lanes, iterations); a flow that
solves nothing leaves the launch list and the rebuild counts empty.
"""

from __future__ import annotations

import collections
import re
import time

import numpy as np
import torch

DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
# a chain kernel's trace name -> the kernel it belongs to (the LM and the
# polish share the depth-generic program, told apart by its type)
KERNEL_CLASSES = (
    ("adam", re.compile(r"adam_(chain|gen)_kernel")),
    ("polish", re.compile(r"polish_chain_kernel|lm_gen(_gate_lists)?_kernel<double")),
    ("lm", re.compile(r"lm_chain_kernel|lm_gen(_gate_lists)?_kernel<float")),
)
FRESH_TARGETS = 1024  # targets whose LM iterations are counted, a depth


def _get(e, attr):
    v = getattr(e, attr)
    return v() if callable(v) else v


def kernel_class(name: str):
    for cls, pat in KERNEL_CLASSES:
        if pat.search(name):
            return cls
    return None


def profile_events(prof):
    """(device ops [(name, start_ns, end_ns)], host spans [(name, start_ns,
    end_ns)]) of a finished profile."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        name = _get(e, "name")
        start = _get(e, "start_ns")
        end = start + _get(e, "duration_ns")
        on_device = str(_get(e, "device_type")).endswith("CUDA")
        kind = _get(e, "activity_type") if hasattr(e, "activity_type") else None
        if on_device:
            if (kind in DEVICE_KINDS) if kind is not None else not name.startswith("bench."):
                ops.append((name, start, end))
        elif name.startswith("bench."):
            spans.append((name[len("bench.") :], start, end))
    return ops, spans


def busy_intervals(ops):
    """The union of the ops' intervals, as sorted disjoint [start, end)."""
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce(ops, spans, window_s: float) -> dict:
    busy = busy_intervals(ops)
    busy_s = sum(e - s for s, e in busy) / 1e9
    by_name = collections.defaultdict(float)
    kernel_s = collections.defaultdict(float)
    for name, s, e in ops:
        by_name[name.split("(", 1)[0]] += (e - s) / 1e9
        cls = kernel_class(name)
        if cls is not None:
            kernel_s[cls] += (e - s) / 1e9
    # idle time between device ops, by the host span it falls in
    idle = collections.defaultdict(float)
    span_list = sorted(spans, key=lambda sp: sp[1])
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        owner = [name for name, s, e in span_list if s <= mid <= e]
        idle[owner[-1] if owner else "outside spans"] += (s1 - e0) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": busy_s, "window_s": window_s, "kernel_s": dict(kernel_s),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


def fresh_counts(flow, T: torch.Tensor, depth0: np.ndarray, ks_used, seed: int) -> dict:
    """{("lm" | "polish", k): mean LM iterations per lane that rebuild J}.

    Method frozen from `slam_decomposition_torch/tools/inputs.py`
    `fresh_iterations`: the kernel run with 0..iters-1 iterations gives
    ||r||^2 after each; iteration i + 1 rebuilds J iff step i was accepted
    (||r||^2 fell), and the first always does. The lanes are a depth's own
    targets in the traced batches (those first assigned the largest depth
    not above it, else the least), run as the solver runs them: Adam, the f32 LM on every start, the
    polish on each target's best."""
    from slam_decomposition_torch.ops import chain_kernels as ck

    from benchmark.flows.main import ADAM_ITERS, LM32_ITERS, POLISH_ITERS

    gen = torch.Generator(device=T.device)
    gen.manual_seed(seed)
    sched = ck.adam_schedule(ADAM_ITERS, device=T.device)
    out = {}
    for k in sorted(ks_used):
        below = depth0[depth0 <= k]
        nearest = below.max() if len(below) else depth0.min()
        idx = np.resize(np.where(depth0 == nearest)[0], min(FRESH_TARGETS, len(depth0)))
        tgt = T[torch.as_tensor(idx, device=T.device)].contiguous()
        g64 = flow.chain_gates[k]
        g32 = g64.to(torch.complex64)
        R, n = flow.restarts, 6 * (k + 1)
        tR = tgt.to(torch.complex64).repeat_interleave(R, 0).contiguous()
        x0 = (torch.rand((len(idx) * R, n), generator=gen, device=T.device) * (2 * np.pi)).contiguous()
        xa = ck.adam_chain(x0, tR, g32, sched)
        f = [ck.lm_chain(xa, tR, g32, i)[1] for i in range(LM32_ITERS + 1)]
        out[("lm", k)] = 1.0 + sum((f[i] < f[i - 1]).double() for i in range(1, LM32_ITERS)).mean().item()
        xl = ck.lm_chain(xa, tR, g32, LM32_ITERS)[0].view(len(idx), R, n)
        best = torch.argmin(f[LM32_ITERS].view(len(idx), R), dim=1)
        xb = xl[torch.arange(len(idx), device=T.device), best].double().contiguous()
        p = [ck.polish_chain(xb, tgt, g64, i)[1] for i in range(POLISH_ITERS)]
        out[("polish", k)] = 1.0 + sum((p[i] < p[i - 1]).double() for i in range(1, POLISH_ITERS)).mean().item()
    return out


def traced_segment(flow, pool, first_batch: int, batch_of, spans, device, seconds: float, min_batches: int) -> dict:
    """Drive whole batches under the profiler after the window and reduce the
    trace; also, for a flow that solves, the launches of the segment and the
    LM's rebuild counts."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    solves = hasattr(flow, "solvers")
    if solves:
        flow.launches = []
    spans.profiling = True
    outs, starts = [], []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        b = first_batch
        while len(outs) < min_batches or time.perf_counter() - t0 < seconds:
            start, stop = batch_of(b)
            outs.append(flow.run_batch(pool[start:stop]))
            starts.append((start, stop))
            b += 1
        window_s = time.perf_counter() - t0
    spans.profiling = False
    ops, host = profile_events(prof)
    red = reduce(ops, host, window_s)
    red["batches"] = len(outs)
    if not solves:
        red["launches"], red["fresh"] = [], {}
        return red
    red["launches"], flow.launches = flow.launches, None
    T = torch.cat([pool[start:stop] for start, stop in starts])
    depth0 = np.maximum(np.concatenate([o.ks for o in outs]), flow.k_min)
    ks_used = {k for _, k, _, _ in red["launches"]}
    red["fresh"] = fresh_counts(flow, T, depth0, ks_used, first_batch)
    return red
