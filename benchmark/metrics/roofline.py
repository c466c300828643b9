"""A chain kernel's share of its roofline over the traced segment: the sum
of each launch's bound (`flops.py`, at its depth, lanes and iterations, with
the LM's rebuilds as counted for these inputs) over the kernel's summed
device time in the trace."""

from __future__ import annotations

from benchmark.metrics import flops

LAUNCH = {"adam": flops.adam_launch, "lm": flops.lm_launch, "polish": flops.polish_launch}


def share(ctx: dict, kernel: str):
    tr = ctx.get("trace")
    if not tr:
        return None
    launches = [lch for lch in tr["launches"] if lch[0] == kernel]
    seconds = tr["kernel_s"].get(kernel, 0.0)
    if not launches or seconds <= 0:
        return None
    bound_ms = 0.0
    for _, k, lanes, iters in launches:
        fresh = () if kernel == "adam" else (tr["fresh"][(kernel, k)],)
        bound_ms += LAUNCH[kernel](k, lanes, iters, *fresh)["bound_ms"]
    return 100.0 * bound_ms / 1e3 / seconds
