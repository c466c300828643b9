"""The program's own spans and counters over the traced segment.

The port records them while a profiler records (its `utils.profiling`), so
its table (`profiling.table()`) holds the traced segment and nothing else:
not the window, the warm-up or the re-runs after the segment. A tree whose
program has no such table gives None, as does a segment in which the card
did nothing (the CPU's plain run)."""

from __future__ import annotations


def program_table(ctx: dict):
    """The port's table of the traced segment, or None."""
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    try:
        from slam_decomposition_torch.utils import profiling
    except ImportError:
        return None
    table = getattr(profiling, "table", None)
    return table() if table is not None else None


def span_pct(ctx: dict, name: str):
    """Host seconds inside the program's span ``name`` over the traced
    segment, in %."""
    table = program_table(ctx)
    if table is None or name not in table["spans"]:
        return None
    return 100.0 * table["spans"][name]["seconds"] / ctx["trace"]["window_s"]


def counted_roofline_pct(ctx: dict, kernel: str, wrapper: str, launch):
    """A chain kernel's share of its roofline over the traced segment, its
    work from the program's own counts: for each (depth, iterations) the
    bound ``launch(k, lanes, iters, rebuilds / lanes)`` of all its lanes
    (`flops.py`), summed, over the kernel's summed device time, in %."""
    seconds = ctx["trace"]["kernel_s"].get(kernel, 0.0) if ctx.get("trace") else 0.0
    table = program_table(ctx) if seconds > 0 else None
    if table is None:
        return None
    counted = [(k, iters, rec) for (w, k, iters), rec in table["kernels"].items()
               if w == wrapper and rec["lanes"] and "rebuilds" in rec]
    if not counted:
        return None
    bound_ms = sum(launch(k, rec["lanes"], iters, rec["rebuilds"] / rec["lanes"])["bound_ms"]
                   for k, iters, rec in counted)
    return 100.0 * bound_ms / 1e3 / seconds
