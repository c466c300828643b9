"""The lm kernel's share of its roofline with its J rebuilds as the kernels
counted them (`program_table.counted_roofline_pct`), in %."""

from benchmark.metrics import flops
from benchmark.metrics.program_table import counted_roofline_pct


def read(ctx):
    return counted_roofline_pct(ctx, "lm", "lm_chain", flops.lm_launch)
