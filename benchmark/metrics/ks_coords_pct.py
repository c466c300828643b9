"""The share of the traced segment the port spends in its span `ks.coords`
(`coverage._layer_index`: the targets' monodromy coordinates, the Jacobi
launches of `eig.joint_diag`), host clock under the profiler, in %."""

from benchmark.metrics.program_table import span_pct


def read(ctx):
    return span_pct(ctx, "ks.coords")
