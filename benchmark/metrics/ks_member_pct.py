"""The share of the traced segment the port spends in its span `ks.member`
(`coverage._layer_index`: the membership test `_index_of_reps`), host clock
under the profiler, in %."""

from benchmark.metrics.program_table import span_pct


def read(ctx):
    return span_pct(ctx, "ks.member")
