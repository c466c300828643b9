"""The share of the traced segment the port spends in its span `ks` outside
`ks.coords` and `ks.member` (`coverage._layer_index`'s own time: the row
tables built on every call, the wait for the device's answer and its copy
to the host), host clock under the profiler, in %."""

from benchmark.metrics.program_table import program_table


def read(ctx):
    table = program_table(ctx)
    if table is None or "ks" not in table["spans"]:
        return None
    return 100.0 * table["spans"]["ks"]["self_seconds"] / ctx["trace"]["window_s"]
