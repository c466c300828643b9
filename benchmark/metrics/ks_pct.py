"""The share of the window spent inside the benchmark's span around the
k assignment (`coverage.monodromy_ks_batch`, which returns numpy, so the
span ends synchronised), in %."""


def read(ctx):
    if "ks" not in ctx["span_s"]:
        return None
    return 100.0 * ctx["span_s"]["ks"] / ctx["window_s"]
