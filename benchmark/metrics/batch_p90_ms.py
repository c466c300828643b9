"""The 90th percentile of the wall time of a batch over all the window's
batches, in ms (the run prints the sample count on standard error)."""

import statistics


def read(ctx):
    if len(ctx["batch_s"]) == 1:
        return 1e3 * ctx["batch_s"][0]
    return 1e3 * statistics.quantiles(ctx["batch_s"], n=10, method="inclusive")[-1]
