"""Targets assigned a depth over all the window's batches, per second of the
window (the ks flow's answered targets)."""


def read(ctx):
    return ctx["answered"] / ctx["window_s"]
