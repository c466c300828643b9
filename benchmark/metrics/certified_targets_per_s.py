"""Targets certified at or under the threshold after the rescue rounds, over
all the window's batches, per second of the window (the main flow's
answered targets are its certified ones)."""


def read(ctx):
    return ctx["answered"] / ctx["window_s"]
