"""Targets certified at or under the threshold after the rescue rounds, over
all the window's batches, per second of the window."""


def read(ctx):
    return ctx["certified"] / ctx["window_s"]
