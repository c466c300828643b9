"""The lm kernel's share of its roofline (`roofline.share`), in %."""

from benchmark.metrics.roofline import share


def read(ctx):
    return share(ctx, "lm")
