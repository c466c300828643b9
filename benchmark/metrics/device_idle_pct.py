"""The share of the traced segment in which no kernel, copy or set ran on
the card, in %."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
