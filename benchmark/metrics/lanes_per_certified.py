"""Multi-start lanes launched over the window (the port's own count of the
Adam kernel's lanes, `chain_kernels.lane_counts()`: chunk x restarts a
solve, first pass and rescues) per target certified."""


def read(ctx):
    lanes = sum(ctx["lanes"].get("adam_chain", []))
    if not lanes or not ctx["answered"]:
        return None
    return lanes / ctx["answered"]
