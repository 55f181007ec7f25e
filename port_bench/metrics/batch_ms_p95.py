"""95th percentile (nearest rank) of every call's host-clock wall time in
the window, ms: the request path's call ends in a copy of its answer to
the host, which waits for the device."""

import math


def read(ctx):
    s = sorted(ctx.counters.batch_s)
    if not s:
        return None
    return 1e3 * s[math.ceil(0.95 * len(s)) - 1]
