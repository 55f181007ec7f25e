"""The share of the evaluation loop's seconds spent waiting for the next
staged batch, %, from the timing that `MscEval.evaluate` reports."""


def read(ctx):
    c = ctx.counters
    if c.loop_s <= 0:
        return None
    return 100.0 * c.loader_wait_s / c.loop_s
