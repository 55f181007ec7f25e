"""Device idle share of the traced window, %: 100 x (1 - the union of the
device's kernel and copy intervals / the traced window), from
`torch.profiler`'s CUDA activities."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
