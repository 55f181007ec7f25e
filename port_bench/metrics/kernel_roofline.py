"""The port's hand-written kernels' share of their roofline, %: the summed
bound time of their launches in the trace (each launch's work from the
cell's shapes by `work.py`, the benchmark's frozen counts) over their
summed device time. Nothing when no kernel of the cell launched."""

from port_bench.work import roofline_share


def read(ctx):
    if ctx.trace is None or ctx.peaks is None:
        return None
    return roofline_share(ctx.trace.kernel_launches, ctx.trace.kernel_device_s,
                          ctx.counters.kernel_work, ctx.peaks)
