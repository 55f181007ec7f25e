"""Device ms a frame in the evaluation's overlap-add (`eval.accumulate`:
each fold's adds into the scale's map and count, and each finished
scale's division by the count, crop, resize back to native and sum) over
`eval.frames`, from the port's span recorder."""

from port_bench.spans import ms_per


def read(ctx):
    return ms_per("eval.accumulate", "eval.frames")
