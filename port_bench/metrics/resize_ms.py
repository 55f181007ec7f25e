"""Device ms a frame in the evaluation's input resizes (`eval.resize`:
each scale's bilinear resize and zero pad) over `eval.frames`, from the
port's span recorder."""

from port_bench.spans import ms_per


def read(ctx):
    return ms_per("eval.resize", "eval.frames")
