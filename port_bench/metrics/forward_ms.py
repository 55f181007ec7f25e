"""Device ms a frame in the forwards, from the port's span recorder: the
`serve.forward` spans' device time (normalising, the logits, the argmax)
over `serve.frames`, or the `eval.forward` spans' (each fold's forward,
flip and softmax) over `eval.frames`, whichever the process recorded:
a cell runs one path. CUDA events on the stream, idle time inside a span
included."""

from port_bench.spans import ms_per


def read(ctx):
    for path in ("serve", "eval"):
        value = ms_per(f"{path}.forward", f"{path}.frames")
        if value is not None:
            return value
    return None
