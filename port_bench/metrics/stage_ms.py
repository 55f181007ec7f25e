"""Host ms a request-path call spends staging its frames (`serve.stage`:
the checks, the wait for the last copy out of the pinned buffer, the
frames copied into it), over the `serve.call` spans, from the port's span
recorder. The device's stream is empty throughout: the call before ended
in a blocking download."""

from port_bench.spans import ms_per


def read(ctx):
    return ms_per("serve.stage", "serve.call", clock="host_s")
