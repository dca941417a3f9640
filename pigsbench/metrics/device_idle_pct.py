"""Share of the traced block's wall time in which no kernel, memcpy or
memset runs on the card (the union of their intervals in the profiler's
trace), in %.  The profiler slows the host: this is the traced run's."""


def read(run):
    td = run.trace
    if td is None or td.window_s <= 0 or not (td.kernels or td.memops):
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
