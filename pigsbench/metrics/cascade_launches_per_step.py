"""Launches of the whole-move cascade kernel (`cascade_kernel`,
csrc/cascade.cu) per traced step, from the device trace: the ends and
interior composites that ran on kernel 5.  A route that falls back to the
plain form (`ops.cascade.cascade_ref`) reads fewer."""


def read(run):
    td = run.trace
    if td is None or not td.steps or not td.kernels:
        return None
    return td.kernel_seconds("cascade_kernel")[1] / td.steps
