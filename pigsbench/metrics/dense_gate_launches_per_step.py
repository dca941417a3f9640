"""Launches of the dense pass (`pair_delta_kernel`, csrc/pair_delta.cu:
kernel 3 with kernel 4's u pass, one per per-level end bisection's gate on
the kernel route) per traced step, from the device trace.  0 where the
gates took another form."""


def read(run):
    td = run.trace
    if td is None or not td.steps or not td.kernels:
        return None
    return td.kernel_seconds("pair_delta_kernel")[1] / td.steps
