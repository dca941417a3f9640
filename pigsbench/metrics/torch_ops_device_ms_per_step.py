"""Device milliseconds per traced step of every kernel that is not one of
the program's hand-written pair kernels: the glue of the moves, the draws
and the estimators as PyTorch's own kernels run it."""

from pigsbench.harness.trace import PORT_KERNEL


def read(run):
    td = run.trace
    if td is None or not td.steps or not td.kernels:
        return None
    ns = sum(e - s for n, s, e in td.kernels if not PORT_KERNEL.search(n))
    return ns * 1e-6 / td.steps
