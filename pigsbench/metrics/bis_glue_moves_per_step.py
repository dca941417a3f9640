"""Monoshot bisection moves per traced step whose glue ran in the
program's two glue kernels: the launches of `bis_accept_kernel`
(csrc/bis_glue.cu, one per move on the kernel route: the unfused sweep's
head, tail and interior moves) in the traced block over its steps.  0 on a
program without that kernel or where no move took that route."""

import re

BIS_ACCEPT = re.compile(r"\bbis_accept_kernel\b")


def read(run):
    td = run.trace
    if td is None or not td.steps or not td.kernels:
        return None
    return sum(1 for n, _, _ in td.kernels if BIS_ACCEPT.search(n)) / td.steps
