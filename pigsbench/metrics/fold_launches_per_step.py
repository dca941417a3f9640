"""Launches of the exact-F^2 fold kernel (`pair_fold_kernel`,
csrc/pair_fold.cu: one per window call that carries the force-field
cache's rows, on the kernel route) per traced step, from the device trace.
0 on a program without that kernel or where the fold took its plain
form."""

import re

PAIR_FOLD = re.compile(r"\bpair_fold_kernel\b")


def read(run):
    td = run.trace
    if td is None or not td.steps or not td.kernels:
        return None
    return sum(1 for n, _, _ in td.kernels if PAIR_FOLD.search(n)) / td.steps
