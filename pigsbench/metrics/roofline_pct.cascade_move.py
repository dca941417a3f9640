"""The whole-move cascade (ops/cascade, kernel 5: the ends and interior
composites) against its roofline, in %: the sum over the traced block's
launches of each launch's least time (harness/roofline.cascade_move, from
the launch's own shapes) over the sum of their device time.  Nothing when
the launches seen at the library's entry and the kernels in the trace do
not match."""

from pigsbench.harness.roofline import cascade_move, least_seconds


def read(run):
    td = run.trace
    recs = td.launches.get("cascade", []) if td is not None else []
    secs, n = td.kernel_seconds("cascade_kernel") if td else (0.0, 0)
    if not recs or n != len(recs) or secs <= 0:
        return None
    return 100.0 * sum(least_seconds(*cascade_move(r), r["dtype"])
                       for r in recs) / secs
