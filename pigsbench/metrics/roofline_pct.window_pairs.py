"""The window pair pass (ops/pairwise.delta_action_rows, kernel A) against
its roofline, in %: the sum over the traced block's launches of each
launch's least time (harness/roofline.window_pairs, from the launch's own
shapes) over the sum of their device time.  Nothing when the launches seen
at the library's entry and the kernels in the trace do not match."""

from pigsbench.harness.roofline import least_seconds, window_pairs


def read(run):
    td = run.trace
    recs = td.launches.get("pair_rows", []) if td is not None else []
    secs, n = td.kernel_seconds("pair_rows_kernel") if td else (0.0, 0)
    if not recs or n != len(recs) or secs <= 0:
        return None
    return 100.0 * sum(least_seconds(*window_pairs(r), r["dtype"])
                       for r in recs) / secs
