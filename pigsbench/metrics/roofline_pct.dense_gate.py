"""The dense action pass (ops/pairwise.delta_action: kernel 3 with kernel
4's u pass, the per-level end bisections' gate) against its roofline, in
%: the sum over the traced block's launches of each launch's least time
(harness/roofline.dense_gate, from the launch's own shapes) over the sum
of their device time.  Nothing when the launches seen at the library's
entry and the kernels in the trace do not match, or when a launch is not
in the action mode."""

from pigsbench.harness.roofline import DENSE_ACTION, dense_gate, least_seconds


def read(run):
    td = run.trace
    recs = td.launches.get("pair_delta", []) if td is not None else []
    secs, n = td.kernel_seconds("pair_delta_kernel") if td else (0.0, 0)
    if (not recs or n != len(recs) or secs <= 0
            or any(r["mode"] != DENSE_ACTION for r in recs)):
        return None
    return 100.0 * sum(least_seconds(*dense_gate(r), r["dtype"])
                       for r in recs) / secs
