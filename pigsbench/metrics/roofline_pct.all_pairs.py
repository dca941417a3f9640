"""The all-pairs pass (ops/estimators.therm_energy -> pairwise.pair_pot,
kernel B) against its roofline, in %: least time from each launch's own
shapes (harness/roofline.all_pairs) over the launches' device time."""

from pigsbench.harness.roofline import all_pairs, least_seconds


def read(run):
    td = run.trace
    recs = td.launches.get("pair_pot", []) if td is not None else []
    secs, n = td.kernel_seconds("pair_pot_kernel") if td else (0.0, 0)
    if not recs or n != len(recs) or secs <= 0:
        return None
    return 100.0 * sum(least_seconds(*all_pairs(r), r["dtype"])
                       for r in recs) / secs
