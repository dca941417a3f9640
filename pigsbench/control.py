"""The readings that the limits of a cell's comparison are set from.

    python3 pigsbench/control.py --workload <cell> --seeds a,b,... \
        --seconds <s> [--control <k>]

For each seed, in one process on the card: one run of the cell as
run.py makes it (set-up, warm-up block, the timed window of `seconds`),
its numbers against the float64 reference (the lower readings: the
program's sound runs), and for the first k seeds the control's: the
reference in the next lower precision than the configuration states
(bfloat16 for float32, float32 for float64) in the program's place, on
the same captured inputs and final state (the upper readings).  The first
k seeds also read each fault that the cell's path can have
(judge.faults: under exact F^2, with per-level bisections, with
per-walker windows) planted in the float64 reference put in the
program's place.  One JSON
line per seed, then one with the largest program reading and the
smallest control reading of each number, and each fault's smallest."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    from pigsbench.harness import counting, judge, manifest, window

    wl = manifest.workload(args.workload)
    limits = wl["check"]["limits"]
    port = window.port_modules()
    lower = high = None
    faults = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        run = window.run_cell(args.workload, seed, args.seconds, False,
                              "cuda", workload=wl, port=port)
        line = {"seed": seed, "blocks": run.blocks,
                "window_s": run.window_s, "setup_s": run.setup_s,
                "bead_updates_per_s": run.bead_updates_per_s,
                "peak_bytes": run.peak_bytes}
        answers = judge.program_answers(run)
        prog, _, failed = judge.judge(run, answers, limits)
        line["program"], line["failed"] = prog, failed
        if answers["book"] is not None:   # the last step's counters
            ctr = answers["book"]["counters"].tolist()
            line["counters"] = {n: v for n, v in zip(counting.COUNTER_NAMES,
                                                     ctr) if v}
        lower = prog if lower is None else {
            k: max(lower[k], prog[k]) for k in prog}
        if i < args.control:
            ctl = judge.judge(run, judge.control_answers(
                run, judge.LOWER[run.fields["dtype"]]), limits)[0]
            line["control"] = ctl
            high = ctl if high is None else {
                k: min(high[k], ctl[k]) for k in ctl}
            for f in judge.faults(run.fields):
                fv = judge.judge(run, judge.control_answers(
                    run, torch.float64, fault=f), limits)[0]
                line[f] = fv
                faults[f] = {k: min(faults[f][k], fv[k]) for k in fv} \
                    if f in faults else fv
        print(json.dumps(line), flush=True)
        del run
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower,
                      "upper": high, **faults}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
