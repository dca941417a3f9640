"""The traced run's readings by stage of the program's step: the program's
own spans (`pathintegralgroundstate_torch/utils/spans.py`, recorded while
the profiler ran the traced block) matched with the trace
(`trace.TraceData`) on the clock both stamp, the Unix clock in ns.

Each host launch call (counted as `host_launches_per_step` counts them, a
call nested in another once) goes by its start, and each idle gap of the
device (as `trace.breakdown` finds them, between the block's first and
last device activity) by its midpoint, to the innermost span around it
that is not a move (`move.*`): a stage of the step (`open_close`, `cm`,
`mala`, `diag`, `worm`, `measure`), `step` (a step outside its stages),
`block` (outside its steps), `readback`, or no span at all (the harness's
own Python).  A stage's device time is the time between its two CUDA
events, summed over the block's steps.

The recorder is taken once per run and the result kept on the run.  A
program that records no spans (a checkout without them) reads None."""

from __future__ import annotations

import bisect
import importlib
import sys
from collections import Counter, defaultdict
from dataclasses import dataclass

from .trace import _LAUNCH
from .window import PORT

SPANS = f"{PORT}.utils.spans"
# the stages the per-layer metrics name; the rest is printed
STAGES = ("cm", "diag", "worm", "measure")
NO_SPAN = "(no span)"


@dataclass
class StageData:
    steps: int
    launches: Counter    # label -> launch calls
    idle_ns: Counter     # label -> ns of idle gaps
    device_ms: dict      # span name -> ms between its events, summed
    counters: dict       # the program's counters over the block
    names: set           # every span name recorded
    launch_calls: int    # the trace's own count
    gap_ns: int          # every idle gap


def launch_starts(td) -> list:
    """Start (ns) of each host launch call of the trace, a call nested in
    another counted once."""
    starts, end = [], None
    calls = sorted(((s, e) for n, s, e in td.host_ops
                    if n.startswith(_LAUNCH)), key=lambda c: (c[0], -c[1]))
    for s, e in calls:
        if end is not None and s < end:
            continue
        starts.append(s)
        end = e
    return starts


def idle_gaps(td) -> list:
    """(start, end) ns of the device's idle gaps between its first and
    last activity, as trace.breakdown finds them."""
    gaps, end = [], None
    for s, e in sorted((s, e) for _, s, e in td.kernels + td.memops):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def segments(spans) -> list:
    """[(start ns, label)]: from each start on, the innermost span that
    is not a move (NO_SPAN outside every span)."""
    level = sorted(((s.t0_ns, s.t1_ns, s.name) for s in spans
                    if not s.name.startswith("move.")),
                   key=lambda x: (x[0], -x[1]))
    segs, stack = [], []

    def mark(t, label):
        if segs and segs[-1][0] == t:
            segs[-1] = (t, label)
        else:
            segs.append((t, label))

    def close_until(t):
        while stack and (t is None or stack[-1][0] <= t):
            end = stack.pop()[0]
            mark(end, stack[-1][1] if stack else NO_SPAN)

    for t0, t1, name in level:
        close_until(t0)
        stack.append((t1, name))
        mark(t0, name)
    close_until(None)
    return segs


def attribute(spans, td, counters) -> StageData:
    segs = segments(spans)
    starts = [t for t, _ in segs]

    def label(t):
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][1] if i >= 0 else NO_SPAN

    gaps = idle_gaps(td)
    idle = Counter()
    for g0, g1 in gaps:
        idle[label((g0 + g1) // 2)] += g1 - g0
    device = defaultdict(float)
    for s in spans:
        if s.device_ms is not None:
            device[s.name] += s.device_ms
    return StageData(
        steps=td.steps, launches=Counter(label(t) for t in launch_starts(td)),
        idle_ns=idle, device_ms=dict(device), counters=dict(counters),
        names={s.name for s in spans}, launch_calls=td.launch_calls,
        gap_ns=sum(g1 - g0 for g0, g1 in gaps))


def report(sd: StageData) -> str:
    """What the four stages hold and what no stage covers, per step, with
    the two sums that must hold."""
    n = sd.steps
    rest = [k for k in sorted(set(sd.launches) | set(sd.idle_ns)
                              | set(sd.device_ms)) if k not in STAGES]

    def row(k):
        dev = sd.device_ms.get(k)
        return (f"  {k:12s} launches {sd.launches.get(k, 0) / n:11.1f}  "
                f"idle ms {sd.idle_ns.get(k, 0) * 1e-6 / n:10.3f}  "
                f"device ms {'-' if dev is None else f'{dev / n:.3f}'}")

    lines = [f"stages, per traced step ({n} steps):"]
    lines += [row(k) for k in STAGES if k in sd.names]
    st_l = sum(sd.launches.get(k, 0) for k in STAGES)
    st_i = sum(sd.idle_ns.get(k, 0) for k in STAGES)
    st_d = sum(sd.device_ms.get(k, 0.0) for k in STAGES)
    rest_l = sum(sd.launches.values()) - st_l
    rest_i = sum(sd.idle_ns.values()) - st_i
    block = sd.device_ms.get("block")
    rest_d = "-" if block is None else f"{(block - st_d) / n:.3f}"
    lines.append(f"  outside the four stages: launches {rest_l / n:.1f}, "
                 f"idle ms {rest_i * 1e-6 / n:.3f}, device ms {rest_d} "
                 "(the block's less the stages'), of which:")
    lines += ["  " + row(k) for k in rest]
    lines.append(
        f"  sums: launches {(st_l + rest_l) / n:.1f} against "
        f"host_launches_per_step {sd.launch_calls / n:.1f}; idle ms "
        f"{(st_i + rest_i) * 1e-6 / n:.3f} against the gaps' "
        f"{sd.gap_ns * 1e-6 / n:.3f}; the stages' device ms "
        f"{st_d / n:.3f} against the block's "
        f"{'-' if block is None else f'{block / n:.3f}'}")
    return "\n".join(lines)


def read(run):
    """The run's StageData (taken once, printed once to standard error),
    or None: no trace, or a program without spans."""
    if "_stages" in vars(run):
        return run._stages
    run._stages = None
    td = run.trace
    if td is None or not td.steps:
        return None
    try:
        spans = importlib.import_module(SPANS)
    except ImportError:
        return None
    recorded, counters = spans.take()
    if not recorded:
        return None
    run._stages = attribute(recorded, td, counters)
    print(report(run._stages), file=sys.stderr)
    return run._stages


def _stage(run, stage):
    sd = read(run)
    return sd if sd is not None and stage in sd.names else None


def launches_per_step(run, stage):
    sd = _stage(run, stage)
    return None if sd is None else sd.launches.get(stage, 0) / sd.steps


def idle_ms_per_step(run, stage):
    sd = _stage(run, stage)
    return (None if sd is None
            else sd.idle_ns.get(stage, 0) * 1e-6 / sd.steps)


def device_ms_per_step(run, stage):
    sd = _stage(run, stage)
    ms = None if sd is None else sd.device_ms.get(stage)
    return None if ms is None else ms / sd.steps


def host_ints_per_step(run):
    sd = read(run)
    return None if sd is None else sd.counters.get("host_int", 0) / sd.steps
