"""The traced run's readings: one window block under `torch.profiler`
(CPU and CUDA activities, kept in memory), and the shapes of each launch
of the program's pair kernels (kernels A, B and the dense kernel 3) and of
its whole-move cascade (kernel 5), read at the benchmark's own span around
the call into the kernels' library.

From the trace: the device intervals (kernels, memcpy, memset) and their
union (busy seconds), the host's launch calls (kernel launches, memcpy,
memset, graph launches, runtime or driver API, a call nested inside
another launch call counted once), each kernel's device time, and the
device's idle gaps attributed to the innermost host operation running at
each gap's midpoint.  The profiler slows the host, so every reading is
the traced run's."""

from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

PORT_KERNEL = re.compile(r"\b(pair_rows|pair_pot|pair_delta|cascade)_kernel\b")
_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
           "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


@dataclass
class TraceData:
    steps: int
    window_s: float
    kernels: list = field(default_factory=list)   # (name, start_ns, end_ns)
    memops: list = field(default_factory=list)    # (name, start_ns, end_ns)
    host_ops: list = field(default_factory=list)  # (name, start_ns, end_ns)
    launch_calls: int = 0
    launches: dict = field(default_factory=dict)  # kernel -> [shape record]

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e)
                              for _, s, e in self.kernels + self.memops])

    def kernel_seconds(self, pattern: str) -> tuple:
        """(device seconds, count) of the kernels whose name has
        `pattern` as a whole word."""
        rx = re.compile(rf"\b{pattern}\b")
        hits = [e - s for n, s, e in self.kernels if rx.search(n)]
        return sum(hits) * 1e-9, len(hits)


def union_seconds(intervals) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total * 1e-9


def _kind(ev) -> str:
    try:
        kind = str(ev.activity_type())
    except AttributeError:
        kind = ""
    name = ev.name()
    dev = str(ev.device_type())
    if dev.endswith("CUDA"):
        if "memcpy" in kind.lower() or name.startswith("Memcpy"):
            return "memop"
        if "memset" in kind.lower() or name.startswith("Memset"):
            return "memop"
        if "kernel" in kind.lower() or kind == "":
            return "kernel"
        return "other"
    if name.startswith(_LAUNCH):
        return "launch"
    if name.startswith(("aten::", "cuda", "cu")):
        return "host"
    return "other"


def _count_launch_calls(calls) -> int:
    """Launch calls not nested inside another launch call of the same
    thread (a runtime-API call and the CUDA driver-API call it makes count
    once)."""
    n = 0
    ends = {}
    for tid, s, e in sorted(calls, key=lambda c: (c[0], c[1], -c[2])):
        if tid in ends and s < ends[tid]:
            continue
        ends[tid] = e
        n += 1
    return n


def read_profile(prof, steps: int, window_s: float) -> TraceData:
    td = TraceData(steps=steps, window_s=window_s)
    calls = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind == "other":
            continue
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if kind == "kernel":
            td.kernels.append((ev.name(), s, e))
        elif kind == "memop":
            td.memops.append((ev.name(), s, e))
        else:
            if kind == "launch":
                calls.append((ev.start_thread_id(), s, e))
            td.host_ops.append((ev.name(), s, e))
    td.launch_calls = _count_launch_calls(calls)
    return td


def breakdown(td: TraceData, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the innermost host operation at each gap's middle."""
    by_name = defaultdict(int)
    for n, s, e in td.kernels + td.memops:
        by_name[n[:160]] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    # idle gaps of the device between its first and last activity
    iv = sorted((s, e) for _, s, e in td.kernels + td.memops)
    gaps, end = [], None
    for s, e in iv:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    hosts = sorted(td.host_ops, key=lambda h: h[1])
    starts = [h[1] for h in hosts]
    idle = defaultdict(int)
    active, j = [], 0   # heap of (-start, end, name): latest start on top
    for g0, g1 in sorted(gaps):
        mid = (g0 + g1) // 2
        while j < len(hosts) and starts[j] <= mid:
            heapq.heappush(active, (-hosts[j][1], hosts[j][2], hosts[j][0]))
            j += 1
        while active and active[0][1] < mid:   # ended: no later gap either
            heapq.heappop(active)
        name = active[0][2] if active else "(no host operation)"
        idle[name[:160]] += g1 - g0
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v * 1e-9] for n, v in ops],
            "idle_gaps": [[n, v * 1e-9] for n, v in gaps_top]}


class LaunchTap:
    """Records each launch's shapes from the argument structs the program
    hands its kernels' library: pass-through wrappers on the library's
    entry points for the window pair pass, the all-pairs pass, the dense
    pass (kernel 3, with kernel 4's u: the per-level end gate) and the
    whole-move cascade."""

    def __init__(self, lib):
        self.lib = lib
        self.records = defaultdict(list)
        self._saved = {}

    def _wrap(self, name, kind, dtype):
        fn = getattr(self.lib, name)
        recs = self.records[kind]

        def rows(*args):
            p, a = args[0]._obj, args[1]._obj
            recs.append(dict(dtype=dtype, W=a.W, B=a.B, N=a.N, D=p.dim,
                             M=a.M, ip_mode=a.ip_mode, ib_mode=a.ib_mode,
                             need_wf=a.need_wf, need_f2=a.need_f2,
                             reduce=a.reduce, row_weights=bool(args[8]),
                             pot_kind=p.pot_kind, jas_kind=p.jas_kind))
            return fn(*args)

        def pot(*args):
            p, a = args[0]._obj, args[1]._obj
            recs.append(dict(dtype=dtype, W=a.W, B=a.B, N=a.N, D=p.dim,
                             force=int(args[3]), pot_kind=p.pot_kind))
            return fn(*args)

        def dense(*args):
            # (params, rows, R, xnew, xold, ip, mode, with_force, ib, tab,
            #  out0, out1, stream); ib_mode and M are set in the action mode
            p, a = args[0]._obj, args[1]._obj
            recs.append(dict(dtype=dtype, mode=int(args[6]),
                             force=int(args[7]), W=a.W, B=a.B, N=a.N,
                             D=p.dim, M=a.M, ip_mode=a.ip_mode,
                             ib_mode=a.ib_mode, pot_kind=p.pot_kind,
                             jas_kind=p.jas_kind))
            return fn(*args)

        def cascade(*args):
            # (params, move, paths, 3 strides, rg, ru, act, 2 strides, acc,
            #  W, S, N, L, nlev, ends, bulk, stream)
            p, a = args[0]._obj, args[1]._obj
            W, S, N, L, nlev, ends = args[12:18]
            beads = {a.bead0[s] + a.dir[s] * q for s in range(S)
                     for q in range(L + 1)}
            recs.append(dict(dtype=dtype, mode="ends" if ends else
                             "interior", W=W, S=S, N=N, D=p.dim, L=L,
                             nlev=nlev, beads=len(beads),
                             pot_kind=p.pot_kind, jas_kind=p.jas_kind))
            return fn(*args)

        self._saved[name] = fn
        setattr(self.lib, name, {"pair_rows": rows, "pair_pot": pot,
                                 "pair_delta": dense,
                                 "cascade": cascade}[kind])

    def install(self):
        for dtype in ("f32", "f64", "bf16"):
            for kind in ("pair_rows", "pair_pot", "pair_delta", "cascade"):
                self._wrap(f"pigs_{kind}_{dtype}", kind, dtype)

    def uninstall(self):
        for name, fn in self._saved.items():
            setattr(self.lib, name, fn)
        self._saved = {}


def profiled(block, sync, steps: int, lib=None) -> tuple:
    """Run block() once under the profiler (and the launch tap when lib is
    given); returns (its result, TraceData)."""
    from torch.profiler import ProfilerActivity, profile

    tap = LaunchTap(lib) if lib is not None else None
    if tap:
        tap.install()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = block()
            sync()
            window_s = time.perf_counter() - t0
    finally:
        if tap:
            tap.uninstall()
    td = read_profile(prof, steps, window_s)
    if tap:
        td.launches = dict(tap.records)
    return out, td
