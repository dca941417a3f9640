"""Run one cell of the benchmark once.

    python3 pigsbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the program
(pathintegralgroundstate_torch) beside this folder, on a machine with the
card(s) the cell asks for.  The last line of standard output is one JSON
object: correct, attempted, failed, metrics (the cell's end-to-end metrics
with --trace 0, its per-layer metrics with --trace 1), device (and with
--trace 1 breakdown), and last `checks`, each number compared beside its
limit, which are also the last lines of standard error.  Exit codes: 2 no
card or too few; 3 a JAX module was loaded; 1 any other failure (no
result line).

The kernels are built by the program on first use into build/ inside the
checkout; the CUDA JIT cache and PyTorch's kernel cache are kept there
too."""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The process's start on the perf_counter clock (from /proc where it
    can be read: the interpreter's own start-up counts as set-up)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 600.0:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return _T0


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t0 = _process_start()

    # one process with one CPU thread: the host's dispatch sets the pace of
    # the host-bound cells, and idle spinning pool threads only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    # the CUDA JIT cache and PyTorch's runtime-compiled kernels, inside
    # the checkout (the program builds its own kernels into build/ too)
    build = REPO / "build"
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))
    os.environ.setdefault("PYTORCH_KERNEL_CACHE_PATH",
                          str(build / "torch_kernels"))
    sys.path.insert(0, str(REPO))

    import torch
    torch.set_num_threads(1)

    from pigsbench.harness import guard, judge, manifest, trace, window

    bench = manifest.manifest()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 1
    chips = entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); {have} "
              "present", file=sys.stderr)
        return 2
    workload = manifest.workload(args.workload)
    limits = workload["check"]["limits"]

    run = window.run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda", t0=t0, workload=workload)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3

    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in manifest.cell_metrics(bench, args.workload, kind):
        value = manifest.metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": run.peak_bytes,
              "power_limit": _power_limit()}
    extra = {}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        extra["breakdown"] = trace.breakdown(run.trace)
        print(f"traced block: {run.trace.launch_calls} launch calls, "
              f"{len(run.trace.kernels)} kernels, "
              f"{len(run.trace.memops)} memops over {run.trace.steps} steps",
              file=sys.stderr)
        run.trace = None

    answers = judge.program_answers(run)
    vals, attempted, failed = judge.judge(run, answers, limits)
    ok = judge.correct(vals, limits) and run.blocks > 0
    bad = guard.forbidden_loaded()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"{args.workload} seed {args.seed}: {run.blocks} blocks of "
          f"{workload['steps_per_block']} steps in {run.window_s:.3f} s, "
          f"set-up {run.setup_s:.3f} s, {device['kind']}, "
          f"{device['power_limit']}", file=sys.stderr)
    checks = {k: {"value": vals[k], "limit": limits[k]}
              for k in limits}
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line = {"correct": ok, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device, **extra,
            "checks": checks}
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
