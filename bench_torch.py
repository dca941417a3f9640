#!/usr/bin/env python3
"""Benchmark of the PyTorch port: the flagship workload (He-4, N=64, Nb=32,
Chin action, bisection Nlev=4, worm on; `flagship.flagship_cfg`, the
reference's shipped vpi.in) at W=1024 walkers, float32, with the Hopper
kernels on, on one NVIDIA GPU.  The counterpart of bench.py; it imports
torch, numpy and the port, nothing of JAX.

    python3 bench_torch.py [--walkers 256,1024,4096] [--steps 5] [--reps 3]
                           [--device cpu]

Protocol: one warm-up block (it absorbs the nvcc build of the kernels and
the caching allocator's growth; its seconds print as `warmup_s`), then
--reps timed blocks of --steps MC steps (`sweep.run_block`).  Each timed
block ends with torch.cuda.synchronize() and a read-back of the block's
counters before the host clock is read: the step is eager and issues tens
of thousands of launches, so a clock read without the sync would time the
host's enqueue.  The metric uses the median rep; every rep is printed
unrounded.  One JSON line per walker count, with bench.py's keys and the
card's name and power limit (`device`), ms per step, the peak device
memory of the timed blocks and the kernels' launches over them.

The count is the port's `sweep.bead_updates_per_step` (attempted updates;
the worm phase runs masked for every walker, so its updates are charged
per walker).  `useful_bead_updates_per_s` discounts the worm's updates by
the open-walker fraction the counters measured.

Switches:
  --device cpu               the plain forms on the CPU at W=8, N=16, Nb=8
                             (a smoke run; its rate is no device number).
                             Without a card and without it, make_system
                             raises: nothing falls back to the CPU.
  --walkers W1,W2,...        one line per walker count (default 1024; 8
                             with --device cpu).
  PIGS_BENCH_NO_PALLAS=1     use_pallas=False: the plain forms on the card
                             (every kernel route off); `pallas` prints false.
  PIGS_BENCH_CPU_BASELINE=1  measure the single-walker denominator instead:
                             flagship_cfg(1), use_pallas=False, on one CPU
                             thread; prints {"cpu_1walker_bead_updates_per_s",
                             "reps_s"}.
"""

import argparse
import json
import os
import time

import numpy as np
import torch

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import kernels as K
from pathintegralgroundstate_torch.state import init_state
from pathintegralgroundstate_torch.sweep import (_CIDX, Sweeper,
                                                 bead_updates_per_step,
                                                 run_block)
from pathintegralgroundstate_torch.system import make_system

NSTEP = 5
NREPS = 3
W_CARD = 1024
W_CPU = 8
# bench.py's CPU smoke shape with Lstag cut to Nb: the worm moves need
# Lstag <= Nb, and bench.py's own shape (the flagship's Lstag=32 at Nb=8)
# raises ValueError in both packages
CPU_SHAPE = dict(Nb=8, Np=16, Nstag=1, Nobdm=2, Lstag=8)

# The two denominators, measured 2026-10-17 on the host of an NVIDIA H100
# 80GB HBM3 (700 W), one core pinned with `taskset -c 0`; that host's
# /proc/cpuinfo gives its model name as "unknown" (8 cores visible).
# CPU_1WALKER: this port's flagship at one walker on one CPU thread, the
# plain forms (`PIGS_BENCH_CPU_BASELINE=1 taskset -c 0 python3
# bench_torch.py`).  NUMPY_REF: the plain-numpy transcription of the
# reference's serial diagonal loop (`taskset -c 0 python3
# tools/refloop_numpy.py`).
CPU_1WALKER_BEAD_UPDATES_PER_S = 14473.108627163438
NUMPY_REF_BEAD_UPDATES_PER_S = 11136.994316288092

KEYS = ("metric", "value", "unit", "vs_baseline", "vs_numpy_ref",
        "useful_bead_updates_per_s", "open_walker_frac", "walkers_per_s",
        "n_walkers", "reps_s", "pallas", "baseline_def",
        "counts_masked_lanes", "device", "ms_per_step", "peak_mem_gib",
        "warmup_s", "launches")


def bench_cfg(W: int, device=None):
    """The benchmark's configuration at W walkers: the flagship, or on the
    CPU the smoke shape CPU_SHAPE; use_pallas=False under
    PIGS_BENCH_NO_PALLAS."""
    cfg = flagship_cfg(W)
    if device == "cpu":
        cfg = cfg.replace(**CPU_SHAPE)
    if os.environ.get("PIGS_BENCH_NO_PALLAS", "") not in ("", "0"):
        cfg = cfg.replace(use_pallas=False)
    return cfg


def sync(device):
    """Wait for the card's queue (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_blocks(cfg, device=None, nstep=NSTEP, nreps=NREPS) -> dict:
    """One warm-up block, then nreps timed blocks of nstep steps on
    `device` (None: the card, raising without one).  Returns reps (seconds
    per block), the last block's counters (numpy), its StepStats, the
    warm-up's seconds, the peak device memory of the timed blocks in GiB
    (None on the CPU) and each kernel's launches over the timed blocks."""
    system = make_system(cfg, None if device == "cuda" else device)
    dev = system.device
    sweeper = Sweeper(system)
    state = init_state(system)
    sync(dev)
    t0 = time.perf_counter()
    state, stats = run_block(sweeper, state, nstep)
    sync(dev)
    stats.counters.cpu()
    warmup_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    kern = {"pair_rows": K.pair_rows, "pair_pot": K.pair_pot,
            "pair_delta": K.pair_delta, "pair_u": K.pair_u,
            "cascade": K.cascade, "bis_propose": K.bis_propose,
            "bis_accept": K.bis_accept, "pair_fold": K.pair_fold}
    for fn in kern.values():
        fn.launches = 0
    reps = []
    for _ in range(nreps):
        t0 = time.perf_counter()
        state, stats = run_block(sweeper, state, nstep)
        sync(dev)
        ctr = stats.counters.cpu().numpy()
        reps.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in kern.items()}
    peak = (torch.cuda.max_memory_allocated(dev) / 2 ** 30
            if dev.type == "cuda" else None)
    return {"reps": reps, "counters": ctr, "stats": stats,
            "warmup_s": warmup_s, "peak_mem_gib": peak, "launches": launches}


def rates(cfg, reps, counters, W: int, nstep: int) -> dict:
    """bench.py's rate arithmetic (bench.py:120-137) on the median of reps
    (seconds per block of nstep steps) and a block's counters: the rate,
    the useful rate (the worm's updates discounted by the open-walker
    fraction, from try_cm_half: 2 Nobdm nact per step, as in the
    reference), the open fraction, walkers/s, ms/step and both ratios."""
    dt = float(np.median(reps))
    per = bead_updates_per_step(cfg)
    rate = per * nstep * W / dt
    diag_per = bead_updates_per_step(
        cfg.replace(CWorm=0.0, Nobdm=0, swapping=False))
    worm_per = per - diag_per
    if cfg.CWorm > 0 and cfg.Nobdm > 0:
        open_frac = float(counters[_CIDX["try_cm_half"]]) / (
            2.0 * cfg.Nobdm * W * nstep)
    else:
        open_frac = 0.0
    useful = (diag_per + worm_per * open_frac) * nstep * W / dt
    return {"value": rate,
            "vs_baseline": rate / CPU_1WALKER_BEAD_UPDATES_PER_S,
            "vs_numpy_ref": rate / NUMPY_REF_BEAD_UPDATES_PER_S,
            "useful_bead_updates_per_s": useful,
            "open_walker_frac": round(open_frac, 4),
            "walkers_per_s": W * nstep / dt,
            "ms_per_step": dt / nstep * 1e3}


BASELINE_DEF = (
    "vs_baseline: this port's flagship at 1 walker, plain forms, 1 CPU "
    "thread of the H100's host (PIGS_BENCH_CPU_BASELINE=1): %.6g "
    "bead-updates/s; vs_numpy_ref: plain-numpy transcription of the "
    "reference's serial loop (tools/refloop_numpy.py, taskset -c 0, same "
    "host): %.6g bead-updates/s; both null on a CPU run"
    % (CPU_1WALKER_BEAD_UPDATES_PER_S, NUMPY_REF_BEAD_UPDATES_PER_S))


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    'cpu'."""
    if device.type != "cuda":
        return "cpu"
    from tools.torch_card import card_line
    return card_line()


def bench_line(cfg, W, device=None, nstep=NSTEP, nreps=NREPS) -> dict:
    """One benchmark line at W walkers (bench.py's keys and this port's)."""
    run = timed_blocks(cfg, device, nstep, nreps)
    st = run["stats"]
    for k in ("sumE", "sumEt"):
        if not bool(torch.isfinite(getattr(st, k))):
            raise RuntimeError(f"{k} of the last timed block is not finite")
    if run["counters"][_CIDX["try_cm"]] <= 0:
        raise RuntimeError("no CM move was tried in the last timed block")
    on_card = st.sumE.device.type == "cuda"
    r = rates(cfg, run["reps"], run["counters"], W, nstep)
    return {
        "metric": ("bead_updates_per_s_per_chip" if on_card
                   else "bead_updates_per_s_cpu"),
        "value": r["value"],
        "unit": "bead-updates/s/chip" if on_card else "bead-updates/s (cpu)",
        # the denominators are for the card's rate, not a CPU smoke run's
        "vs_baseline": r["vs_baseline"] if on_card else None,
        "vs_numpy_ref": r["vs_numpy_ref"] if on_card else None,
        "useful_bead_updates_per_s": r["useful_bead_updates_per_s"],
        "open_walker_frac": r["open_walker_frac"],
        "walkers_per_s": r["walkers_per_s"],
        "n_walkers": W,
        "reps_s": run["reps"],
        "pallas": bool(cfg.use_pallas),
        "baseline_def": BASELINE_DEF,
        "counts_masked_lanes": True,
        "device": device_line(st.sumE.device),
        "ms_per_step": r["ms_per_step"],
        "peak_mem_gib": run["peak_mem_gib"],
        "warmup_s": run["warmup_s"],
        "launches": run["launches"],
    }


def cpu_baseline(nstep=NSTEP, nreps=NREPS) -> dict:
    """The single-walker denominator: the flagship at W=1 with the plain
    forms on one CPU thread."""
    torch.set_num_threads(1)
    cfg = flagship_cfg(1).replace(use_pallas=False)
    reps = timed_blocks(cfg, "cpu", nstep, nreps)["reps"]
    rate = bead_updates_per_step(cfg) * nstep / float(np.median(reps))
    return {"cpu_1walker_bead_updates_per_s": rate, "reps_s": reps}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (raises without one)")
    p.add_argument("--walkers", default=None,
                   help="comma-separated walker counts, one line each")
    p.add_argument("--steps", type=int, default=NSTEP)
    p.add_argument("--reps", type=int, default=NREPS)
    args = p.parse_args(argv)
    if os.environ.get("PIGS_BENCH_CPU_BASELINE", "") not in ("", "0"):
        print(json.dumps(cpu_baseline(args.steps, args.reps)))
        return
    default_w = W_CPU if args.device == "cpu" else W_CARD
    ws = ([int(w) for w in args.walkers.split(",")] if args.walkers
          else [default_w])
    for W in ws:
        cfg = bench_cfg(W, args.device)
        print(json.dumps(bench_line(cfg, W, args.device, args.steps,
                                    args.reps)), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
