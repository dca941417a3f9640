"""Where the torch port's step spends its time, on one CUDA device.

    python3 tools/torch_step_profile.py [--walkers 1024]
        [--scan 256,1024,4096]
        [--forms flagship,fused,cascade,reforder,sta,exact,brute,windows]
        [--kernels] [--split] [--root DIR]

--forms lists the steps: `flagship` (the unfused sweep), `fused`
(fused_sweep=True), `cascade` (fused_sweep=True, cascade=True),
`reforder` (the reference-order step: bis_monoshot=False,
bis_end_random_depth=True), `sta` (sampling='sta'), `exact` (the flagship
with exact_f2=True, the odd-bead cache), `brute` (exact_f2=True,
f2_cache=False) or `windows` (the flagship with per-walker windows,
shared_windows=False).
Prints, in float32 after one warm-up step:
  1. for the first form, host time per move function in one step, first
     without and then with a device sync after each call (the second shows
     what the device adds); with --split, for every form, the same two
     passes over the pair-level functions under the moves (the plain
     window pass, the fold, the field pass, kernels B, 3, 4), each time
     inclusive of the functions it calls;
  2. for each form, one step under torch.profiler: the device's busy share
     of the step's wall time (kernel time only), the number of kernel
     launches, the device time and launches of each of the five kernels
     (A pair_rows, B pair_pot, 3 pair_delta, 4 pair_u, 5 cascade; where
     kernel 4's pass runs inside kernel 3's launch, kernel 4 shows no
     launches of its own), and the kernels that take the most time;
  3. with --kernels, on the first form's paths after its warm-up step:
     kernel B's two ThermEnergy calls (without and with force) and the
     dense delta_action at the end gate's rows [W, 1, N, D], by CUDA
     events over 20 calls each, in turns;
  4. ms/step and bead-updates/s at each W of --scan for each form of
     --forms (2 steps after 1 warm-up); two or more forms are timed in the
     order given and then in reverse, so that drift in the host's speed
     shows.
Every time is printed beside the card's name and power limit.  --root DIR
runs the package of another checkout at DIR (an earlier commit unpacked
with `git archive`), so that two commits compare in one call.
"""

import argparse
import collections
import pathlib
import sys
import time

import torch

KERNELS = (("A", "pair_rows_kernel"), ("B", "pair_pot_kernel"),
           ("3", "pair_delta_kernel"), ("4", "pair_u_kernel"),
           ("5", "cascade_kernel"))
FORMS = {"flagship": {}, "fused": {"fused_sweep": True},
         "cascade": {"fused_sweep": True, "cascade": True},
         "reforder": {"bis_monoshot": False, "bis_end_random_depth": True},
         "sta": {"sampling": "sta"},
         "exact": {"exact_f2": True},
         "brute": {"exact_f2": True, "f2_cache": False},
         "windows": {"shared_windows": False}}


def timed_step(sweeper, state):
    from pathintegralgroundstate_torch import sweep as SW
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = SW.run_block(sweeper, state, 1)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def move_phases():
    from pathintegralgroundstate_torch import sweep as SW
    return [(SW.wm, "close_chain"), (SW.wm, "open_chain"),
              (SW.mv, "translate_chain"), (SW.bis, "move_head_bisection"),
              (SW.bis, "move_tail_bisection"), (SW.bis, "bisection"),
              (SW.mv, "translate_half_chain"),
              (SW.mv, "move_head_half_chain"),
              (SW.mv, "move_tail_half_chain"), (SW.mv, "staging_half_chain"),
              (SW.wm, "swap_move"), (SW.wm, "obdm_terms"),
              (SW.bis, "fused_end_bisections"), (SW.bis, "bisection_multi"),
              (SW.mv, "fused_end_stagings"), (SW.cas, "fused_ends_cascade"),
              (SW.cas, "interior_cascade"), (SW.cas, "rigid_cascade"),
              (SW.mv, "staging_move"), (SW.mv, "move_head"),
              (SW.mv, "move_tail"), (SW.Sweeper, "_measure")]


def pair_phases():
    """The pair-level functions under the moves, as their callers reach
    them (through the module attribute): the exact-F^2 fold branch
    (_fold_rows, with its pair pass pair_side and the fold algebra _fold),
    the brute rows (_brute_rows: the plain window pass pair_terms_ref and
    kernel B twice), the cache's field pass, and kernels A, B, 3, 4."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops import pairwise as PW
    from pathintegralgroundstate_torch import sweep as SW
    return [(PW, "_fold_rows"), (K, "pair_side"), (PW, "_fold"),
            (PW, "_brute_rows"), (K, "pair_terms_ref"), (SW, "force_field"),
            (K, "pair_rows"), (K, "pair_pot"), (K, "pair_delta"),
            (K, "pair_u")]


def phase_times(sweeper, state, sync: bool, PHASES=None, what="phases"):
    PHASES = PHASES or move_phases()
    total, calls = collections.Counter(), collections.Counter()
    orig = {name: getattr(mod, name) for mod, name in PHASES}

    def timed(name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            total[name] += time.perf_counter() - t0
            calls[name] += 1
            return out
        # a kernel wrapper counts its launches on its own attributes, which
        # it reaches through the module's name: share them
        call.__dict__ = fn.__dict__
        return call

    for mod, name in PHASES:
        setattr(mod, name, timed(name, orig[name]))
    try:
        state, wall = timed_step(sweeper, state)
    finally:
        for mod, name in PHASES:
            setattr(mod, name, orig[name])
    how = "sync after each call" if sync else "host only"
    print(f"[{what}] {how}: step {wall * 1e3:.1f} ms")
    for name, t in total.most_common():
        print(f"[{what}]   {name:22s} {calls[name]:5d} calls "
              f"{t * 1e3:9.1f} ms {t / calls[name] * 1e6:8.1f} us/call")
    return state


def device_profile(sweeper, state, card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, wall = timed_step(sweeper, state)
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    if not kern:
        print("[profile] device time: not measured (no kernel events)")
        return state
    busy = sum(e.self_device_time_total for e in kern) / 1e3    # ms
    launches = sum(e.count for e in kern)
    print(f"[profile] step {wall * 1e3:.1f} ms under the profiler; kernels "
          f"{busy:.1f} ms busy ({100 * busy / (wall * 1e3):.1f} %), "
          f"{launches} launches ({card})")
    for label, key in KERNELS:
        mine = [e for e in kern if key in e.key]
        print(f"[profile]   kernel {label} ({key}): "
              f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} ms "
              f"in {sum(e.count for e in mine)} launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x {e.key[:90]}")
    return state


def events_ms(fn, reps=20):
    """Device ms per call of fn(): reps calls queued behind a device sleep,
    so the events time the device's work and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def kernel_times(system, paths, card):
    """Kernel B's two ThermEnergy calls and the dense delta_action at the
    end gate's rows of bead 0 (particle 5 moved by 0.05), in turns."""
    from pathintegralgroundstate_torch.ops.pairwise import (delta_action,
                                                            pair_pot)
    M = system.M
    R0 = paths[:, :1]
    xold = R0[:, :, 5]
    xnew = (xold + 0.05).contiguous()
    ib = system.arange(0, 1)
    cases = {"pair_pot force=False": lambda: pair_pot(
                 system, paths[:, 0:M - 1:2], False),
             "pair_pot force=True": lambda: pair_pot(
                 system, paths[:, 1:M - 1:2], True),
             "delta_action": lambda: delta_action(system, R0, xnew, xold, 5,
                                                  ib)}
    times = collections.defaultdict(list)
    for name in list(cases) + list(cases)[::-1]:
        times[name].append(events_ms(cases[name]))
    shape = tuple(paths.shape)
    for name, ts in times.items():
        print(f"[kernels] {name} (paths {shape}, float32): "
              + ", ".join(f"{t:.4f}" for t in ts) + f" ms ({card})")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walkers", type=int, default=1024)
    ap.add_argument("--scan", default="256,1024,4096")
    ap.add_argument("--forms", default="flagship",
                    help=f"comma-separated forms of {sorted(FORMS)}; each "
                         "is profiled, the first also by move")
    ap.add_argument("--kernels", action="store_true",
                    help="time kernel B's two calls and the dense "
                         "delta_action on the first form's paths")
    ap.add_argument("--split", action="store_true",
                    help="time the pair-level functions of every form, "
                         "without and with a sync after each call")
    ap.add_argument("--root", default=str(
        pathlib.Path(__file__).resolve().parents[1]),
        help="checkout whose package runs (default: this one)")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.root).resolve()))
    from pathintegralgroundstate_torch import sweep as SW
    from pathintegralgroundstate_torch.flagship import flagship_cfg
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.system import make_system

    forms = args.forms.split(",")
    for f in forms:
        if f not in FORMS:
            ap.error(f"unknown form {f!r}: one of {sorted(FORMS)}")
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    # this script's own directory, not --root's: torch_card is a sibling
    from torch_card import card_line
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} | package "
          f"{pathlib.Path(SW.__file__).resolve().parents[1]}")

    for k, form in enumerate(forms):
        print(f"[form] {form}: {FORMS[form]}")
        system = make_system(flagship_cfg(args.walkers).replace(
            **FORMS[form]), "cuda")
        sweeper = SW.Sweeper(system)
        state, _ = SW.run_block(sweeper, init_state(system), 1)
        if k == 0:
            for sync in (False, True):
                state = phase_times(sweeper, state, sync)
            if args.kernels:
                kernel_times(system, state.paths, card)
        if args.split:
            for sync in (False, True):
                state = phase_times(sweeper, state, sync, pair_phases(),
                                    "split")
        device_profile(sweeper, state, card)

    order = forms + forms[::-1] if len(forms) > 1 else forms
    runs = [(W, f) for W in map(int, filter(None, args.scan.split(",")))
            for f in order]
    for W, form in runs:
        cfg = flagship_cfg(W).replace(**FORMS[form])
        system = make_system(cfg, "cuda")
        sweeper = SW.Sweeper(system)
        state, _ = SW.run_block(sweeper, init_state(system), 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = SW.run_block(sweeper, state, 2)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / 2
        print(f"[scan] {form} W={W}: {dt * 1e3:.1f} ms/step, "
              f"{W * SW.bead_updates_per_step(cfg) / dt:.4e} bead-updates/s "
              f"({card})")


if __name__ == "__main__":
    main()
