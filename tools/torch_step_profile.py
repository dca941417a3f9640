"""Where the torch port's step spends its time, on one CUDA device.

    python3 tools/torch_step_profile.py [--walkers 1024]
        [--scan 256,1024,4096] [--forms flagship,fused,cascade,reforder,sta]

--forms lists the steps: `flagship` (the unfused sweep), `fused`
(fused_sweep=True), `cascade` (fused_sweep=True, cascade=True),
`reforder` (the reference-order step: bis_monoshot=False,
bis_end_random_depth=True) or `sta` (sampling='sta').
Prints, in float32 after one warm-up step:
  1. for the first form, host time per move function in one step, first
     without and then with a device sync after each call (the second shows
     what the device adds);
  2. for each form, one step under torch.profiler: the device's busy share
     of the step's wall time (kernel time only), the number of kernel
     launches, the device time and launches of kernels A (pair_rows) and 5
     (cascade), and the kernels that take the most time;
  3. ms/step and bead-updates/s at each W of --scan for each form of
     --forms (2 steps after 1 warm-up); two or more forms are timed in the
     order given and then in reverse, so that drift in the host's speed
     shows.
Every time is printed beside the card's name and power limit.
"""

import argparse
import collections
import pathlib
import subprocess
import sys
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from pathintegralgroundstate_torch import sweep as SW  # noqa: E402
from pathintegralgroundstate_torch.flagship import flagship_cfg  # noqa: E402
from pathintegralgroundstate_torch.state import init_state  # noqa: E402
from pathintegralgroundstate_torch.system import make_system  # noqa: E402

PHASES = [(SW.wm, "close_chain"), (SW.wm, "open_chain"),
          (SW.mv, "translate_chain"), (SW.bis, "move_head_bisection"),
          (SW.bis, "move_tail_bisection"), (SW.bis, "bisection"),
          (SW.mv, "translate_half_chain"), (SW.mv, "move_head_half_chain"),
          (SW.mv, "move_tail_half_chain"), (SW.mv, "staging_half_chain"),
          (SW.wm, "swap_move"), (SW.wm, "obdm_terms"),
          (SW.bis, "fused_end_bisections"), (SW.bis, "bisection_multi"),
          (SW.mv, "fused_end_stagings"), (SW.cas, "fused_ends_cascade"),
          (SW.cas, "interior_cascade"), (SW.cas, "rigid_cascade"),
          (SW.mv, "staging_move"), (SW.mv, "move_head"),
          (SW.mv, "move_tail"), (SW.Sweeper, "_measure")]
FORMS = {"flagship": {}, "fused": {"fused_sweep": True},
         "cascade": {"fused_sweep": True, "cascade": True},
         "reforder": {"bis_monoshot": False, "bis_end_random_depth": True},
         "sta": {"sampling": "sta"}}


def timed_step(sweeper, state):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _ = SW.run_block(sweeper, state, 1)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def phase_times(sweeper, state, sync: bool):
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
        return call

    for mod, name in PHASES:
        setattr(mod, name, timed(name, orig[name]))
    try:
        state, wall = timed_step(sweeper, state)
    finally:
        for mod, name in PHASES:
            setattr(mod, name, orig[name])
    how = "sync after each call" if sync else "host only"
    print(f"[phases] {how}: step {wall * 1e3:.1f} ms")
    for name, t in total.most_common():
        print(f"[phases]   {name:22s} {calls[name]:4d} calls {t * 1e3:9.1f} ms"
              f" {t / calls[name] * 1e6:8.1f} us/call")
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
    for label, key in (("kernel A", "pair_rows_kernel"),
                       ("kernel 5", "cascade_kernel")):
        mine = [e for e in kern if key in e.key]
        print(f"[profile]   {label} ({key}): "
              f"{sum(e.self_device_time_total for e in mine) / 1e3:.2f} ms "
              f"in {sum(e.count for e in mine)} launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d}x {e.key[:90]}")
    return state


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--walkers", type=int, default=1024)
    ap.add_argument("--scan", default="256,1024,4096")
    ap.add_argument("--forms", default="flagship",
                    help=f"comma-separated forms of {sorted(FORMS)}; each "
                         "is profiled, the first also by move")
    args = ap.parse_args()
    forms = args.forms.split(",")
    for f in forms:
        if f not in FORMS:
            ap.error(f"unknown form {f!r}: one of {sorted(FORMS)}")
    if not torch.cuda.is_available():
        sys.exit("torch_step_profile: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[device] {card} | torch {torch.__version__}")

    for k, form in enumerate(forms):
        print(f"[form] {form}: {FORMS[form]}")
        system = make_system(flagship_cfg(args.walkers).replace(
            **FORMS[form]), "cuda")
        sweeper = SW.Sweeper(system)
        state, _ = SW.run_block(sweeper, init_state(system), 1)
        if k == 0:
            for sync in (False, True):
                state = phase_times(sweeper, state, sync)
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
