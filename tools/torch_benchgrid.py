"""Step-time grid over engine configurations (the flagship He-4 workload) on
the PyTorch port: the counterpart of tools/benchgrid.py, through
bench_torch's protocol (one warm-up block, then 3 timed blocks of NSTEP
steps, each ending in a device sync; the median block).  One line per
(W, variant): ms/step, bead-updates/s, peak device memory and the kernels'
launches over the timed blocks, then the card's name and power limit.

Usage: python3 tools/torch_benchgrid.py [--device cpu] [W ...]
           (default W: 512 4096 8192)
       PIGS_GRID=full python3 tools/torch_benchgrid.py 4096   (all variants)

The variants carry tools/benchgrid.py's names and configurations; on the
port:
  - `pallas rows deltas` (pallas_rows=True) runs the same kernels as
    `default`: the port's kernel-A route ignores pallas_rows
    (ops/kernels.rows_route).
  - `sta ends` and `unfused (reference order)` equal `default` as well:
    the flagship is the unfused sweep already, and end_regrow selects
    among the fused sweep's end moves only.
  - `no pallas at all` (use_pallas=False) runs the plain forms on the card.
Added: `fused` and `fused + cascade` (kernel 5), and `per level + random
end depth` (bis_monoshot=False, bis_end_random_depth=True), the step whose
end gates launch kernel 3 with kernel 4's pass.  A variant that raises
(an out-of-memory at a large W, say) prints FAILED with the error, and the
script then exits non-zero.
"""

import argparse
import gc
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_torch import (CPU_SHAPE, NREPS, NSTEP,  # noqa: E402
                         bead_updates_per_step, timed_blocks)
from pathintegralgroundstate_torch.flagship import flagship_cfg  # noqa: E402

SHORT = {"pair_rows": "A", "pair_pot": "B", "pair_delta": "3", "pair_u": "4",
         "cascade": "5", "bis_propose": "gp", "bis_accept": "ga",
         "pair_fold": "F"}


def variants(W: int, full: bool, device=None):
    """[(name, SimConfig)] at W walkers: `default` (the flagship; on the
    CPU, bench_torch's smoke shape), and with full the rest of the grid."""
    base = flagship_cfg(W)
    if device == "cpu":
        base = base.replace(**CPU_SHAPE)
    out = [("default", base)]
    if full:
        out += [
            ("exact_f2 (cached)", base.replace(exact_f2=True)),
            ("pallas rows deltas", base.replace(pallas_rows=True)),
            ("no pallas at all", base.replace(use_pallas=False)),
            ("sta ends", base.replace(end_regrow="sta")),
            ("unfused (reference order)", base.replace(fused_sweep=False)),
            ("measure_every=5", base.replace(measure_every=5)),
            ("fused", base.replace(fused_sweep=True)),
            ("fused + cascade", base.replace(fused_sweep=True, cascade=True)),
            ("per level + random end depth",
             base.replace(bis_monoshot=False, bis_end_random_depth=True)),
        ]
    return out


def run_one(name, cfg, W, device=None, nstep=NSTEP, nreps=NREPS) -> bool:
    """Time one variant and print its line; False if it raised."""
    per = bead_updates_per_step(cfg)
    try:
        run = timed_blocks(cfg, device, nstep, nreps)
    except Exception as e:  # noqa: BLE001 -- reported, and fails the exit
        print(f"W={W:6d} {name:30s} FAILED: {type(e).__name__}: {e}",
              flush=True)
        return False
    finally:
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    dt = float(np.median(run["reps"]))
    rate = per * nstep * W / dt
    peak = run["peak_mem_gib"]
    mem = "not measured" if peak is None else f"{peak:.3f} GiB"
    launches = " ".join(f"{SHORT[k]}:{n}" for k, n in run["launches"].items())
    reps = ", ".join(repr(r) for r in run["reps"])
    print(f"W={W:6d} {name:30s} {dt / nstep * 1e3:10.3f} ms/step   "
          f"{rate:.4e} bead-updates/s   peak {mem}   launches {launches}   "
          f"blocks [{reps}] s", flush=True)
    return True


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("walkers", nargs="*", type=int, default=[512, 4096, 8192])
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (each variant fails without one)")
    args = p.parse_args(argv)
    full = os.environ.get("PIGS_GRID", "") == "full"
    ok = True
    for W in args.walkers:
        for name, cfg in variants(W, full, args.device):
            ok &= run_one(name, cfg, W, args.device)
    if torch.cuda.is_available():
        from tools.torch_card import card_line
        print(card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
