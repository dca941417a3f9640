"""Command-line driver: `python -m pathintegralgroundstate_torch <vpi.in>`.

The torch counterpart of pathintegralgroundstate_tpu/cli.py: the same
arguments, the reference's namelist input files unchanged (vpi.in:1-37)
plus an optional `&tpu` group or `--set` overrides for the ensemble keys
(n_walkers, dtype, ...), the namelist echo and the reference's startup
banner (vpi.f90:161-194).

It runs on the card.  PIGS_PLATFORM=cpu (the reference CLI's own platform
override) runs the plain forms on the CPU instead; without a card and
without it, the run raises rather than fall back to the CPU.  With
crystal = T the start positions, the particle count, the box and the
density come from `config_ini.in` beside the input file (the reference's
crystal start, vpi.f90:101-107; cli.py:102-112).

Sharded over several processes it runs under torchrun, e.g.

    torchrun --nproc-per-node 2 -m pathintegralgroundstate_torch in.in \
        --set mesh_walkers=2

torchrun's environment (WORLD_SIZE) turns distributed on, each rank takes
the card cuda:(LOCAL_RANK % device_count), and only rank 0 prints and
writes the outputs (driver.py).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from .config import SimConfig, echo_namelists, load_namelist_config, \
    read_crystal_file
from .driver import Driver
from .utils import spans


def _parse_scalar(val: str):
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    if val.lower() in ("true", "t"):
        return True
    if val.lower() in ("false", "f"):
        return False
    return val


def _parse_override(kv: str):
    key, val = kv.split("=", 1)
    if "," in val:  # tuple values, e.g. --set a_ho=1.0,1.0,2.0
        return key, tuple(_parse_scalar(v) for v in val.split(",") if v)
    return key, _parse_scalar(val)


def _device():
    """The device of PIGS_PLATFORM: 'cpu' for the CPU; unset, 'gpu' or
    'cuda' for the card (None: make_system's default, which raises without
    one)."""
    want = os.environ.get("PIGS_PLATFORM", "").lower()
    if want == "cpu":
        return "cpu"
    if want in ("", "gpu", "cuda"):
        return None
    raise ValueError(f"PIGS_PLATFORM={want!r}: 'cpu', 'gpu' or 'cuda'")


def _profile_block(drv: Driver, out_dir: str) -> None:
    """One warm block under torch.profiler (CPU and, on the card, CUDA
    activities), written as a Chrome trace into out_dir; the program's
    `pigs::` spans (utils/spans.py) are in it as annotations."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if drv.system.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        drv.run(1)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    # the trace holds the spans; the block's read-back waited for their
    # events, so the in-memory copy can be released
    spans.take()


def main(argv=None):
    """The CLI; under torchrun every rank but rank 0 runs silently."""
    if int(os.environ.get("RANK", "0")) == 0:
        return _main(argv)
    with open(os.devnull, "w") as sink, contextlib.redirect_stdout(sink):
        return _main(argv)


def _main(argv=None):
    ap = argparse.ArgumentParser(
        prog="pathintegralgroundstate_torch",
        description="PIGS/VPI quantum Monte Carlo on PyTorch and CUDA")
    ap.add_argument("input", nargs="?", help="namelist input file (vpi.in format)")
    ap.add_argument("-o", "--out-dir", default=".", help="output directory")
    ap.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                    help="config override (repeatable), e.g. --set n_walkers=1024")
    ap.add_argument("--blocks", type=int, default=None,
                    help="override number of blocks")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="record a torch.profiler trace of one block into DIR")
    ap.add_argument("--burnin", type=int, default=0,
                    help="equilibration blocks discarded from global averages")
    args = ap.parse_args(argv)
    device = _device()

    overrides = dict(_parse_override(kv) for kv in args.set)
    if args.input:
        cfg = load_namelist_config(args.input, **overrides)
    else:
        cfg = SimConfig(**overrides)
    if "WORLD_SIZE" in os.environ and not cfg.distributed:
        cfg = cfg.replace(distributed=True)    # launched by torchrun
    # echo every namelist back to stdout for self-contained run provenance
    # (the reference does write(*,nml=...) after each read, vpi_mod.f90:64-75)
    echo_namelists(cfg)
    print("==============================================================")
    print("                VPI Monte Carlo (PyTorch / CUDA)              ")
    print("==============================================================")
    algo = "STAGING" if cfg.sampling == "sta" else "BISECTION"
    print(f"# Sampling algorithm  : {algo}")
    print(f"# Swap updates        : {cfg.swapping}")
    print("# Simulation parameters:")
    print(f"  > Dimensions          : {cfg.dim}")
    print(f"  > Number of particles : {cfg.Np}")
    print(f"  > Walker ensemble     : {cfg.n_walkers}")
    if cfg.trap:
        print(f"  > Trapping length     : {cfg.a_ho}")
    else:
        print(f"  > Density             : {cfg.density}")
    print(f"  > Number of beads     : {cfg.Nb}")
    print(f"  > Time step           : {cfg.dt}")
    print(f"  > Number of blocks    : {cfg.Nblock}")
    print(f"  > MC steps per block  : {cfg.Nstep}")

    init_positions = None
    if cfg.crystal:
        base = (os.path.dirname(os.path.abspath(args.input)) if args.input
                else ".")
        cpath = os.path.join(base, cfg.crystal_positions_file)
        Np, Lbox, density, init_positions = read_crystal_file(cpath)
        cfg = cfg.replace(Np=Np, density=density, crystal_Lbox=Lbox)
        print(f"# crystal start from {cpath}: Np={Np}, Lbox={Lbox}")

    drv = Driver(cfg, out_dir=args.out_dir, device=device,
                 init_positions=init_positions)
    if not cfg.trap:
        print(f"  > Size of the box     : {drv.system.geo.Lbox}")
    if args.burnin:
        drv.run_burnin(args.burnin)
    if args.profile:
        drv.run(1)  # warm
        _profile_block(drv, args.profile)
        print(f"# profiler trace written to {args.profile}")
        remaining = (args.blocks - 2) if args.blocks else None
        if remaining and remaining > 0:
            drv.run(remaining)
    else:
        drv.run(args.blocks)
    drv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
