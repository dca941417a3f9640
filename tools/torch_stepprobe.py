"""Component timing of one flagship MC step on the PyTorch port: the
counterpart of tools/stepprobe.py.

    python3 tools/torch_stepprobe.py [--walkers 4096] [--calls 10]
                                     [--device cpu]

Times each component of the step on its own, with the port's own functions
and draws (the draw is part of each call, as in the step), at the
flagship's shape (on the CPU, bench_torch's smoke shape): one warm-up
call, then --calls calls between two device syncs, each on its own copy
of the ensemble.  Then the step rebuilt from the components as
tools/stepprobe.py weighs them, its four subtotals, and one measured
`run_block` step (after a warm-up step) for comparison.  Every time is
printed beside the card's name and power limit.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from bench_torch import CPU_SHAPE, sync  # noqa: E402
from pathintegralgroundstate_torch.flagship import flagship_cfg  # noqa: E402
from pathintegralgroundstate_torch.ops import bisection as bis  # noqa: E402
from pathintegralgroundstate_torch.ops import estimators as est  # noqa: E402
from pathintegralgroundstate_torch.ops import moves as mv  # noqa: E402
from pathintegralgroundstate_torch.ops import worm as wm  # noqa: E402
from pathintegralgroundstate_torch.state import init_state  # noqa: E402
from pathintegralgroundstate_torch.sweep import (  # noqa: E402
    BATCH_RAND_MAX_W, Sweeper, run_block)
from pathintegralgroundstate_torch.system import make_system  # noqa: E402


def probe(cfg, device=None, calls=10):
    """Time the flagship step's components, then one run_block step; print
    a line per component, the reconstruction and the measured step."""
    system = make_system(cfg, None if device == "cuda" else device)
    dev = system.device
    sweeper = Sweeper(system)
    state = init_state(system)
    W, Np, Nb, Lstag, nlev = (cfg.n_walkers, cfg.Np, cfg.Nb, cfg.Lstag,
                              cfg.Nlev)
    src = sweeper.draws(state)
    active = torch.ones(W, dtype=torch.bool, device=dev)
    ones = torch.ones(W, dtype=system.dtype, device=dev)
    iworm, delta = state.iworm, sweeper.delta
    # the step's draws for its end moves: batched randoms up to
    # BATCH_RAND_MAX_W walkers, else the keyed form (the dense end gate)
    use_rand = sweeper.batch_rand and W <= BATCH_RAND_MAX_W
    n_bis = (system.M - 1 - 2 ** nlev) // 2 + 1
    n_opts = (Nb - Lstag) // 2 + 1
    ip = 3 % Np

    def ends(tail):
        mover = bis.move_tail_bisection if tail else bis.move_head_bisection
        return lambda p, x: mover(system, p, ip, active, max(nlev, 2),
                                  src.bisect(25 + tail, ip, W, max(nlev, 2)),
                                  not use_rand)

    comps = [
        ("therm", "therm_energy", lambda p, x: est.therm_energy(system, p)),
        ("local", "local_energy x2", lambda p, x: (
            est.local_energy(system, p[:, 0]),
            est.local_energy(system, p[:, -1]))),
        ("gr", "gr+sk", lambda p, x: (
            est.pair_correlation(system, p[:, Nb], ones),
            est.structure_factor(system, cfg.Nk, p[:, Nb]))),
        ("cm", "translate_chain", lambda p, x: mv.translate_chain(
            system, p, ip, active, delta, *src.translate(10, ip, W))),
        ("bis", "bisection", lambda p, x: bis.bisection(
            system, p, ip, active, nlev, src.bisect(27, ip, W, nlev, n_bis))),
        ("headb", "head_bisection", ends(False)),
        ("tailb", "tail_bisection", ends(True)),
        ("th", "translate_half", lambda p, x: mv.translate_half_chain(
            system, p, x, iworm, 1, active, delta, *src.translate(31, 0, W))),
        ("hh", "head_half", lambda p, x: mv.move_head_half_chain(
            system, p, x, iworm, 1, active, Lstag,
            *src.regrow_half(41, 0, W, Lstag))),
        ("sh", "staging_half", lambda p, x: mv.staging_half_chain(
            system, p, x, iworm, 1, active, Lstag,
            *src.staging_half(45, 0, W, n_opts, Lstag))),
        ("swap", "swap", lambda p, x: wm.swap_move(
            system, p, x, iworm, active, Lstag, src.swap(0, W, Np, Lstag))),
        ("open", "open_chain", lambda p, x: wm.open_chain(
            system, p, x, iworm, active, Lstag, src.worm(3, W, Lstag))),
    ]
    t = {}
    for key, name, fn in comps:
        # the moves write the ensemble in place: each on its own copy
        p, x = state.paths.clone(), state.xend.clone()
        fn(p, x)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(p, x)
        sync(dev)
        t[key] = (time.perf_counter() - t0) / calls
        print(f"{name:24s} {t[key] * 1e3:9.3f} ms")
        del p, x

    parts = {
        "CM total": Np * t["cm"],
        "bis sweeps": cfg.Nstag * Np * (t["bis"] + t["headb"] + t["tailb"]),
        "worm updates": cfg.Nobdm * (2 * t["th"] + 2 * (2 * t["hh"] + t["sh"])
                                     + t["swap"]),
        "estimators": t["therm"] + t["local"] + t["gr"],
    }
    rebuilt = sum(parts.values()) + t["open"]
    print(f"\nreconstructed step: {rebuilt * 1e3:.1f} ms")
    for name, s in parts.items():
        print(f"  {name:14s} {s * 1e3:8.1f} ms")

    state, _ = run_block(sweeper, state, 1)      # warm-up step
    sync(dev)
    t0 = time.perf_counter()
    state, _ = run_block(sweeper, state, 1)
    sync(dev)
    print(f"measured run_block step: "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--walkers", type=int, default=4096)
    p.add_argument("--calls", type=int, default=10)
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="default: the card (raises without one)")
    args = p.parse_args(argv)
    cfg = flagship_cfg(args.walkers)
    if args.device == "cpu":
        cfg = cfg.replace(**CPU_SHAPE)
    print(f"flagship W={cfg.n_walkers} Np={cfg.Np} M={cfg.M} {cfg.dtype}, "
          f"{args.calls} calls per component")
    probe(cfg, args.device, args.calls)
    if torch.cuda.is_available():
        from tools.torch_card import card_line
        print(card_line())


if __name__ == "__main__":
    main()
