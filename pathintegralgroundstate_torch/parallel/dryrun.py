"""The sharded dry run: one block of each of the reference's two dry-run
configurations over a real dp x tp mesh, held equal to the unsharded block.

The port's counterpart of __graft_entry__.dryrun_multichip
(__graft_entry__.py:54-121): with W = 2 x world walkers, the mesh is
dp x tp = world/2 x 2 when the world is even (else world x 1), and it runs

  1. "default": the shipped flagship default order (fused_sweep=False,
     exact_f2=False, partial dF^2, bisection, worm on);
  2. "fused+exact_f2": the fused composites with the exact-F^2 odd-bead
     cache,

each as one sharded Driver block and as the unsharded block of the same
configuration on every rank, and asserts the counters equal, sumE, sumEt,
sumV and n_diag within rtol 1e-9 and the gathered paths within rtol 1e-9.

Run it on every rank of a process group:

    torchrun --nproc-per-node 4 -m pathintegralgroundstate_torch.parallel.dryrun

(`--cpu` puts the ranks on the CPU); rank 0 prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch.distributed as dist

from ..config import SimConfig
from .mesh import gather_state, init_from_env

CONFIGS = (
    ("default", dict(fused_sweep=False, exact_f2=False,
                     jastrow="mcmillan_c1"), False),
    ("fused+exact_f2", dict(fused_sweep=True, exact_f2=True), True),
)


def dryrun_cfg(world: int, **kw) -> SimConfig:
    """The reference's dry-run base (He-4-like, small) for `world` ranks."""
    n_tp = 2 if world % 2 == 0 and world > 1 else 1
    base = dict(
        dim=3, Np=8, density=0.365, trap=False,
        dt=5e-3, Nb=8, sampling="bis", Lstag=4, Nlev=2, Nstag=1,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=True, CWorm=0.5, Nobdm=2, Npw=0,
        n_walkers=2 * world, dtype="float64", potential="aziz2",
        mesh_walkers=world // n_tp, mesh_pairs=n_tp, Nstep=2, Nblock=1)
    base.update(kw)
    return SimConfig(**base)


def dryrun_multichip(device=None, out_dir=None) -> dict:
    """Run the dry run on this rank of the initialised process group;
    returns {config: {"ms": sharded block ms, "collectives": n, "max_rel":
    largest relative difference of the compared sums}}."""
    from ..driver import Driver
    world = dist.get_world_size()
    out_dir = out_dir or tempfile.mkdtemp(prefix="pigs_dryrun_")
    report = {}
    for tag, kw, fused in CONFIGS:
        cfg = dryrun_cfg(world, **kw)
        runs = []
        for c in (cfg, cfg.replace(mesh_walkers=1, mesh_pairs=1)):
            drv = Driver(c, out_dir=os.path.join(out_dir, tag), device=device,
                         verbose=False)
            assert drv.sweeper.fused_diag == fused, tag
            t0 = time.perf_counter()
            state, stats = drv._block()
            dt = time.perf_counter() - t0
            runs.append((drv, gather_state(drv.system, state), stats, dt))
        (drv_s, st_s, stats_s, dt_s), (_, st_1, stats_1, _) = runs
        assert drv_s.mesh.dp * drv_s.mesh.tp == world
        c_s, c_1 = (stats_s.counters.cpu().numpy(),
                    stats_1.counters.cpu().numpy())
        assert c_s[0] > 0, tag                      # CM tries happened
        np.testing.assert_array_equal(c_s, c_1, err_msg=tag)
        rel = 0.0
        for nm in ("sumE", "sumEt", "sumV", "n_diag"):
            a, b = float(getattr(stats_s, nm)), float(getattr(stats_1, nm))
            np.testing.assert_allclose(a, b, rtol=1e-9, err_msg=f"{tag}:{nm}")
            rel = max(rel, abs(a - b) / max(abs(b), 1e-300))
        np.testing.assert_allclose(st_s.paths.cpu().numpy(),
                                   st_1.paths.cpu().numpy(), rtol=1e-9,
                                   atol=1e-12, err_msg=tag)
        report[tag] = dict(mesh=[drv_s.mesh.dp, drv_s.mesh.tp],
                           ms=1e3 * dt_s, max_rel=rel,
                           collectives=drv_s.mesh.collectives)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pathintegralgroundstate_torch."
                                 "parallel.dryrun")
    ap.add_argument("--cpu", action="store_true", help="ranks on the CPU")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    init_from_env(device)
    report = dryrun_multichip(device)
    if dist.get_rank() == 0:
        print(json.dumps({"dryrun": report, "world": dist.get_world_size(),
                          "backend": dist.get_backend()}), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
