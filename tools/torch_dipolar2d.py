"""2-D dipolar Bose gas at N=256 (BASELINE configuration #5) on the PyTorch
port, end to end.

The torch counterpart of tools/dipolar2d.py, with the same configuration
(flagship.dipolar_cfg: the dipolar potential Cdd/r^3 with the zero-energy
dipolar Jastrow, density 0.25, Nb 8, the fused bisection sweep, float64)
and the same physics checks, through the port's Driver on one device and
without the reference's dp x tp mesh: the mixed and the thermodynamic
energy per particle are positive (a purely repulsive gas), g(r) has the
dipolar correlation hole (g[0] < 0.05, g[1] < 0.5) and tends to 1 at long
range.  It prints one JSON line with E/N, Et/N, the g(r) bins and the
block's ms/step.

It runs on the card, or on the CPU with PIGS_PLATFORM=cpu (as the CLI
does); it imports nothing of JAX.

Usage: python3 tools/torch_dipolar2d.py [out_dir] [nblocks] [n_walkers]
       [burnin] [cascade]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.flagship import dipolar_cfg  # noqa: E402


def build_cfg(**kw):
    """tools/dipolar2d.py's build_cfg without the mesh: dipolar_cfg with
    overrides."""
    return dipolar_cfg().replace(**kw)


def run(cfg, outdir, burnin=3, device=None):
    drv = Driver(cfg, out_dir=outdir, verbose=False, device=device)
    drv.run_burnin(burnin)
    t0 = time.perf_counter()
    acc = drv.run()
    return drv, acc, time.perf_counter() - t0


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "build/dipolar2d"
    nblocks = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    walkers = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    burnin = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    cascade = len(sys.argv) > 5 and sys.argv[5] in ("1", "T", "true")
    cfg = build_cfg(Nblock=nblocks, n_walkers=walkers, cascade=cascade)
    drv, acc, seconds = run(cfg, outdir, burnin, _device())
    nb = acc["diag_bl"]
    E = acc["AvE"] / nb / cfg.Np
    Et = acc["AvEt"] / nb / cfg.Np
    gr = np.asarray(acc["AvGr"]) / nb
    print(json.dumps({
        "E_per_N": E, "Et_per_N": Et, "gr_head": gr[:8].tolist(),
        "gr_tail_mean": float(np.mean(gr[-10:])), "blocks": nblocks,
        "n_walkers": walkers, "cascade": cascade,
        "ms_per_step": seconds / (nblocks * cfg.Nstep) * 1e3,
        "device": str(drv.system.device)}))
    assert np.isfinite(E) and np.isfinite(Et)
    assert E > 0 and Et > 0, "a repulsive dipolar gas has positive energy"
    assert gr[0] < 0.05 and gr[1] < 0.5, f"no correlation hole: {gr[:5]}"
    assert abs(np.mean(gr[-10:]) - 1.0) < 0.35, f"g(r) tail: {gr[-10:]}"
    print("OK: E/N > 0, Et/N > 0, dipolar correlation hole, g(r) -> 1")


if __name__ == "__main__":
    main()
