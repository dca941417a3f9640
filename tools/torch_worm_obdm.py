"""He-4 worm-sector run on the PyTorch port: the OBDM n(r) and the
condensate fraction.

The torch counterpart of tools/worm_obdm.py, with its configuration, its
plateau estimate and its output, through the port's Driver: the
reference's shipped workload (vpi.in:1-33) with the worm on (CWorm=0.5,
swapping, Nobdm=10); the condensate fraction n0 is the mean of the
normalized one-body density matrix n(r) (nr_vpi.out) over the outer third
of the radial range.  Literature for liquid He-4 at equilibrium density:
n0 ~ 7-8 % (Boninsegni 2006; experiment ~7.25 %).  It writes
<outdir>/condensate.json (the reference tool's keys), prints n(r), and
prints the same record as one JSON line.  It imports nothing of JAX and
runs on the card, or on the CPU with PIGS_PLATFORM=cpu.

Usage: python3 tools/torch_worm_obdm.py [outdir] [nblocks] [Nb] [dt] [W]
           [burnin] [nstep] [Np]
(defaults: build/worm_obdm, 40, 32, 5e-3, 512, 8, 50, 64, as
tools/worm_obdm.py).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.config import SimConfig  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from tools.torch_card import card_line  # noqa: E402


def main():
    a = sys.argv[1:]
    outdir = a[0] if a else "build/worm_obdm"
    nblocks = int(a[1]) if len(a) > 1 else 40
    Nb = int(a[2]) if len(a) > 2 else 32
    dt = float(a[3]) if len(a) > 3 else 5e-3
    W = int(a[4]) if len(a) > 4 else 512
    burnin = int(a[5]) if len(a) > 5 else 8
    nstep = int(a[6]) if len(a) > 6 else 50
    Np = int(a[7]) if len(a) > 7 else 64
    cfg = SimConfig(
        dim=3, Np=Np, density=0.365, trap=False,
        dt=dt, Nb=Nb, sampling="bis", Lstag=32, Nlev=4, Nstag=5,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=True, CWorm=0.5, Nobdm=10, Npw=0,
        n_walkers=W, dtype="float32", potential="aziz2",
        Nstep=nstep, Nblock=nblocks, seed=2024,
    )
    device = _device()
    if device != "cpu":
        print(f"# {torch.cuda.get_device_name(0)} | {card_line()}",
              flush=True)
    t0 = time.time()
    drv = Driver(cfg, out_dir=outdir, device=device, verbose=False)
    drv.run_burnin(burnin)
    acc = drv.run(nblocks)

    nob = max(acc["obdm_bl"], 1)
    avn = acc["AvNr"][0] / nob
    vn = np.sqrt(np.maximum(acc["AvNr2"][0] / nob - avn**2, 0) / nob)
    rbin = drv.system.geo.rbin
    r = (np.arange(1, cfg.Nbin + 1) - 0.5) * rbin
    # plateau: the outer third of the radial range, where the short-range
    # structure has decayed (worm_obdm.py:66-70)
    sel = slice(2 * cfg.Nbin // 3, cfg.Nbin)
    n0 = float(np.mean(avn[sel]))
    dn0 = float(np.sqrt(np.mean(vn[sel] ** 2) / max(sel.stop - sel.start, 1)))
    ph = acc["perm_hist"]
    out = dict(n0=n0, dn0=dn0, Nb=Nb, dt=dt, W=W,
               obdm_blocks=int(acc["obdm_bl"]),
               diag_blocks=int(acc["diag_bl"]),
               perm_hist=[int(x) for x in ph],
               wall_s=round(time.time() - t0, 1), Np=Np, burnin=burnin,
               nblocks=nblocks, nstep=nstep, device=str(drv.system.device))
    with open(os.path.join(outdir, "condensate.json"), "w") as fh:
        json.dump(out, fh, indent=1)
    print("r, n(r), err:")
    for i in range(cfg.Nbin):
        print(f"  {r[i]:7.3f}  {avn[i]:9.5f}  {vn[i]:8.5f}")
    print(f"\ncondensate fraction n0 = {100*n0:.2f} +/- {100*dn0:.2f} % "
          f"(literature ~7-8%)  [{out['wall_s']}s, "
          f"{acc['obdm_bl']} OBDM super-blocks]")
    print("permutation-cycle histogram:", ph[:16])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
