"""He-4 projection-time (tau = Nb*dt) convergence ladder on the PyTorch port.

The torch counterpart of tools/tau_ladder.py, through the port's Driver:
the reference's shipped diagonal workload (vpi.in:1-33: N=64, rho=0.365
sigma^-3, Chin action, bisection Nlev=4, Nstag=5; flagship.he4_rung_cfg) at
increasing bead counts, the mixed and thermodynamic energies per rung, and
the potential's tail correction dV/N = 2 pi rho int_rcut^inf V(r) r^2 dr
(flagship.tail_correction, on the port's own aziz2), which the literature
values include and the reference does not apply.  One JSON line per rung,
with tools/tau_ladder.py's keys, appended to <outdir>/tau_ladder.jsonl and
printed; a summary table at the end.  It imports nothing of JAX and runs
on the card, or on the CPU with PIGS_PLATFORM=cpu (as the CLI does).

Usage: python3 tools/torch_tau_ladder.py [outdir] [rungs] [W] [burnin]
           [nblocks] [nstep] [Np]
rungs: comma-separated Nb or Nb:dt (default the reference's ladder,
16,32,64,96,128,64:2.5e-3); the rest default to the reference's W=512,
8 burn-in blocks, 24 blocks of 50 steps, N=64.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.flagship import (  # noqa: E402
    KELVIN, he4_rung_cfg, tail_correction)
from tools.torch_card import card_line  # noqa: E402

# (Nb, dt) rungs of tools/tau_ladder.py; (64, 2.5e-3) repeats tau=0.16 at
# half the time step as the dt-error cross-check
LADDER = [(16, 5e-3), (32, 5e-3), (64, 5e-3), (96, 5e-3), (128, 5e-3),
          (64, 2.5e-3)]


def parse_rungs(text: str):
    out = []
    for item in text.split(","):
        nb, _, dt = item.partition(":")
        out.append((int(nb), float(dt) if dt else 5e-3))
    return out


def main():
    a = sys.argv[1:]
    outdir = a[0] if a else "build/tau_ladder"
    ladder = parse_rungs(a[1]) if len(a) > 1 else LADDER
    W = int(a[2]) if len(a) > 2 else 512
    burnin = int(a[3]) if len(a) > 3 else 8
    nblock = int(a[4]) if len(a) > 4 else 24
    nstep = int(a[5]) if len(a) > 5 else 50
    Np = int(a[6]) if len(a) > 6 else 64
    os.makedirs(outdir, exist_ok=True)
    device = _device()
    if device != "cpu":
        print(f"# {torch.cuda.get_device_name(0)} | {card_line()}",
              flush=True)
    log = os.path.join(outdir, "tau_ladder.jsonl")
    rows = []
    for Nb, dt in ladder:
        cfg = he4_rung_cfg(Nb, dt, W, nstep, nblock, Np=Np)
        rdir = os.path.join(outdir, f"Nb{Nb}_dt{dt:g}")
        t0 = time.time()
        drv = Driver(cfg, out_dir=rdir, device=device, verbose=False)
        drv.run_burnin(burnin)
        drv.run(nblock)
        dv = tail_correction(cfg.density, drv.system.geo.rcut)
        f = drv.final
        row = dict(Nb=Nb, dt=dt, tau=Nb * dt,
                   E=f["E"], dE=f["VarE"], Et=f["Et"], dEt=f["VarEt"],
                   V=f["V"], K=f["K"], tail=dv,
                   E_K=(f["E"] + dv) * KELVIN, dE_K=f["VarE"] * KELVIN,
                   Et_K=(f["Et"] + dv) * KELVIN, dEt_K=f["VarEt"] * KELVIN,
                   wall_s=round(time.time() - t0, 1), W=W, Np=Np,
                   burnin=burnin, nblocks=nblock, nstep=nstep,
                   device=str(drv.system.device))
        rows.append(row)
        with open(log, "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(json.dumps(row), flush=True)
        print(f"Nb={Nb:4d} dt={dt:g} tau={Nb*dt:.3f}  "
              f"E/N={row['E_K']:+.3f}({row['dE_K']:.3f}) K  "
              f"Et/N={row['Et_K']:+.3f}({row['dEt_K']:.3f}) K  "
              f"tail={dv*KELVIN:+.3f} K  [{row['wall_s']}s]", flush=True)

    print("\n# tau-convergence (tail-corrected, Kelvin/atom; "
          "literature -7.17 +/- 0.02 K):")
    for r in rows:
        print(f"  tau={r['tau']:.3f} (Nb={r['Nb']}, dt={r['dt']:g}): "
              f"mixed {r['E_K']:+.3f} +/- {r['dE_K']:.3f}   "
              f"thermo {r['Et_K']:+.3f} +/- {r['dEt_K']:.3f}")


if __name__ == "__main__":
    main()
