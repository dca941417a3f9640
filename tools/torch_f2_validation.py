"""The reference's partial-dF^2 measure distortion on He-4, on the PyTorch
port.

The torch counterpart of tools/f2_validation.py, through the port's Driver:
the flagship's diagonal workload (tools/tau_ladder.py's rung, N=64 at
0.365 sigma^-3, Chin action, bisection Nlev=4, Nstag=5, no worm) run twice,
with exact_f2 False (the reference's moved-particle |F_ip|^2 only,
vpi_mod.f90:2825) and True (the exact Chin F^2, through the odd-bead
force-field cache), at W=256 float32.  It reports the mixed and
thermodynamic energies per atom in Kelvin with the potential's tail
correction added, one JSON line per setting.  The exact form should close
the mixed-vs-thermodynamic gap that the partial form opens.

It carries its own copies of tools/tau_ladder.py's rung_cfg and
tail_correction (that module imports JAX) and imports nothing of JAX.  It
runs on the card, or on the CPU with PIGS_PLATFORM=cpu (as the CLI does).

Usage: python3 tools/torch_f2_validation.py [outdir] [Nb] [nblocks]
           [burnin] [Nstep]
(defaults: build/f2_validation, 32, 16, 6, 50, as tools/f2_validation.py).
"""

import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.config import SimConfig  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.models.potentials import \
    get_potential  # noqa: E402

KELVIN = 1.85505  # the reference's unit scale (system_mod.f90:163)
W = 256


def tail_correction(density: float, rcut: float) -> float:
    """dV/N in configuration units, 2 pi rho int_rcut^inf V(r) r^2 dr (a
    copy of tools/tau_ladder.tail_correction: aziz2 to 10 rcut on a log
    grid, the trapezoid rule)."""
    v = get_potential("aziz2").v
    r = np.geomspace(rcut, 10.0 * rcut, 4001)
    vr = v(torch.from_numpy(r)).numpy()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return 2.0 * math.pi * density * trapezoid(vr * r * r, r)


def rung_cfg(Nb: int, dt: float, nstep: int, nblock: int,
             jastrow: str = "mcmillan_c1") -> SimConfig:
    """tools/tau_ladder.rung_cfg at W=256 (f2_validation's walker count)."""
    return SimConfig(
        dim=3, Np=64, density=0.365, trap=False,
        dt=dt, Nb=Nb, sampling="bis", Lstag=32, Nlev=4, Nstag=5,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=False, CWorm=0.0, Nobdm=0, Npw=0,
        n_walkers=W, dtype="float32", potential="aziz2", jastrow=jastrow,
        Nstep=nstep, Nblock=nblock, seed=1982 + Nb,
    )


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "build/f2_validation"
    Nb = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    nblocks = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    burnin = int(sys.argv[4]) if len(sys.argv) > 4 else 6
    nstep = int(sys.argv[5]) if len(sys.argv) > 5 else 50
    os.makedirs(outdir, exist_ok=True)
    device = _device()
    if device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        print(f"# {torch.cuda.get_device_name(0)} | {card}", flush=True)
    for exact in (False, True):
        cfg = rung_cfg(Nb, 5e-3, nstep, nblocks).replace(exact_f2=exact)
        rdir = os.path.join(outdir, f"exact{int(exact)}_Nb{Nb}")
        t0 = time.time()
        drv = Driver(cfg, out_dir=rdir, device=device, verbose=False)
        drv.run_burnin(burnin)
        drv.run(nblocks)
        dv = tail_correction(cfg.density, drv.system.geo.rcut)
        f = drv.final
        row = dict(exact_f2=exact, Nb=Nb, W=W, nstep=nstep, burnin=burnin,
                   nblocks=nblocks, E=f["E"], dE=f["VarE"], Et=f["Et"],
                   dEt=f["VarEt"],
                   E_K=(f["E"] + dv) * KELVIN, dE_K=f["VarE"] * KELVIN,
                   Et_K=(f["Et"] + dv) * KELVIN, dEt_K=f["VarEt"] * KELVIN,
                   V_K=f["V"] * KELVIN, K_K=f["K"] * KELVIN,
                   tail_K=dv * KELVIN, device=str(drv.system.device),
                   wall_s=round(time.time() - t0, 1))
        with open(os.path.join(outdir, "f2_validation.jsonl"), "a") as fh:
            fh.write(json.dumps(row) + "\n")
        print(f"exact_f2={exact}: E/N = {row['E_K']:+.3f}({row['dE_K']:.3f})"
              f" K   Et/N = {row['Et_K']:+.3f}({row['dEt_K']:.3f}) K"
              f"   [{nblocks} blocks of {nstep} steps after {burnin}, "
              f"{row['wall_s']} s]", flush=True)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
