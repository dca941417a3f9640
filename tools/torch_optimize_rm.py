"""Gradient-based trial-wavefunction optimization over Rm on the PyTorch
port.

The torch counterpart of tools/optimize_rm.py, with its configuration, its
schedule and its JSON lines, through the port's ops/variational: Adam on
the McMillan parameter Rm of psi_T = exp(sum u(r; Rm)) for He-4 at the
flagship density, descending the variational energy E_V(Rm) =
<E_L>_{|psi_Rm|^2} (the tau -> 0 limit of the PIGS mixed estimator) with
dE/dRm from torch.autograd through the reweighted batch estimator
(variational.vmc_energy); the walkers are slices sampled from |psi_Rm|^2
by variational.vmc_sweep.  The JAX tool's record: Rm 1.05 -> 1.208(5)
(McMillan 1965: Rm ~ 1.2 sigma at rho = 0.365 sigma^-3).  One JSON line per
iteration and a summary line; with PIGS_RM_SCAN=1 also a fresh-sampled
E(Rm) grid.  It imports nothing of JAX and runs on the card, or on the CPU
with PIGS_PLATFORM=cpu.

Usage: python3 tools/torch_optimize_rm.py [Np] [nsteps] [W]
(defaults 16, 40, 256, as tools/optimize_rm.py).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.config import SimConfig  # noqa: E402
from pathintegralgroundstate_torch.ops import variational as var  # noqa: E402
from pathintegralgroundstate_torch.state import init_state  # noqa: E402
from pathintegralgroundstate_torch.system import make_system  # noqa: E402
from tools.torch_card import card_line  # noqa: E402


def main():
    Np = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    niter = int(sys.argv[2]) if len(sys.argv) > 2 else 40
    W = int(sys.argv[3]) if len(sys.argv) > 3 else 256
    cfg = SimConfig(dim=3, Np=Np, density=0.365, dt=5e-3, Nb=4,
                    sampling="sta", Lstag=4, Nstag=1, n_walkers=W,
                    dtype="float64", potential="aziz2",
                    jastrow="mcmillan_c1", seed=7)
    system = make_system(cfg, _device())
    if system.device.type == "cuda":
        print(f"# {torch.cuda.get_device_name(0)} | {card_line()}",
              flush=True)
    st = init_state(system)
    Rs = st.paths[:, 0].clone()               # [W, N, D] slice ensemble
    gen = torch.Generator(device=system.device)
    gen.manual_seed(11)
    kw = dict(dtype=system.dtype, device=system.device)

    def sweep(g, Rs, rm):
        return var.vmc_sweep(system, g, Rs, torch.tensor(rm, **kw), 0.35,
                             nsweeps=10)

    def e_and_g(rm, Rs):
        rm_t = torch.tensor(rm, **kw, requires_grad=True)
        E = var.vmc_energy(system, Rs, rm_t)
        (g,) = torch.autograd.grad(E, rm_t)
        return float(E.detach()), float(g)

    # burn-in from the uniform placement
    Rm = 1.05  # start deliberately off-optimum
    for _ in range(12):
        Rs, acc = sweep(gen, Rs, Rm)

    # Adam on Rm
    m = v = 0.0
    lr, b1, b2, eps = 0.02, 0.9, 0.999, 1e-8
    hist = []
    for it in range(1, niter + 1):
        Rs, acc = sweep(gen, Rs, Rm)
        E, g = e_and_g(Rm, Rs)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** it)
        vh = v / (1 - b2 ** it)
        Rm = float(np.clip(Rm - lr * mh / (np.sqrt(vh) + eps), 0.8, 1.8))
        rec = dict(iter=it, Rm=round(Rm, 5), E_per_N=round(E / Np, 5),
                   dE_dRm_per_N=round(g / Np, 4), acc=round(float(acc), 3))
        hist.append(rec)
        print(json.dumps(rec), flush=True)

    tail = hist[-10:]
    Rm_mean = float(np.mean([h["Rm"] for h in tail]))
    g_mean = float(np.mean([h["dE_dRm_per_N"] for h in tail]))
    print(json.dumps(dict(
        summary=True, Np=Np, W=W, Rm_opt=round(Rm_mean, 4),
        Rm_opt_std=round(float(np.std([h["Rm"] for h in tail])), 4),
        dE_dRm_per_N_at_opt=round(g_mean, 4),
        E_per_N_at_opt=round(float(np.mean([h["E_per_N"] for h in tail])), 4),
        literature="Rm ~ 1.2 sigma (McMillan form, rho=0.365)",
        device=str(system.device))), flush=True)

    # independent check: a fresh-sampled E(Rm) grid (no reweighting, the
    # same seed stream per point) bracketing the optimum
    if os.environ.get("PIGS_RM_SCAN", "") not in ("", "0"):
        for rm in (1.00, 1.10, 1.15, 1.20, 1.25, 1.35):
            g2 = torch.Generator(device=system.device)
            g2.manual_seed(99)
            Rs2, _ = sweep(g2, st.paths[:, 0].clone(), rm)
            for _ in range(15):
                Rs2, _ = sweep(g2, Rs2, rm)
            es = []
            for _ in range(12):
                Rs2, _ = sweep(g2, Rs2, rm)
                es.append(float(var.vmc_energy(
                    system, Rs2, torch.tensor(rm, **kw))) / Np)
            print(json.dumps(dict(scan_Rm=rm,
                                  E_per_N=round(float(np.mean(es)), 4),
                                  err=round(float(np.std(es))
                                            / np.sqrt(len(es)), 4))),
                  flush=True)


if __name__ == "__main__":
    main()
