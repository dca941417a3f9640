"""Trapped worm flagship on the PyTorch port: trap + worm + swaps + density
map end to end, against exact answers.

The torch counterpart of tools/trap_worm.py, with the same configuration,
the same fits and the same JSON line, through the port's Driver.  System:
N = 8 ideal bosons in an isotropic 2-D trap (a = 1, potential and Jastrow
'none', the trap's trial WF the exact ground state), worm sector on.  At
T = 0 every particle sits in phi_0(r) ~ exp(-r^2 / 2 a^2), so

  * the end-to-end separation histogram of the open worm (AvNr, already
    shell-normalised by the Driver) is exp(-s^2 / (4 a^2)): sigma^2 = 4 a^2;
  * the density map's radial profile is exp(-r^2 / a^2): sigma^2 = a^2
    (the coarse cells add about 3 %);
  * the mixed energy is E/N = d/2 = 1 exactly.

It runs on the card, or on the CPU with PIGS_PLATFORM=cpu (as the CLI
does); it imports nothing of JAX.

Usage: python3 tools/torch_trap_worm.py [nblocks] [out_dir]
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pathintegralgroundstate_torch.cli import _device  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.flagship import trap_worm_cfg  # noqa: E402
from tools.torch_card import card_line  # noqa: E402


def gauss_width(r, y):
    """Least-squares sigma^2 of y ~ exp(-r^2/sigma2) on the populated bins."""
    m = y > 1e-3 * y.max()
    p = np.polyfit(r[m] ** 2, np.log(y[m]), 1)
    return -1.0 / p[0]


def fits(cfg, geo, acc):
    """(sigma^2 of the end-to-end histogram, sigma^2 of the density map's
    radial profile), as tools/trap_worm.py fits them."""
    a = cfg.a_ho[0]
    r = (np.arange(1, cfg.Nbin + 1) - 0.5) * geo.rbin
    sig2_obdm = gauss_width(r, np.maximum(acc["AvNr"][0], 1e-300))
    nb = cfg.Nbin
    xv = -0.5 * geo.rcut + (np.arange(nb) + 1) * geo.rbin
    X, Y = np.meshgrid(xv, xv, indexing="ij")
    rr = np.sqrt(X ** 2 + Y ** 2).ravel()
    dd = acc["AvDens"].ravel()
    bins = np.linspace(0, 3.0 * a, 25)
    prof = np.array([dd[(rr >= b0) & (rr < b1)].mean() if
                     ((rr >= b0) & (rr < b1)).any() else 0.0
                     for b0, b1 in zip(bins[:-1], bins[1:])])
    rc = 0.5 * (bins[:-1] + bins[1:])
    return sig2_obdm, gauss_width(rc, np.maximum(prof, 1e-300))


def main():
    nblocks = int(sys.argv[1]) if len(sys.argv) > 1 else 30
    out = sys.argv[2] if len(sys.argv) > 2 else tempfile.mkdtemp()
    cfg = trap_worm_cfg(nblocks)
    device = _device()
    drv = Driver(cfg, out_dir=out, device=device, verbose=False)
    if drv.system.device.type == "cuda":
        print(f"# {torch.cuda.get_device_name(0)} | {card_line()}")
    drv.run_burnin(8)
    acc = drv.run()
    sig2_obdm, sig2_dens = fits(cfg, drv.system.geo, acc)
    a = cfg.a_ho[0]
    with open(os.path.join(out, "metrics.jsonl")) as f:
        fr = [json.loads(ln)["diag_frac"] for ln in f]
    print(json.dumps(dict(
        Np=cfg.Np, Nb=cfg.Nb, tau=cfg.Nb * cfg.dt, nblocks=nblocks,
        diag_frac=round(float(np.mean(fr)), 4),
        sigma2_obdm=round(float(sig2_obdm), 4), expect_obdm=4.0 * a * a,
        sigma2_density=round(float(sig2_dens), 4), expect_density=a * a,
        E_per_N=round(acc["AvE"] / max(acc["diag_bl"], 1) / cfg.Np, 5),
        expect_E_per_N=cfg.dim / 2.0, device=str(drv.system.device),
        out_dir=out)))


if __name__ == "__main__":
    main()
