"""The plain reference's physics: geometry, the minimum image, the Chin
weights and the pair model, in plain PyTorch at any floating type.

Frozen copies of the formulas the engine states (the reference Fortran
code's vpi.f90, vpi_mod.f90, system_mod.f90 and global_mod.f90, as the
PIGS/VPI papers write them), kept here so that the benchmark's yardstick
never changes with the program it measures.  Nothing here imports the
program.  The pair model of a configuration is two small files found by
name: `pair/<potential>.py` (V and dV/dr) and `jastrow/<jastrow>.py`
(u, u', u'' and whether u is C1-matched at the cutoff under PBC).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace

import torch

HERE = Path(__file__).resolve().parent


def geometry(cfg: dict) -> SimpleNamespace:
    """The periodic box of a configuration (vpi.f90:80-128): L from N and
    the density, rcut = L/2, the histogram bins and the CM step scaled by
    the mean spacing."""
    d, n, rho = cfg["dim"], cfg["Np"], cfg["density"]
    L = (n / rho) ** (1.0 / d)
    rcut = 0.5 * L
    return SimpleNamespace(
        L=L, rcut=rcut, rcut2=rcut * rcut, rbin=rcut / cfg["Nbin"],
        qbin=2.0 * math.pi / L, delta_cm=cfg["delta_cm"] / rho ** (1.0 / d))


def wrap(x, L: float):
    """One periodic image: coordinates or displacements into [-L/2, L/2]."""
    x = torch.where(x > 0.5 * L, x - L, x)
    return torch.where(x < -0.5 * L, x + L, x)


def chin_weights(M: int, dt: float, dtype, device):
    """Per-bead Chin weights [3, M] (global_mod.f90:33-46): wv (ends dt/3,
    even interior 2dt/3, odd interior 4dt/3), wf (odd interior 2dt^3/9,
    else 0) and wpsi (1 at the two chain ends)."""
    wv, wf, wpsi = [], [], []
    for b in range(M):
        end = b in (0, M - 1)
        odd = not end and b % 2 == 1
        wv.append(dt / 3.0 if end else (4.0 * dt / 3.0 if odd
                                        else 2.0 * dt / 3.0))
        wf.append(2.0 * dt ** 3 / 9.0 if odd else 0.0)
        wpsi.append(1.0 if end else 0.0)
    return torch.tensor([wv, wf, wpsi], dtype=dtype, device=device)


def _load(folder: str, name: str):
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"the reference has no {folder} model {name!r} "
                       f"({path} is missing)")
    spec = importlib.util.spec_from_file_location(
        f"pigsbench.reference.{folder}.{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class PairModel:
    """V, dV/dr, u, u', u'' of one configuration, with the C1 shift of u
    and u' at rcut (u - u(rc) - u'(rc)(r - rc)) where the Jastrow asks
    for it.  Every function is elementwise on tensors of any type."""

    def __init__(self, cfg: dict):
        geo = geometry(cfg)
        self.pot = _load("pair", cfg["potential"])
        self.jas = _load("jastrow", cfg["jastrow"])
        self.Rm, self.rc = cfg["Rm"], geo.rcut
        self.c1 = bool(self.jas.C1_AT_CUTOFF)
        self.u_rc = self.jas.u(self.Rm, self.rc) if self.c1 else 0.0
        self.du_rc = self.jas.du(self.Rm, self.rc) if self.c1 else 0.0

    def v(self, r):
        return self.pot.v(r)

    def dv(self, r):
        return self.pot.dvdr(r)

    def u(self, r):
        u = self.jas.u(self.Rm, r)
        return u - self.u_rc - self.du_rc * (r - self.rc) if self.c1 else u

    def du(self, r):
        du = self.jas.du(self.Rm, r)
        return du - self.du_rc if self.c1 else du

    def d2u(self, r):
        return self.jas.d2u(self.Rm, r)
