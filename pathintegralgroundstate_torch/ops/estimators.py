"""Estimators: mixed and thermodynamic energy, g(r), S(k) and the density
map (sample_mod.f90).

The torch counterpart of pathintegralgroundstate_tpu/ops/estimators.py, in
both geometries.  Every function takes the whole ensemble (a leading
walker axis) where the reference vmaps a single walker; the histograms
are index_add_ sums where the reference contracts one-hot tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import jastrow as jas
from ..utils.pbc import all_pairs, separation
from .pairwise import pair_pot


def local_energy(system, R):
    """Mixed estimator at a terminal slice (LocalEnergy,
    sample_mod.f90:154-319): E_L = -1/2 [2 LapLogPsi + |F|^2] + V, with the
    trap's one-body terms under the trap, where only the trap part of the
    Laplacian is halved, as the reference has it (estimators.py:70-75).
    R [W, N, D]; returns (E, Kin, Pot), each [W]."""
    d = system.cfg.dim
    a = system.a_ho
    m, r, xij = all_pairs(system, R)
    dudr = torch.where(m, system.du(r), 0.0)
    d2u = torch.where(m, system.d2u(r), 0.0)
    lap = 0.5 * ((d - 1.0) * dudr / r + d2u).sum((-1, -2))
    pot = 0.5 * torch.where(m, system.v(r), 0.0).sum((-1, -2))
    F = ((dudr / r)[..., None] * xij).sum(-2)
    if a is not None:
        F = F + jas.trap_psi_grad(a, R)
        pot = pot + jas.trap_pot(a, R).sum(-1)
        lap = lap + 0.5 * jas.trap_psi_lap(a, R).sum(-1)
    kin = -0.5 * (2.0 * lap + (F * F).sum((-1, -2)))
    return kin + pot, kin, pot


def therm_energy(system, paths):
    """Thermodynamic estimator over all links (ThermEnergy,
    sample_mod.f90:323-388), its pair sums on kernel B: even beads
    0..2Nb-2 need V, odd beads 1..2Nb-1 V and F^2.  paths [W, M, N, D];
    returns (E, E - Ep, Ep) with Ep the central-bead potential, each [W]."""
    cfg = system.cfg
    Nb, dt, M = cfg.Nb, cfg.dt, system.M
    pot_even, _ = pair_pot(system, paths[:, 0:M - 1:2], False)
    pot_odd, f2_odd = pair_pot(system, paths[:, 1:M - 1:2], True)
    w_even = system.const(("therm_w_even", paths.dtype),
                          lambda: np.r_[1.0 / 3.0, np.full(Nb - 1, 2.0 / 3.0)],
                          paths.dtype)
    E = (w_even * pot_even).sum(-1)
    E = E + (4.0 / 3.0 * (pot_odd + 0.5 * dt * dt * f2_odd)).sum(-1)
    Ep = pot_even[:, Nb // 2] if Nb % 2 == 0 else pot_odd[:, Nb // 2]
    # the spring per link: rcut-gated under PBC (sample_mod.f90:377), the
    # whole r^2 under the trap
    _, rij2 = separation(system, paths[:, :-1] - paths[:, 1:])
    spring = (torch.where(rij2 <= system.geo.rcut2, rij2, 0.0) if system.pbc
              else rij2)
    E = E - 0.5 * spring.sum((-1, -2)) / (dt * dt)
    E = 0.5 * (E / Nb + cfg.dim * cfg.Np / dt)
    return E, E - Ep, Ep


def pair_correlation(system, R, weight):
    """g(r) histogram (PairCorrelation, sample_mod.f90:392-431): weight 2
    per pair within rcut (the full N x N matrix), walker w's pairs
    scaled by weight[w].  R [W, N, D]; returns gr[Nbin], summed in
    system.stat_dtype."""
    cfg = system.cfg
    m, r, _ = all_pairs(system, R)
    ibin = torch.clamp((r / system.geo.rbin).long(), 0, cfg.Nbin - 1)
    w = m.to(R.dtype) * weight[:, None, None]
    acc = system.stat_dtype
    return torch.zeros(cfg.Nbin, dtype=acc, device=R.device).index_add_(
        0, ibin.flatten(), w.flatten().to(acc))


def structure_factor(system, Nk: int, R):
    """S(k) along each axis at multiples of 2 pi / L (StructureFactor,
    sample_mod.f90:435-476).  R [W, N, D]; returns [W, D, Nk]."""
    qbin = system.const(("qbin", R.dtype), lambda: system.geo.qbin, R.dtype)
    q = qbin[:, None] * torch.arange(1, Nk + 1, dtype=R.dtype,
                                     device=R.device)[None, :]
    qr = q[None, :, :, None] * R.transpose(1, 2)[:, :, None, :]
    sc = torch.cos(qr).sum(-1)
    ss = torch.sin(qr).sum(-1)
    return sc * sc + ss * ss


def density_map(system, R, weight):
    """2-D density map (DensityProfile, sample_mod.f90:598-629;
    estimators.py:172-195): each walker's particles histogrammed in (x, y)
    on an Nbin x Nbin grid over [-rcut/2, rcut/2)^2 with the reference's
    bin rule ibin = floor((x + rcut/2)/rbin), a particle outside the grid
    dropped; walker w's particles weighted weight[w].  A 1-D system
    histograms x against the single row of y = 0.  R [W, N, D]; returns
    dens [Nbin, Nbin], dens[i, j] the weight in x-bin i, y-bin j."""
    geo, nb = system.geo, system.cfg.Nbin
    x = R[..., 0]
    y = R[..., 1] if system.cfg.dim >= 2 else torch.zeros_like(x)
    ix = torch.floor((x + 0.5 * geo.rcut) / geo.rbin).long()
    iy = torch.floor((y + 0.5 * geo.rcut) / geo.rbin).long()
    ok = (ix >= 0) & (ix < nb) & (iy >= 0) & (iy < nb)
    idx = torch.where(ok, ix * nb + iy, 0)
    w = torch.where(ok, weight[:, None], 0.0)
    acc = system.stat_dtype
    return torch.zeros(nb * nb, dtype=acc, device=R.device).index_add_(
        0, idx.flatten(), w.flatten().to(acc)).view(nb, nb)
