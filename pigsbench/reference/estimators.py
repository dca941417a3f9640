"""The plain reference of one measurement of the estimators (sample_mod.f90:
LocalEnergy, PotentialEnergy, ThermEnergy, PairCorrelation,
StructureFactor), summed over the diagonal walkers as one step adds them
to the block's statistics.

  mixed energy   E_L = -1/2 [2 LapLogPsi + |grad LogPsi|^2] + V at both
                 chain ends, averaged; Kin = E_L - Ep;
  thermodynamic  the Chin-action estimator over all links: the pair
                 potential at every bead (weights 1/3 and 2/3 on even
                 beads, 4/3 with the dt^2/2 |F|^2 term on odd ones), the
                 spring r^2 / dt^2 of every link within rcut, and
                 dim N / dt; Ep the potential at the central bead;
  g(r), S(k)     at the central bead: pair counts per bin of rcut/Nbin
                 (each ordered pair once) and |sum exp(i q x)|^2 along each
                 axis at q = 2 pi k / L, k = 1..Nk.

The sums come back as float64 numbers, with the matching sums of absolute
values (the scale each difference is measured against)."""

from __future__ import annotations

import torch

from .physics import PairModel, geometry, wrap

# pair elements [walkers, beads, N, N] of one block of walkers
BLOCK_PAIRS = 1 << 24

ENERGY = ("n_diag", "sumE", "sumK", "sumV", "sumE2", "sumK2", "sumV2")
THERM = ("sumEt", "sumKt", "sumVt", "sumEt2", "sumKt2", "sumVt2")
STRUCTURE = ("ngr", "gr", "sk")


def _pairs(geo, R):
    """(mask of interacting ordered pairs, r with 1 on the diagonal,
    separations x_i - x_j) of configurations R [..., N, D]."""
    N = R.shape[-2]
    xij = wrap(R[..., :, None, :] - R[..., None, :, :], geo.L)
    r2 = (xij * xij).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=R.device)
    m = ~eye & (r2 <= geo.rcut2)
    r = torch.sqrt(torch.where(eye, torch.ones_like(r2), r2))
    return m, r, xij


def local_energy(model, geo, R):
    """(E, Kin, Pot) [w] of the configurations R [w, N, D]."""
    d = R.shape[-1]
    m, r, xij = _pairs(geo, R)
    zero = torch.zeros_like(r)
    du = torch.where(m, model.du(r), zero)
    d2u = torch.where(m, model.d2u(r), zero)
    lap = 0.5 * ((d - 1.0) * du / r + d2u).sum((-1, -2))
    pot = 0.5 * torch.where(m, model.v(r), zero).sum((-1, -2))
    F = ((du / r)[..., None] * xij).sum(-2)
    kin = -0.5 * (2.0 * lap + (F * F).sum((-1, -2)))
    return kin + pot, kin, pot


def pair_pot(model, geo, R, with_force):
    """(pot, |F|^2) [...] of configurations R [..., N, D]."""
    m, r, xij = _pairs(geo, R)
    zero = torch.zeros_like(r)
    pot = 0.5 * torch.where(m, model.v(r), zero).sum((-1, -2))
    if not with_force:
        return pot, None
    F = (torch.where(m, model.dv(r) / r, zero)[..., None] * xij).sum(-2)
    return pot, (F * F).sum((-1, -2))


def therm_energy(cfg, model, geo, paths):
    """(Et, Kt, Ep) [w] of the paths [w, M, N, D]."""
    Nb, dt, M = cfg["Nb"], cfg["dt"], paths.shape[1]
    pot_even, _ = pair_pot(model, geo, paths[:, 0:M - 1:2], False)
    pot_odd, f2_odd = pair_pot(model, geo, paths[:, 1:M - 1:2], True)
    w_even = torch.full((Nb,), 2.0 / 3.0, dtype=paths.dtype,
                        device=paths.device)
    w_even[0] = 1.0 / 3.0
    E = (w_even * pot_even).sum(-1)
    E = E + (4.0 / 3.0 * (pot_odd + 0.5 * dt * dt * f2_odd)).sum(-1)
    Ep = pot_even[:, Nb // 2] if Nb % 2 == 0 else pot_odd[:, Nb // 2]
    link = wrap(paths[:, :-1] - paths[:, 1:], geo.L)
    r2 = (link * link).sum(-1)
    spring = torch.where(r2 <= geo.rcut2, r2, torch.zeros_like(r2))
    E = E - 0.5 * spring.sum((-1, -2)) / (dt * dt)
    E = 0.5 * (E / Nb + cfg["dim"] * cfg["Np"] / dt)
    return E, E - Ep, Ep


def _structure(cfg, geo, R, fdiag):
    """(g(r) histogram [Nbin], S(k) summed [D, Nk]) of the central slices
    R [w, N, D], walker w weighted fdiag[w]."""
    m, r, _ = _pairs(geo, R)
    ibin = torch.clamp((r / geo.rbin).long(), 0, cfg["Nbin"] - 1)
    wgt = m.to(R.dtype) * fdiag[:, None, None]
    gr = torch.zeros(cfg["Nbin"], dtype=R.dtype, device=R.device)
    gr.index_add_(0, ibin.flatten(), wgt.flatten())
    k = torch.arange(1, cfg["Nk"] + 1, dtype=R.dtype, device=R.device)
    qr = geo.qbin * k[None, None, :, None] * R.transpose(1, 2)[:, :, None, :]
    sk = torch.cos(qr).sum(-1) ** 2 + torch.sin(qr).sum(-1) ** 2
    return gr, (sk * fdiag[:, None, None]).sum(0)


def measure(cfg: dict, paths, isopen, dtype):
    """The statistics one measurement adds, over all walkers of paths
    [W, M, N, D] (the program's positions) with the diagonal mask ~isopen:
    ({field: float64 tensor}, {field: float64 scale}), the arithmetic in
    `dtype`, in blocks of walkers."""
    geo = geometry(cfg)
    model = PairModel(cfg)
    W, M, N, _ = paths.shape
    step = max(1, BLOCK_PAIRS // (M * N * N))
    out = {k: 0.0 for k in ENERGY + THERM + STRUCTURE}
    scale = dict(out)
    for lo in range(0, W, step):
        P = paths[lo:lo + step].to(dtype)
        fd = (~isopen[lo:lo + step]).to(dtype)
        E1, _, _ = local_energy(model, geo, P[:, 0])
        E2, _, _ = local_energy(model, geo, P[:, -1])
        E = 0.5 * (E1 + E2)
        Et, Kt, Ep = therm_energy(cfg, model, geo, P)
        K = E - Ep
        terms = {"sumE": E, "sumK": K, "sumV": Ep, "sumE2": E * E,
                 "sumK2": K * K, "sumV2": Ep * Ep, "sumEt": Et, "sumKt": Kt,
                 "sumVt": Ep, "sumEt2": Et * Et, "sumKt2": Kt * Kt,
                 "sumVt2": Ep * Ep}
        for k, x in terms.items():
            out[k] = out[k] + (x * fd).double().sum()
            scale[k] = scale[k] + (x * fd).double().abs().sum()
        nd = fd.double().sum()
        for k in ("n_diag", "ngr"):
            out[k] = out[k] + nd
            scale[k] = scale[k] + nd
        gr, sk = _structure(cfg, geo, P[:, cfg["Nb"]], fd)
        out["gr"] = out["gr"] + gr.double()
        scale["gr"] = scale["gr"] + gr.double().abs().sum()
        out["sk"] = out["sk"] + sk.double()
        scale["sk"] = scale["sk"] + sk.double().abs().sum()
    return out, scale


def obdm(cfg: dict, rounds, act, dtype):
    """The OBDM histogram that one step's worm rounds add (sample_mod.f90:
    480-526): for each round's open ends xend [W, 2, D], the walkers act
    [W] whose worm is open add cos(2 m theta) (m = 0..Npw) at the bin of
    their ends' separation, where it lies within rcut.  Returns (nrho
    [Npw+1, Nbin] float64, the sum of the absolute terms)."""
    geo = geometry(cfg)
    m = torch.arange(cfg["Npw"] + 1, dtype=dtype, device=act.device)
    out = torch.zeros(cfg["Npw"] + 1, cfg["Nbin"], dtype=torch.float64,
                      device=act.device)
    scale = 0.0
    for x in rounds:
        x = x.to(act.device, dtype)
        xij = wrap(x[:, 0] - x[:, 1], geo.L)
        r2 = (xij * xij).sum(-1)
        r = torch.sqrt(torch.clamp(r2, min=1e-30))
        ibin = torch.clamp((r / geo.rbin).long(), 0, cfg["Nbin"] - 1)
        if cfg["dim"] >= 2:
            theta = torch.atan2(xij[:, 1], xij[:, 0])
        else:
            theta = torch.where(xij[:, 0] >= 0, 0.0, torch.pi).to(dtype)
        w = torch.cos(2.0 * theta[:, None] * m[None, :]) \
            * (act & (r2 <= geo.rcut2))[:, None].to(dtype)
        out.index_add_(1, ibin, w.T.double())
        scale += float(w.double().abs().sum())
    return out, scale
