"""Aziz-II (HFD-B(HE)) He-He potential in the engine's units: energies in
E0 / 1.85505153154686, lengths in sigma = 2.556 Angstrom, with the damped
dispersion's hard-core floor d >= 1e-3 (system_mod.f90:153-182).
Aziz, McCourt, Wong, Mol. Phys. 61, 1487 (1987)."""

import torch

E0, RM, A = 10.948, 2.963, 1.8443101e5
ALPHA, BETA = 10.43329537, -2.27965105
C6, C8, C10, D = 1.36745214, 0.42123807, 0.17473318, 1.4826
V0 = E0 / 1.85505153154686
S = 2.556 / RM
D_MIN = 1.0e-3


def v(r):
    d = torch.clamp(S * r, min=D_MIN)
    d2 = d * d
    rep = A * torch.exp(-ALPHA * d + BETA * d2)
    H = torch.where(d <= D, torch.exp(-torch.square(D / d - 1.0)), 1.0)
    W = C6 + C8 / d2 + C10 / (d2 * d2)
    return V0 * (rep - W * H / (d2 * d2 * d2))


def dvdr(r):
    d = torch.clamp(S * r, min=D_MIN)
    d2 = d * d
    rep = A * torch.exp(-ALPHA * d + BETA * d2)
    drep = rep * (-ALPHA + 2.0 * BETA * d)
    H = torch.where(d <= D, torch.exp(-torch.square(D / d - 1.0)), 1.0)
    dH = torch.where(d <= D, H * 2.0 * (D / d - 1.0) * D / d2, 0.0)
    W = C6 + C8 / d2 + C10 / (d2 * d2)
    dW = -2.0 * C8 / (d2 * d) - 4.0 * C10 / (d2 * d2 * d)
    d6 = d2 * d2 * d2
    dG = (dW * H + W * dH) / d6 - 6.0 * W * H / (d6 * d)
    return V0 * S * (drep - dG)
