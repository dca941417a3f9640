"""Pair potentials: the Aziz He-He forms (system_mod.f90:87-182), the soft
sphere (system_mod.f90:70-83), the 1/r^3 dipolar gas and the ideal gas,
elementwise on tensors.

The same closed forms as pathintegralgroundstate_tpu/models/potentials.py,
operation for operation: the D_MIN = 1e-3 hard-core floor and the fused
reciprocal-based (V, dV/dr) of the Aziz form.  aziz2 (HFD-B(HE)) and aziz1
(HFDHE2) share the form; only the constants differ.  The soft, dipolar and
ideal-gas v_dv take rinv and ignore it: they compute from r alone, as the
reference does for every potential but Aziz (pallas_kernels.py:87-90).

The CUDA kernels (csrc/pigs_pair.cuh) evaluate the same formulas, selected
by `Potential.kind` (KIND_AZIZ, KIND_SOFT, KIND_DIPOLAR, KIND_NONE), from
`Potential.consts`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .jastrow import ipow, rdiv

# Aziz II HFD-B(HE) parameters (system_mod.f90:153-163)
_AZIZ2 = dict(
    E0=10.948, rm=2.963, A=1.8443101e5, alpha=10.43329537, beta=-2.27965105,
    C6=1.36745214, C8=0.42123807, C10=0.17473318, D=1.4826,
)
# Aziz I HFDHE2 parameters (system_mod.f90:104-113)
_AZIZ1 = dict(
    E0=10.8, rm=2.9673, A=0.54485046e6, alpha=13.353384, beta=0.0,
    C6=1.3732412, C8=0.4253785, C10=0.1781, D=1.241314,
)
_UNIT_DENOM = 1.85505153154686  # system_mod.f90:163
_SIGMA = 2.556                  # Angstrom; system_mod.f90:169
D_MIN = 1.0e-3                  # hard-core floor of the damped dispersion
SOFT_V0 = 22.0228               # soft sphere (potentials.py:102)
CDD = 1.0                       # dipolar strength (potentials.py:115)

# enum PotKind in csrc/pigs_pair.cuh
KIND_AZIZ, KIND_SOFT, KIND_DIPOLAR, KIND_NONE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Potential:
    name: str
    v: Callable      # V(r)
    dvdr: Callable   # dV/dr(r), analytic
    v_dv: Callable   # fused (V, dV/dr)(r, rinv=None)
    consts: dict     # the closed form's constants (kernel parameters)
    kind: int        # the kernels' pair-model selector (KIND_*)


def _aziz(name, p) -> Potential:
    V0 = p["E0"] / _UNIT_DENOM
    s = _SIGMA / p["rm"]
    A, alpha, beta = p["A"], p["alpha"], p["beta"]
    C6, C8, C10, D = p["C6"], p["C8"], p["C10"], p["D"]
    s_inv = 1.0 / s

    def v(r):
        d = torch.clamp(s * r, min=D_MIN)
        d2 = d * d
        rep = A * torch.exp(-alpha * d + beta * d2)
        H = torch.where(d <= D, torch.exp(-torch.square(D / d - 1.0)), 1.0)
        W = C6 + C8 / d2 + C10 / (d2 * d2)
        return V0 * (rep - W * H / (d2 * d2 * d2))

    def dvdr(r):
        d = torch.clamp(s * r, min=D_MIN)
        d2 = d * d
        rep = A * torch.exp(-alpha * d + beta * d2)
        drep = rep * (-alpha + 2.0 * beta * d)
        H = torch.where(d <= D, torch.exp(-torch.square(D / d - 1.0)), 1.0)
        dH = torch.where(d <= D, H * 2.0 * (D / d - 1.0) * D / d2, 0.0)
        W = C6 + C8 / d2 + C10 / (d2 * d2)
        dW = -2.0 * C8 / (d2 * d) - 4.0 * C10 / (d2 * d2 * d)
        d6 = d2 * d2 * d2
        dG = (dW * H + W * dH) / d6 - 6.0 * W * H / (d6 * d)
        return V0 * s * (drep - dG)

    def v_dv(r, rinv=None):
        if rinv is None:
            rinv = 1.0 / r
        d = torch.clamp(s * r, min=D_MIN)
        di = torch.clamp(s_inv * rinv, max=1.0 / D_MIN)
        d2i = di * di
        rep = A * torch.exp(-alpha * d + beta * (d * d))
        t = D * di - 1.0
        core = d <= D
        H = torch.where(core, torch.exp(-t * t), 1.0)
        dH = torch.where(core, H * 2.0 * t * D * d2i, 0.0)
        W = C6 + d2i * (C8 + C10 * d2i)
        dW = -d2i * di * (2.0 * C8 + 4.0 * C10 * d2i)
        d6i = d2i * d2i * d2i
        WH6 = W * H * d6i
        val = V0 * (rep - WH6)
        drep = rep * (-alpha + 2.0 * beta * d)
        dG = (dW * H + W * dH) * d6i - 6.0 * WH6 * di
        return val, V0 * s * (drep - dG)

    consts = dict(V0=V0, V0s=V0 * s, s=s, s_inv=s_inv, A=A, neg_alpha=-alpha,
                  beta=beta, two_beta=2.0 * beta, C6=C6, C8=C8, C10=C10,
                  Dcore=D, d_min=D_MIN, d_min_inv=1.0 / D_MIN,
                  two_C8=2.0 * C8, four_C10=4.0 * C10)
    return Potential(name, v, dvdr, v_dv, consts, KIND_AZIZ)


def _soft(V0=SOFT_V0) -> Potential:
    """V0 (1/r^6 - 1) / r^6 (potentials.py:102-110)."""
    def v(r):
        r6 = ipow(r, 6)
        return V0 * (rdiv(1.0, r6) - 1.0) / r6

    def dvdr(r):
        return V0 * (rdiv(-12.0, ipow(r, 13)) + rdiv(6.0, ipow(r, 7)))

    return Potential("soft", v, dvdr, lambda r, rinv=None: (v(r), dvdr(r)),
                     dict(soft_V0=V0), KIND_SOFT)


def _dipolar(Cdd=CDD) -> Potential:
    """Cdd / r^3 (potentials.py:113-120)."""
    def v(r):
        return rdiv(Cdd, ipow(r, 3))

    def dvdr(r):
        return rdiv(-3.0 * Cdd, ipow(r, 4))

    return Potential("dipolar", v, dvdr,
                     lambda r, rinv=None: (v(r), dvdr(r)), dict(Cdd=Cdd),
                     KIND_DIPOLAR)


def _none() -> Potential:
    """The ideal gas, V = dV/dr = 0 (potentials.py:124-126)."""
    def z(r):
        return torch.zeros_like(r)

    return Potential("none", z, z, lambda r, rinv=None: (z(r), z(r)), {},
                     KIND_NONE)


_REGISTRY = {"aziz2": lambda: _aziz("aziz2", _AZIZ2),
             "aziz1": lambda: _aziz("aziz1", _AZIZ1),
             "soft": _soft, "dipolar": _dipolar, "none": _none}


def get_potential(name: str) -> Potential:
    """aziz2, aziz1, soft, dipolar or none (potentials.py:139-150)."""
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown potential {name!r}; known: "
                       f"{sorted(_REGISTRY)}") from None
