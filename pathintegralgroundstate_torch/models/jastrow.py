"""Trial wave functions: the McMillan two-body Jastrow (system_mod.f90:38-66),
the 2-D dipolar two-body Jastrow (jastrow.py:47-58) and the harmonic trap's
one-body terms (TrapPsi / TrapPot,
system_mod.f90:213-252), elementwise on tensors.

The reference's sign conventions: du returns +2.5 (Rm/r)^5 / r; trap_psi_grad
returns -(x/a^2), the derivative of -x^2/(2 a^2).  The trap functions take
x [..., D] and the trap lengths a [D] (System.a_ho) and sum over the last
axis where the reference does, operation for operation.
"""

from __future__ import annotations

import math

import torch


def ipow(x, n: int):
    """x ** n for an integer n >= 1 as the reference computes it: on a
    tensor by lax.integer_pow's square-and-multiply chain (x^5 = x (x^2)^2,
    x^6 = x^2 (x^2)^2, ...), whose products round as the reference's do,
    where torch's pow rounds once; on a float, Python's **."""
    if not isinstance(x, torch.Tensor):
        return x ** n
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def rdiv(a, x):
    """a / x rounded once, as the reference divides: torch evaluates a
    float over a tensor as a * (1 / x), two roundings."""
    if isinstance(x, torch.Tensor) and not isinstance(a, torch.Tensor):
        return torch.div(x.new_full((), a), x)
    return a / x


def mcmillan_u(Rm, r):
    """log-Jastrow u(r) (opt=0)."""
    return -0.5 * ipow(rdiv(Rm, r), 5)


def mcmillan_du(Rm, r):
    """u'(r) (opt=1)."""
    return 2.5 * ipow(rdiv(Rm, r), 5) / r


def mcmillan_d2u(Rm, r):
    """u''(r) (opt=2)."""
    return -15.0 * ipow(rdiv(Rm, r), 5) / ipow(r, 2)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def dipolar_u(r0, r):
    """The zero-energy 1/r^3 two-body solution in 2-D, u = -2 sqrt(r0/r):
    with r0 = Rm = Cdd, |u'|^2 = Rm/r^3 cancels the dipolar core in the
    local energy.  r: a tensor, or a float (the C1 shift's constants)."""
    return -2.0 * _sqrt(rdiv(r0, r))


def dipolar_du(r0, r):
    return _sqrt(rdiv(r0, r)) / r


def dipolar_d2u(r0, r):
    return -1.5 * _sqrt(rdiv(r0, r)) / ipow(r, 2)


# (u, u', u'') of each two-body family
FAMILIES = {"mcmillan": (mcmillan_u, mcmillan_du, mcmillan_d2u),
             "mcmillan_c1": (mcmillan_u, mcmillan_du, mcmillan_d2u),
             "dipolar2d": (dipolar_u, dipolar_du, dipolar_d2u)}


def c1_shifted(jastrow: str, pbc: bool) -> bool:
    """Whether u and u' are C1-matched at rcut: mcmillan_c1 (system.py:93,
    108) and dipolar2d (system.py:89-91, 104-106), under PBC only."""
    return pbc and jastrow in ("mcmillan_c1", "dipolar2d")


def two_body_u(jastrow: str, Rm, r, rc: float, pbc: bool):
    """The two-body log-Jastrow u(r) of the family `jastrow` (mcmillan,
    mcmillan_c1, dipolar2d or none: u = 0), C1-shifted at rc where
    c1_shifted: u - u(rc) - u'(rc) (r - rc) (system.py:67-101)."""
    if jastrow == "none":
        return torch.zeros_like(r)
    u0, du0, _ = FAMILIES[jastrow]
    u = u0(Rm, r)
    if c1_shifted(jastrow, pbc):
        u = u - u0(Rm, rc) - du0(Rm, rc) * (r - rc)
    return u


def two_body_du(jastrow: str, Rm, r, rc: float, pbc: bool):
    """u'(r), shifted by u'(rc) where c1_shifted."""
    if jastrow == "none":
        return torch.zeros_like(r)
    du0 = FAMILIES[jastrow][1]
    du = du0(Rm, r)
    if c1_shifted(jastrow, pbc):
        du = du - du0(Rm, rc)
    return du


def two_body_d2u(jastrow: str, Rm, r):
    """u''(r), never shifted."""
    if jastrow == "none":
        return torch.zeros_like(r)
    return FAMILIES[jastrow][2](Rm, r)


def trap_psi(a, x):
    """One-body log trial WF summed over dims: -1/2 (x/a)^2 (opt=0)."""
    return -0.5 * ((x / a) ** 2).sum(-1)


def trap_psi_grad(a, x):
    """d/dx_k of trap_psi: -(x/a^2) (opt=1)."""
    return -(x / a ** 2)


def trap_psi_lap(a, x):
    """Sum_k d2/dx_k^2 of trap_psi: -1/a^2 per dim (opt=2)."""
    return (-1.0 / a ** 2 * x.new_ones(x.shape)).sum(-1)


def trap_pot(a, x):
    """Trap potential summed over dims: 1/2 x^2 / a^4 (opt=0)."""
    return (0.5 * x ** 2 / a ** 4).sum(-1)


def trap_pot_grad(a, x):
    """d/dx_k of trap_pot: x/a^4 (opt=1)."""
    return x / a ** 4
