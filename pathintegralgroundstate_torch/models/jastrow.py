"""Trial wave functions: the McMillan two-body Jastrow (system_mod.f90:38-66)
and the harmonic trap's one-body terms (TrapPsi / TrapPot,
system_mod.f90:213-252), elementwise on tensors.

The reference's sign conventions: du returns +2.5 (Rm/r)^5 / r; trap_psi_grad
returns -(x/a^2), the derivative of -x^2/(2 a^2).  The trap functions take
x [..., D] and the trap lengths a [D] (System.a_ho) and sum over the last
axis where the reference does, operation for operation.
"""

from __future__ import annotations


def mcmillan_u(Rm, r):
    """log-Jastrow u(r) (opt=0)."""
    return -0.5 * (Rm / r) ** 5


def mcmillan_du(Rm, r):
    """u'(r) (opt=1)."""
    return 2.5 * (Rm / r) ** 5 / r


def mcmillan_d2u(Rm, r):
    """u''(r) (opt=2)."""
    return -15.0 * (Rm / r) ** 5 / r ** 2


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
