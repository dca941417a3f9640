"""McMillan two-body Jastrow u(r) = -1/2 (Rm/r)^5 (system_mod.f90:38-66).

The reference's sign conventions: du returns +2.5 (Rm/r)^5 / r.
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
