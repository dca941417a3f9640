"""McMillan's two-body log-Jastrow u(r) = -1/2 (Rm/r)^5, C1-matched at the
cutoff under PBC (system_mod.f90:38-66).  McMillan, Phys. Rev. 138, A442
(1965)."""

C1_AT_CUTOFF = True


def u(Rm, r):
    return -0.5 * (Rm / r) ** 5


def du(Rm, r):
    return 2.5 * (Rm / r) ** 5 / r


def d2u(Rm, r):
    return -15.0 * (Rm / r) ** 5 / (r * r)
