"""The zero-energy two-body solution of the 2-D 1/r^3 problem,
u(r) = -2 sqrt(Rm/r), C1-matched at the cutoff under PBC: with Rm = Cdd,
|u'|^2 cancels the dipolar core in the local energy.  Astrakharchik et al.,
PRL 98, 060405 (2007)."""

C1_AT_CUTOFF = True


def u(Rm, r):
    return -2.0 * (Rm / r) ** 0.5


def du(Rm, r):
    return (Rm / r) ** 0.5 / r


def d2u(Rm, r):
    return -1.5 * (Rm / r) ** 0.5 / (r * r)
