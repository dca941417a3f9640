"""The dipole-dipole repulsion of polarised dipoles in a plane, Cdd / r^3
with Cdd = 1 (the length unit r0 = m Cdd / hbar^2).
Astrakharchik, Boronat, Kurbakov, Lozovik, PRL 98, 060405 (2007)."""

CDD = 1.0


def v(r):
    return CDD / (r * r * r)


def dvdr(r):
    return -3.0 * CDD / (r * r * r * r)
