"""Linear table interpolation with the reference's exact stencils.

The torch counterpart of pathintegralgroundstate_tpu/utils/interpolate.py
(interpolate.f90:1-45).  A table F indexed 0..N+1 holds the function at
r = (i-1) dx in F[i], i = 1..N (vpi_mod.f90:98-101), with the ghost cells
F[0] = F[2] and F[N+1] = F[N] (vpi_mod.f90:108-109).  For a query x the
reference picks ix = int(x/dx) + 1, truncating, clipped here to [2, N], and
blends F[ix-1] and F[ix]: it interpolates on the interval one grid step
BELOW x.  That is kept on purpose, since table mode exists to match the
reference's tables; the closed forms are the accurate path.

opt=0: value; opt=1: first derivative; opt=2: second derivative, by the
reference's neighbouring-interval finite-difference stencils
(interpolate.f90:23-37).
"""

from __future__ import annotations

import torch


def interpolate(opt: int, dx: float, F, x):
    """Table lookup matching interpolate.f90: F [N+2] with its ghost cells,
    x a tensor of any shape on F's device."""
    n = F.shape[0] - 2  # Nmax
    ix = torch.clamp((x / dx).to(torch.int32).long() + 1, 2, n)
    # the grid point in float64, then in x's type, as the reference's
    # int * float product promotes (interpolate.py:33)
    aux1 = x - ((ix - 1).to(torch.float64) * dx).to(x.dtype)
    aux2 = dx - aux1
    if opt == 0:
        return (aux1 * F[ix] + aux2 * F[ix - 1]) / dx
    if opt == 1:
        fb = (aux1 * F[ix - 1] + aux2 * F[ix - 2]) / dx
        fa = (aux1 * F[ix + 1] + aux2 * F[ix]) / dx
        return 0.5 * (fa - fb) / dx
    if opt == 2:
        fb = (aux1 * F[ix - 1] + aux2 * F[ix - 2]) / dx
        fc = (aux1 * F[ix] + aux2 * F[ix - 1]) / dx
        fa = (aux1 * F[ix + 1] + aux2 * F[ix]) / dx
        return (fa - 2.0 * fc + fb) / (dx * dx)
    raise ValueError(f"opt must be 0, 1 or 2, got {opt}")


def build_table(fn, rmax: float, n: int, dtype=torch.float64, device=None):
    """Tabulate fn on the reference grid (JastrowTable, vpi_mod.f90:84-112):
    (table [n+2], dx) with table[i] = fn((i-1) dx) for i = 1..n, evaluated
    in `dtype`, and the ghost cells table[0] = table[2], table[n+1] =
    table[n].  table[1] = fn(0) is the reference's own (non-finite for a
    potential with a core)."""
    dx = rmax / (n - 1)
    r = (torch.arange(1, n + 1, dtype=dtype, device=device) - 1.0) * dx
    vals = fn(r).to(dtype)
    return torch.cat([vals[1:2], vals, vals[-1:]]), dx
