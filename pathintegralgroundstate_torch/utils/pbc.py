"""Single-image periodic boundary conditions (pbc_mod.f90:11-52).

Like the reference, one image shift only: rcut <= L/2 and displacements
bounded by 1.5 L.  L and half are [D] tensors (System.L, System.half).
"""

from __future__ import annotations

import torch


def wrap(x, L, half):
    """Wrap coordinates or displacements x[..., D] into [-L/2, L/2]."""
    x = torch.where(x > half, x - L, x)
    return torch.where(x < -half, x + L, x)


def minimum_image(xij, L, half):
    """(xij wrapped [..., D], rij2 [...])."""
    xij = wrap(xij, L, half)
    return xij, (xij * xij).sum(-1)
