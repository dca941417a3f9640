"""Single-image periodic boundary conditions (pbc_mod.f90:11-52) and the
pair geometry of both of the reference's geometries.

Like the reference, one image shift only: rcut <= L/2 and displacements
bounded by 1.5 L.  L and half are [D] tensors (System.L, System.half).
Under the harmonic trap (System.pbc false) there is no image and no pair
cutoff: `separation` and `pair_mask` branch on system.pbc as the reference
does (pairwise.py:92-95, 250-253), rather than lean on Lbox = 0.
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


def separation(system, xij):
    """(xij, rij2) of displacements xij[..., D]: the minimum image under
    PBC, the plain displacement under the trap."""
    if system.pbc:
        return minimum_image(xij, system.L, system.half)
    return xij, (xij * xij).sum(-1)


def pair_mask(system, notself, rij2):
    """The pairs that interact: notself & r^2 <= rcut^2 under PBC, notself
    (broadcast against rij2) under the trap."""
    if system.pbc:
        return notself & (rij2 <= system.geo.rcut2)
    return notself.expand(rij2.shape)


def pair_geometry(system, dx, notself):
    """(xij, rij2, r2s, m) of displacements dx[..., D] whose self-pairs are
    ~notself (broadcast against them): the separation, r2s = rij2 with 1 on
    the self-pairs (so that r and its derivatives stay finite there), and
    m the pairs that interact (pair_mask).  No r^2 > 0 guard."""
    xij, rij2 = separation(system, dx)
    ns = notself.expand(rij2.shape)
    return xij, rij2, torch.where(ns, rij2, 1.0), pair_mask(system, ns, rij2)


def all_pairs(system, R):
    """(m, r, xij) of every ordered pair (i, j) of configurations R[..., N,
    D]: the interacting pairs, r (1 on the diagonal) and the separations
    x_i - x_j (pair_geometry)."""
    N = R.shape[-2]
    notself = ~torch.eye(N, dtype=torch.bool, device=R.device)
    xij, _, r2s, m = pair_geometry(
        system, R[..., :, None, :] - R[..., None, :, :], notself)
    return m, torch.sqrt(r2s), xij
