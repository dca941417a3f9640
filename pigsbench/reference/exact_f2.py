"""The exact Chin F^2 term (a configuration's `exact_f2`), by its brute
definition, from the positions alone.

The F^2 term of the Chin action at bead b weights sum_i |F_i|^2 over all
N particles, where F_i = sum_j V'(r_ij) (x_i - x_j) / r_ij over the
partners j within rcut at r^2 > 0 (the minimum image; the field as the
engine keeps it, the gradient of the potential energy in x_i).  Moving
particle p at bead b from xold to xnew changes the field of every
particle, so a displaced row's term is

    dF2_b = sum_i |F_i(R'_b)|^2 - |F_i(R_b)|^2,

R_b the configuration at bead b with p at xold and R'_b the same with p
at xnew, and F(R'_b) - F(R_b) is the field increment that a cache of the
field (`f2_cache`) has to add for an accepted move.  Both fields are
summed afresh over all pairs: this is the definition, not a cache's
algebra, so the cached and the brute forms of the program have to give
these same numbers.  Only the beads with a non-zero Chin F^2 weight (the
odd interior beads) carry the term; the others read 0."""

from __future__ import annotations

import torch

from .physics import wrap

# elements of the largest pair block built at once (s x rows x N x N x D)
_BLOCK = 2 ** 24


def field(geo, model, X):
    """[..., N, D]: every particle's field in configurations X [..., N, D],
    in blocks of the leading axis."""
    N, D = X.shape[-2:]
    lead = X.shape[:-2]
    flat = X.reshape(-1, N, D)
    step = max(1, _BLOCK // (N * N * D))
    out = [_field(geo, model, flat[i:i + step])
           for i in range(0, flat.shape[0], step)]
    return torch.cat(out).reshape(*lead, N, D)


def _field(geo, model, X):
    N = X.shape[-2]
    dx = wrap(X[..., :, None, :] - X[..., None, :, :], geo.L)
    r2 = (dx * dx).sum(-1)
    eye = torch.eye(N, dtype=torch.bool, device=X.device)
    m = (r2 <= geo.rcut2) & (r2 > 0) & ~eye
    r = torch.sqrt(torch.where(m, r2, torch.ones_like(r2)))
    fr = torch.where(m, model.dv(r) / r, torch.zeros_like(r))
    return (fr[..., None] * dx).sum(-2)


def rows(geo, model, R, p, beads, xnew, xold, wf):
    """(dF2 [s, B], dfield [s, B, N, D]) of particle p [s] moved from xold
    to xnew [s, B, D] at beads [B] of R [s, M, N, D], its other positions
    as R holds them; rows whose F^2 weight wf [B] is 0 read 0."""
    s, B = xnew.shape[:2]
    N, D = R.shape[2:]
    df2 = torch.zeros((s, B), dtype=R.dtype, device=R.device)
    dfield = torch.zeros((s, B, N, D), dtype=R.dtype, device=R.device)
    sel = torch.nonzero(wf != 0).flatten().to(R.device)
    if sel.numel() == 0:
        return df2, dfield
    X = R[:, beads.to(R.device)[sel]]                     # [s, b, N, D]
    moved = (torch.arange(N, device=R.device)[None, :]
             == p.to(R.device)[:, None])[:, None, :, None]
    Fo = field(geo, model, torch.where(moved, xold[:, sel, None, :], X))
    Fn = field(geo, model, torch.where(moved, xnew[:, sel, None, :], X))
    df2[:, sel] = (Fn * Fn).sum((-1, -2)) - (Fo * Fo).sum((-1, -2))
    dfield[:, sel] = Fn - Fo
    return df2, dfield
