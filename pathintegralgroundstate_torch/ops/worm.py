"""Worm algorithm: open / close / swap (vpi_mod.f90:1821-2487) and the OBDM
terms, on the whole walker ensemble.

The torch counterpart of pathintegralgroundstate_tpu/ops/worm.py.  Draws
come in as a `WormDraws` / `SwapDraws` tuple shaped as the reference draws
them; the swap partner is a Gumbel-max pick, argmax(logits + gumbel), which
is how jax.random.categorical samples.  `paths` (and, in swap, `xend`) are
updated in place, and so is the odd-bead force-field cache `fodd` of exact
F^2 (ops/moves.py) where a move takes it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..utils.pbc import separation
from .moves import (_cache_win_write, _codd_window, _codd_window_rev, _where,
                    get_chain, metropolis_u, segment_regrow, set_chain)


class WormDraws(NamedTuple):
    """Randoms of open_chain / close_chain (one draw serves both halves)."""
    Ls: torch.Tensor                 # [W] long, even in [2, Lmax-2]
    half: torch.Tensor               # [W] long, 0 -> half 1, 1 -> half 2
    g0: Optional[torch.Tensor]       # [W, D] terminal guess (open only)
    gs: torch.Tensor                 # [Lmax-3, W, D] bridge gaussians
    u_acc: torch.Tensor              # [W]


class SwapDraws(NamedTuple):
    Ls: torch.Tensor                 # [W] long
    gumbel: torch.Tensor             # [W, N] Gumbel noise of the pick
    u_pre: torch.Tensor              # [W] pre-accept uniform
    gs: torch.Tensor                 # [Lmax-3, W, D]
    u_acc: torch.Tensor              # [W]


def _rand_even_ls(gen, W: int, Lmax: int, device):
    """Ls = 2 int(((Lmax-2)/2) u) + 2, even in [2, Lmax-2]
    (vpi_mod.f90:1846)."""
    return 2 * torch.randint(0, (Lmax - 2) // 2, (W,), generator=gen,
                             device=device) + 2


def _gap_rij2(system, xa, xb):
    """r^2 of xa - xb: minimum image under PBC, none under the trap."""
    return separation(system, xa - xb)[1]


def _broken_link_k(system, rij2, Ls):
    """DeltaK = -rij^2/(2 Ls dt) - (d/2) log(2 pi Ls dt) (vpi_mod.f90:1872)."""
    cfg = system.cfg
    Lf = Ls.to(rij2.dtype)
    return (-0.5 * rij2 / (Lf * cfg.dt)
            - 0.5 * cfg.dim * torch.log(2.0 * math.pi * Lf * cfg.dt))


def _half_segments(system, paths, chain, half1: bool, Lmax: int):
    """Worm-centre segment in head orientation, its partner window and bead
    indices.  half1 (beads Nb-Lb..Nb, regrown at Nb): the window is
    returned in FORWARD bead order for a reversed read (rev=True)."""
    Nb = system.cfg.Nb
    Lb = Lmax - 2
    if half1:
        return (chain[:, Nb - Lb:Nb + 1].flip(1), paths[:, Nb - Lb:Nb + 1],
                system.arange(Nb, Nb - Lb - 1, -1))
    return (chain[:, Nb:Nb + Lb + 1].clone(), paths[:, Nb:Nb + Lb + 1],
            system.arange(Nb, Nb + Lb + 1))


def _writeback_half(chain, half1, acc, sA_old, sA_new, sB_old, sB_new, Nb,
                    Lmax):
    """Write the chosen half's (possibly accepted) segment into chain."""
    Lb = Lmax - 2
    chain[:, Nb - Lb:Nb + 1] = _where(acc & half1, sA_new, sA_old).flip(1)
    chain[:, Nb:Nb + Lb + 1] = _where(half1, chain[:, Nb:Nb + Lb + 1],
                                      _where(acc & ~half1, sB_new, sB_old))
    return chain


def _half_fold(fodd, half1: bool, Nb: int, Lmax: int):
    """Cache rows under a worm-centre half segment's displaced rows
    0..Lb-1 in segment orientation (worm.py:82-89): (f, fold_sub, k_lo)."""
    if half1:
        return _codd_window_rev(fodd, Nb, Lmax - 2)
    return _codd_window(fodd, Nb, Lmax - 2)


def _apply_half_dfield(fodd, half1, acc, infoA, infoB):
    """Add the chosen half's accepted increments (worm.py:92-109).  In
    place, one half after the other: with Nb odd both halves hold the
    centre's cache row, and the gates are disjoint.  info = (dfield, k_lo)
    in each half's segment orientation."""
    for (df, k), gate, rev in ((infoA, acc & half1, True),
                               (infoB, acc & ~half1, False)):
        inc = _where(gate, df, 0.0)
        fodd[:, k:k + df.shape[1]] += inc.flip(1) if rev else inc


def _regrow_halves(system, paths, chain, ip, Lmax, d, mode, pin_of, fodd):
    """segment_regrow of both worm-centre halves (half 1 reversed): per
    half (seg, seg_new, dS, (dfield, k_lo) or None)."""
    out = []
    for h1 in (True, False):
        seg, R_seg, ib = _half_segments(system, paths, chain, h1, Lmax)
        kw, k = {}, None
        if fodd is not None:
            f, sub, k = _half_fold(fodd, h1, system.cfg.Nb, Lmax)
            kw = dict(fold=f, fold_sub=sub)
        seg_new, dS, *df = segment_regrow(
            system, seg, R_seg, ib, ip, d.Ls, mode, 0.5, d.g0, d.gs,
            first_pos=pin_of(h1), rev=h1, **kw)
        out.append((seg, seg_new, dS, (df[0], k) if df else None))
    return out


def _anchor(seg, Ls):
    W, _, D = seg.shape
    return seg.gather(1, Ls.view(W, 1, 1).expand(W, 1, D))[:, 0]


def open_chain(system, paths, xend, ip, active, Lmax: int, d: WormDraws,
               fodd=None):
    """OpenChain (vpi_mod.f90:1821-2076).  ip [W] long; fodd: the odd-bead
    cache.

    Returns (paths, xend_new, opened); xend_new is the open worm's ends for
    every walker (on reject both are the restored centre bead)."""
    cfg, geo = system.cfg, system.geo
    Nb = cfg.Nb
    half1 = d.half == 0
    chain = get_chain(paths, ip)
    dS_base = -math.log(cfg.CWorm * geo.density)

    halves = _regrow_halves(system, paths, chain, ip, Lmax, d, "gauss",
                            lambda h1: None, fodd)
    (sA_old, sA_new, dsA, dfA), (sB_old, sB_new, dsB, dfB) = halves
    dkA, dkB = (_broken_link_k(system, _gap_rij2(
        system, seg[:, 0], _anchor(seg, d.Ls)), d.Ls) for seg in (sA_old,
                                                                 sB_old))
    dS = dS_base + torch.where(half1, dsA, dsB)
    dK = torch.where(half1, dkA, dkB)
    acc = metropolis_u(d.u_acc, dS + dK) & active

    old_center = chain[:, Nb].clone()
    _writeback_half(chain, half1, acc, sA_old, sA_new, sB_old, sB_new, Nb,
                    Lmax)
    new_center = chain[:, Nb]
    xend1 = _where(acc, _where(half1, new_center, old_center), new_center)
    xend2 = _where(acc, _where(half1, old_center, new_center), new_center)
    set_chain(paths, ip, chain)
    if fodd is not None:
        _apply_half_dfield(fodd, half1, acc, dfA, dfB)
    return paths, torch.stack([xend1, xend2], 1), acc


def close_chain(system, paths, xend, ip, active, Lmax: int, d: WormDraws,
                fodd=None):
    """CloseChain (vpi_mod.f90:2080-2266).  ip [W] long; fodd: the
    odd-bead cache.

    Returns (paths, xend_new, closed)."""
    cfg, geo = system.cfg, system.geo
    Nb = cfg.Nb
    half1 = d.half == 0
    chain = get_chain(paths, ip)
    dS_base = math.log(cfg.CWorm * geo.density)

    halves = _regrow_halves(system, paths, chain, ip, Lmax, d, "pin",
                            lambda h1: xend[:, 1] if h1 else xend[:, 0],
                            fodd)
    (sA_old, sA_new, dsA, dfA), (sB_old, sB_new, dsB, dfB) = halves
    # closed-gap kinetic term from the NEW positions (vpi_mod.f90:2205)
    dkA, dkB = (_broken_link_k(system, _gap_rij2(
        system, seg[:, 0], _anchor(seg, d.Ls)), d.Ls) for seg in (sA_new,
                                                                 sB_new))
    dS = dS_base + torch.where(half1, dsA, dsB)
    dK = torch.where(half1, dkA, dkB)
    acc = metropolis_u(d.u_acc, dS - dK) & active

    _writeback_half(chain, half1, acc, sA_old, sA_new, sB_old, sB_new, Nb,
                    Lmax)
    center = chain[:, Nb]
    xend_new = _where(acc, torch.stack([center, center], 1), xend)
    set_chain(paths, ip, chain)
    if fodd is not None:
        _apply_half_dfield(fodd, half1, acc, dfA, dfB)
    return paths, xend_new, acc


def swap_move(system, paths, xend, iw, active, Lmax: int, d: SwapDraws,
              fodd=None):
    """Swap (vpi_mod.f90:2270-2487): exchange the worm's tail half with a
    partner picked by tower sampling over kinetic weights.  iw [W] long.

    fodd: the odd-bead cache.  On accept the partner's regrown beads get
    their increments, and beads Nb..2Nb only swap labels between iw and
    ik (the same set of positions), so there the two particles' force
    columns swap (worm.py:232-236, 304-326).

    Returns (paths, xend, accepted, partner[W])."""
    cfg = system.cfg
    Nb, dt = cfg.Nb, cfg.dt
    W = paths.shape[0]
    rows = system.arange(W)
    Lf = d.Ls.to(paths.dtype)

    R_ii = paths[rows, Nb - d.Ls]                              # [W, N, D]
    logits = -0.5 * _gap_rij2(system, R_ii, xend[:, 1][:, None, :]) \
        / (Lf[:, None] * dt)
    Sw = torch.exp(logits).sum(-1)
    ik = torch.argmax(logits + d.gumbel, -1)

    # reverse weights against the partner's central bead
    x_ik_nb = paths[rows, Nb, ik]                              # [W, D]
    rij2_k = _gap_rij2(system, R_ii, x_ik_nb[:, None, :])
    Sk = torch.exp(-0.5 * rij2_k / (Lf[:, None] * dt)).sum(-1)
    ok = active & (ik != iw) & (d.u_pre <= Sw / Sk)

    chain_iw = get_chain(paths, iw)
    chain_ik = get_chain(paths, ik)

    # regrow the partner's [Nb-Ls .. Nb] onto the worm tail; the pin bead
    # itself carries no dS (vpi_mod.f90:2388-2436)
    Lb = Lmax - 2
    seg = chain_ik[:, Nb - Lb:Nb + 1].flip(1)
    kw = {}
    if fodd is not None:
        f_seg, sub, k_lo = _codd_window_rev(fodd, Nb, Lb)
        kw = dict(fold=f_seg, fold_sub=sub)
    seg_new, dSr, *df = segment_regrow(
        system, seg, paths[:, Nb - Lb:Nb + 1],
        system.arange(Nb, Nb - Lb - 1, -1), ik, d.Ls, "pin", 0.0, None,
        d.gs, first_pos=xend[:, 1], rev=True, **kw)
    acc = ok & metropolis_u(d.u_acc, dSr)

    regrown = chain_ik.clone()
    regrown[:, Nb - Lb:Nb + 1] = seg_new.flip(1)
    # tail exchange (vpi_mod.f90:2450-2464): worm tail := partner's tail,
    # then bead Nb := partner's old centre; partner tail := worm's old tail
    new_iw = torch.cat([chain_iw[:, :Nb], chain_ik[:, Nb:Nb + 1],
                        regrown[:, Nb + 1:]], 1)
    new_ik = torch.cat([regrown[:, :Nb], chain_iw[:, Nb:]], 1)
    out_iw = _where(acc, new_iw, chain_iw)
    out_ik = _where(acc, new_ik, chain_ik)
    set_chain(paths, iw, out_iw)
    # the partner write is the worm's own when ik == iw
    set_chain(paths, ik, _where(ik == iw, out_iw, out_ik))
    xend[:, 1] = _where(acc, chain_ik[:, Nb], xend[:, 1])
    if fodd is not None:
        # the regrow increments (the pin row's is 0, so a shared centre
        # row is safe), then the label swap at the odd beads of [Nb, 2Nb]
        _cache_win_write(fodd, f_seg, df[0], acc, k_lo, reverse=True)
        f_tail = fodd[:, (Nb + (Nb + 1) % 2) // 2:]
        f_iw, f_ik = f_tail[rows, :, iw], f_tail[rows, :, ik]
        parts = system.arange(paths.shape[2])
        oh_iw = (parts == iw[:, None])[:, None, :, None]
        oh_ik = (parts == ik[:, None])[:, None, :, None]
        swapped = torch.where(oh_iw, f_ik[:, :, None], torch.where(
            oh_ik, f_iw[:, :, None], f_tail))
        f_tail.copy_(_where(acc & (ik != iw), swapped, f_tail))
    return paths, xend, acc, ik


def obdm_terms(system, xend):
    """OBDM accumulation terms (sample_mod.f90:480-526), in both geometries
    (no minimum image under the trap): (ibin[W] long, cos(2 m theta)
    weights [W, Npw+1], valid[W])."""
    cfg, geo = system.cfg, system.geo
    xij, rij2 = separation(system, xend[:, 0] - xend[:, 1])
    valid = rij2 <= geo.rcut2
    rij = torch.sqrt(torch.clamp(rij2, min=1e-30))
    ibin = torch.clamp((rij / geo.rbin).long(), 0, cfg.Nbin - 1)
    if cfg.dim >= 2:
        theta = torch.atan2(xij[:, 1], xij[:, 0])
    else:
        theta = torch.where(xij[:, 0] >= 0, 0.0, math.pi).to(rij.dtype)
    m = torch.arange(cfg.Npw + 1, dtype=rij.dtype, device=rij.device)
    return ibin, torch.cos(2.0 * theta[:, None] * m[None, :]), valid
