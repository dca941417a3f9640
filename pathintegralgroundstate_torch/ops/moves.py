"""Monte Carlo path updates on the whole walker ensemble (vpi_mod.f90).

The torch counterpart of pathintegralgroundstate_tpu/ops/moves.py: rigid
translations, the segment regrow (the one-matmul Brownian bridge, or the
reference's sequential staging recursion with cfg.regrow='scan'), the
staging sampler's moves (staging_move, move_head, move_tail) and the worm
half-chain moves.  Every move is a function of (paths, ..., draws):
its random numbers come in as tensors shaped as the JAX move draws them
(utils/draws.py makes them), so the port can be held against the reference
on identical draws.

`paths[W, M, N, D]` and `xend[W, 2, D]` are updated IN PLACE (and also
returned); the window the pair pass reads is a view of `paths`.  A scalar
particle index is a Python int; a per-walker one (the worm) a long tensor.

A window start is a Python int shared by every walker (cfg.shared_windows,
the default), or with shared_windows=False a long tensor [W] of per-walker
starts (moves.py:161-176): the window is then gathered into a contiguous
copy [W, L, N, D] (`_slice_beads`), its bead indices are [W, L], and the
accepted beads are scattered back (`_win_write`), as the reference's
_slice_beads / _update_beads gather and scatter (moves.py:105-129).

Exact F^2 (cfg.exact_f2 with f2_cache): every move takes the odd-bead
force-field cache `fodd` [W, Nb, N, D] (row k the field at bead 2k+1, the
only beads whose F^2 carries Chin weight), evaluates its F^2 term through
the cache rows under its window's odd beads, and adds the increments of
its accepted proposals to the cache IN PLACE (moves.py:452-505).  Windows
start on even beads, so a window's odd beads are one contiguous range of
cache rows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.pbc import wrap
from .pairwise import delta_action_sum, delta_pot_cached


# ---------------------------------------------------------------------------
# Small helpers
# ---------------------------------------------------------------------------

def metropolis_u(u, dS):
    """Metropolis accept from a pre-drawn uniform (vpi_mod.f90:356-364)."""
    return u < torch.exp(-dS)


def _mi(system, x):
    """Single-image wrap of a displacement (identity under the trap)."""
    return wrap(x, system.L, system.half) if system.pbc else x


def _wrap_pos(system, x):
    """BoundaryConditions for absolute positions (identity under the
    trap)."""
    return wrap(x, system.L, system.half) if system.pbc else x


def _rand_ls(gen, W: int, Lmax: int, device):
    """Ls = int((Lmax-1) u) + 2 in [2, Lmax] (vpi_mod.f90:601)."""
    return torch.randint(0, Lmax - 1, (W,), generator=gen, device=device) + 2


def get_chain(paths, ip):
    """Worldlines [W, M, D] of particle ip (int: a view; [W]: a copy)."""
    if isinstance(ip, int):
        return paths[:, :, ip]
    return paths[torch.arange(paths.shape[0], device=paths.device), :, ip]


def set_chain(paths, ip, chain):
    """Write chains [W, M, D] into paths at particle(s) ip, in place."""
    if isinstance(ip, int):
        paths[:, :, ip] = chain
    else:
        paths[torch.arange(paths.shape[0], device=paths.device), :, ip] = chain
    return paths


@functools.lru_cache(maxsize=None)
def _iota(n: int, device) -> torch.Tensor:
    """arange(n) on device (torch.long), built once per (n, device)."""
    return torch.arange(n, device=device)


def _slice_beads(arr, ii, L: int):
    """Window of L beads from ii along axis 1 (moves.py:105-119): ii an int,
    a view; ii a long tensor [W] of per-walker starts, one gather into a
    contiguous copy [W, L, ...]."""
    if isinstance(ii, int):
        return arr[:, ii:ii + L]
    idx = ii[:, None] + _iota(L, arr.device)
    return arr[_iota(arr.shape[0], arr.device)[:, None], idx]


def bead_index(system, ii, lo: int, hi: int, step: int = 1):
    """Bead indices ii+lo, ii+lo+step, .. below ii+hi: a cached [B] range
    for an int start, [W, B] (contiguous) for per-walker starts ii [W]."""
    if isinstance(ii, int):
        return system.arange(ii + lo, ii + hi, step)
    return ii[:, None] + system.arange(lo, hi, step)


def _win_write(paths, lo, ip, seg):
    """Write the moved particle's beads seg[W, L, D] at beads lo.. in place:
    lo an int (a window view), or per-walker starts lo [W], one scatter
    (the reference's _update_beads, moves.py:122-129)."""
    if isinstance(lo, int):
        set_chain(paths[:, lo:lo + seg.shape[1]], ip, seg)
        return paths
    W, L = seg.shape[:2]
    rows = _iota(W, paths.device)[:, None]
    idx = lo[:, None] + _iota(L, paths.device)
    paths[rows, idx, ip if isinstance(ip, int) else ip[:, None]] = seg
    return paths


def _where(acc, a, b):
    """Per-walker select over [W, ...] blocks."""
    return torch.where(acc.view((-1,) + (1,) * (a.dim() - 1)), a, b)


# ---------------------------------------------------------------------------
# The odd-bead force-field cache (exact Chin F^2, cfg.exact_f2 + f2_cache)
# ---------------------------------------------------------------------------

def _codd_window(codd, lo, B: int, par: int = None):
    """Cache rows under the odd beads of window rows 0..B-1 at beads
    lo..lo+B-1 (moves.py:464-474): (f [W, mo, N, D], (r0, 2), k0), the
    window's rows r0::2 being the cache rows k0..k0+mo-1 in order.  lo an
    int: f a view; per-walker starts lo [W] (all of parity par): f a
    gathered copy and k0 [W]."""
    r0 = ((lo % 2 if par is None else par) + 1) % 2
    mo = (B - r0 + 1) // 2
    k0 = (lo + r0) // 2
    return _slice_beads(codd, k0, mo), (r0, 2), k0


def _codd_window_rev(codd, hi: int, B: int):
    """The reversed window's cache rows (moves.py:477-486): rows 0..B-1 at
    beads hi, hi-1, .., hi-B+1.  Returns (f, (r0, 2), k_lo), f row-aligned
    with the reversed window's odd rows (beads descending, a copy); it
    goes back reversed at cache row k_lo."""
    r0 = (hi % 2 + 1) % 2
    mo = (B - r0 + 1) // 2
    k_lo = (hi - r0) // 2 - mo + 1
    return codd[:, k_lo:k_lo + mo].flip(1), (r0, 2), k_lo


def _cache_win_write(codd, f_seg, dfield, acc, k0, reverse=False):
    """Write back the window's cache rows with the increments of the
    accepted walkers added (moves.py:489-504), in place; dfield rows align
    with f_seg's, reverse un-reverses a tail-oriented window.  k0 an int,
    or per-walker rows k0 [W] (one scatter)."""
    f_new = f_seg + _where(acc, dfield, 0.0)
    if reverse:
        f_new = f_new.flip(1)
    if isinstance(k0, int):
        codd[:, k0:k0 + f_new.shape[1]] = f_new
        return
    W, mo = f_new.shape[:2]
    codd[_iota(W, codd.device)[:, None],
         k0[:, None] + _iota(mo, codd.device)] = f_new


# ---------------------------------------------------------------------------
# Brownian-bridge tables: the staging recursion as one matmul
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bridge_tables(Lmax: int, dt: float):
    """The staging recursion (vpi_mod.f90:531-533) unrolled into a linear map
    (a copy of the reference's moves._bridge_tables):

        x_j = (1 - j/L) start + (j/L) anchor + sum_k T_L[j,k] g_k.

    Returns (T[Lmax+1, Lmax-1, Lmax-1], w[Lmax+1, Lmax-1]) as float64 numpy,
    indexed by the segment length Ls; rows j >= L are zero."""
    J = Lmax - 1
    T = np.zeros((Lmax + 1, J, J))
    w = np.zeros((Lmax + 1, J))
    for L in range(2, Lmax + 1):
        a = np.ones(L)
        s = np.zeros(L)
        for j in range(1, L):
            a[j] = (L - j) / (L - j + 1.0)
            s[j] = np.sqrt((L - j) / (L - j + 1.0) * dt)
        for j in range(1, L):
            w[L, j - 1] = j / L
            T[L, j - 1, j - 1] = s[j]
            for k in range(j - 1, 0, -1):
                T[L, j - 1, k - 1] = s[k] * np.prod(a[k + 1:j + 1])
    return T, w


# ---------------------------------------------------------------------------
# The segment-regrow workhorse
# ---------------------------------------------------------------------------

def _scan_regrow(system, seg, Ls, xnew0, anchor, gs):
    """Beads 1..Lb-1 by the staging recursion itself (moves.py:318-335,
    vpi_mod.f90:509-549), bead after bead; beads >= Ls keep their place."""
    dt = system.cfg.dt
    prev, out = xnew0, []
    for j in range(1, seg.shape[1] - 1):
        xold_j = seg[:, j]
        nrem = torch.clamp(Ls - j, min=1).to(seg.dtype)[:, None]
        xprev = xold_j + _mi(system, prev - xold_j)
        xnext = xold_j - _mi(system, xold_j - anchor)
        sigma = torch.sqrt(nrem / (nrem + 1.0) * dt)
        xmid = (xnext + xprev * nrem) / (nrem + 1.0)
        prev = _where(j < Ls, _wrap_pos(system, xmid + sigma * gs[j - 1]),
                      xold_j)
        out.append(prev)
    return torch.stack(out, 1)


def regrow_proposal(system, seg, Ls, first_mode: str, g0, gs,
                    first_pos=None, fixed_L=None):
    """The proposal of segment_regrow: (xnew0 [W, D], xnews [W, Lb-1, D]),
    the new end bead and beads 1..Lb-1 (beads >= Ls kept), by the bridge
    matmul or, with cfg.regrow='scan', the sequential recursion."""
    dt = system.cfg.dt
    W, Lbp1, D = seg.shape
    Lb = Lbp1 - 1
    dtype = seg.dtype
    anchor = seg.gather(1, Ls.view(W, 1, 1).expand(W, 1, D))[:, 0]
    xold0 = seg[:, 0]

    if first_mode == "gauss":
        xmid = xold0 - _mi(system, xold0 - anchor)
        sigma = torch.sqrt(Ls.to(dtype) * dt)[:, None]
        xnew0 = _wrap_pos(system, xmid + sigma * g0)
    elif first_mode == "pin":
        xnew0 = first_pos
    elif first_mode == "fixed":
        xnew0 = xold0
    else:
        raise ValueError(first_mode)
    if system.cfg.regrow == "scan":
        return xnew0, _scan_regrow(system, seg, Ls, xnew0, anchor, gs)

    xolds = seg[:, 1:Lb]
    T = system.const(("bridge_T", Lb, dtype),
                     lambda: _bridge_tables(Lb, dt)[0], dtype)
    wt = system.const(("bridge_w", Lb, dtype),
                      lambda: _bridge_tables(Lb, dt)[1], dtype)
    g = gs.transpose(0, 1)                         # [W, Lb-1, D]
    xdiff = -_mi(system, xnew0 - anchor)
    if fixed_L is not None:
        z = torch.einsum("jk,wkd->wjd", T[fixed_L], g)
        wgt = wt[fixed_L][None, :]
    else:
        z = torch.bmm(T[Ls], g)
        wgt = wt[Ls]
    mean = xnew0[:, None, :] + wgt[:, :, None] * xdiff[:, None, :]
    xnews = _wrap_pos(system, mean + z)
    act = (system.arange(1, Lb)[None, :] < Ls[:, None])[:, :, None]
    return xnew0, torch.where(act, xnews, xolds)


def segment_regrow(system, seg, R_seg, ib_seg, ip, Ls, first_mode: str,
                   first_w: float, g0, gs, first_pos=None, fixed_L=None,
                   rev=False, fold=None, fold_sub=(0, 1)):
    """Regrow segments in head orientation (moves.py:229-365).

    seg [W, Lb+1, D]: index 0 = the end being regrown, index Ls = the fixed
    anchor.  R_seg [W, Lb+1, N, D]: the partners at the segment's beads, in
    head orientation, or in forward bead order with rev=True (then
    seg[:, b] sits at R_seg[:, Lb-b]).  ib_seg [Lb+1] or [W, Lb+1]:
    bead indices in head orientation.  Ls [W] long.
    first_mode: 'gauss' (free gaussian guess of bead 0, sigma sqrt(Ls dt),
    from g0 [W, D]), 'pin' (bead 0 := first_pos) or 'fixed'.
    first_w: weight of the first bead's dS (1/2 worm centre, 0 Swap's pin).
    gs [Lb-1, W, D]: the bridge gaussians, in the reference's draw layout.
    fixed_L: every walker's Ls equals it (one bridge matrix).
    fold: the cache rows under the odd rows fold_sub of displaced rows
    0..Lb-1 (head orientation): the F^2 term is the exact cached one.

    Returns (seg_new, dS[W]), with fold (seg_new, dS, dfield)."""
    Lb = seg.shape[1] - 1
    xnew0, xnews = regrow_proposal(system, seg, Ls, first_mode, g0, gs,
                                   first_pos, fixed_L)
    # one pair pass over displaced rows 0..Lb-1; a ZERO-weighted first row
    # (Swap's pin, which coincides exactly with the worm's bead) is
    # evaluated at its old position so its singular terms never enter
    x0_eval = seg[:, 0] if first_w == 0.0 else xnew0
    xnew_all = torch.cat([x0_eval[:, None], xnews], 1)
    rw = None
    if first_w not in (0.0, 1.0):
        rw = system.const(("row_w", Lb, first_w, seg.dtype),
                          lambda: np.r_[first_w, np.ones(Lb - 1)], seg.dtype)
    R_rows = R_seg[:, 1:] if rev else R_seg[:, :Lb]
    out = delta_action_sum(system, R_rows, xnew_all, seg[:, :Lb], ip,
                           ib_seg[..., :Lb].contiguous(),
                           need_wf=first_mode == "gauss",
                           row_weights=rw, rev=rev, fold=fold,
                           fold_sub=fold_sub)
    seg_new = torch.cat([xnew0[:, None], xnews, seg[:, Lb:]], 1)
    if fold is not None:
        return (seg_new,) + out
    return seg_new, out


def fused_end_stagings(system, paths, ip: int, active, Lmax: int, Ls, g0, gs,
                       u_acc, fodd=None):
    """MoveHead + MoveTail of particle ip as ONE composite update
    (moves.py:686-740; valid when 2 Lmax < M-1, caller-guaranteed).

    The tail segment, bead-reversed into head orientation, is stacked
    behind the head segment along the walker axis, so one bridge
    construction regrows both ends: Ls [2W], g0 [2W, D], gs [Lmax-1, 2W,
    D], u_acc [2W] (head walkers first), as the reference draws them.  The
    pair pass reads each window in place (the tail backwards), one kernel
    launch per window, instead of a stacked window copy.  fodd: the
    odd-bead cache, each window through its own cache rows.
    Returns (paths, acc_head[W], acc_tail[W])."""
    M = system.M
    W = paths.shape[0]
    R_head = paths[:, :Lmax + 1]
    R_tail = paths[:, M - 1 - Lmax:]                      # forward order
    seg = torch.cat([R_head[:, :, ip], R_tail[:, :, ip].flip(1)], 0)
    xnew0, xnews = regrow_proposal(system, seg, Ls, "gauss", g0, gs)
    xnew = torch.cat([xnew0[:, None], xnews], 1)          # rows 0..Lmax-1
    kw_h = kw_t = {}
    if fodd is not None:
        f_h, sub, k_h = _codd_window(fodd, 0, Lmax)
        f_t, _, k_t = _codd_window_rev(fodd, M - 1, Lmax)
        kw_h, kw_t = dict(fold=f_h, fold_sub=sub), dict(fold=f_t, fold_sub=sub)
    out_h = delta_action_sum(system, R_head[:, :Lmax], xnew[:W],
                             seg[:W, :Lmax], ip, system.arange(Lmax), **kw_h)
    out_t = delta_action_sum(system, R_tail[:, 1:], xnew[W:], seg[W:, :Lmax],
                             ip, system.arange(M - 1, M - 1 - Lmax, -1),
                             rev=True, **kw_t)
    dS = torch.cat([out_h, out_t] if fodd is None else [out_h[0], out_t[0]])
    acc = metropolis_u(u_acc, dS) & torch.cat([active, active])
    fin = _where(acc, torch.cat([xnew, seg[:, Lmax:]], 1), seg)
    R_head[:, :, ip] = fin[:W]
    R_tail[:, :, ip] = fin[W:].flip(1)
    if fodd is not None:
        _cache_win_write(fodd, f_h, out_h[1], acc[:W], k_h)
        _cache_win_write(fodd, f_t, out_t[1], acc[W:], k_t, reverse=True)
    return paths, acc[:W], acc[W:]


# ---------------------------------------------------------------------------
# Rigid translations (TranslateChain, vpi_mod.f90:313-476)
# ---------------------------------------------------------------------------

def translate_chain(system, paths, ip: int, active, delta, u_dx, u_acc,
                    fodd=None):
    """Rigid CM displacement of particle ip's whole worldline.

    u_dx [W, 1, D], u_acc [W]: the uniforms of the displacement and the
    accept.  fodd: the odd-bead cache, whose rows are the chain's odd
    beads 1, 3, .., M-2.  Returns (paths, acc)."""
    chain = get_chain(paths, ip)
    dx = delta * (2.0 * u_dx - 1.0)
    xnew = _wrap_pos(system, chain + dx)
    ib = system.arange(system.M)
    if fodd is None:
        dS = delta_action_sum(system, paths, xnew, chain, ip, ib)
    else:
        dS, dfield = delta_action_sum(system, paths, xnew, chain, ip, ib,
                                      fold=fodd, fold_sub=(1, 2))
    acc = metropolis_u(u_acc, dS) & active
    if fodd is not None:
        fodd += _where(acc, dfield, 0.0)
    set_chain(paths, ip, _where(acc, xnew, chain))
    return paths, acc


def translate_half_chain(system, paths, xend, ip, half: int, active, delta,
                         u_dx, u_acc, fodd=None):
    """Rigid displacement of one worm half (vpi_mod.f90:383-476).

    Bead Nb is first pinned to xend[half] (persisting on reject), for
    active walkers only.  half 1 -> beads 0..Nb, 2 -> Nb..2Nb.  fodd: the
    odd-bead cache, which sees the pin first (_pin_center).
    Returns (paths, xend, acc)."""
    Nb = system.cfg.Nb
    lo, hi = (0, Nb + 1) if half == 1 else (Nb, 2 * Nb + 1)
    Rw = paths[:, lo:hi]
    if fodd is not None:
        _pin_center(system, paths, xend, ip, half, active, fodd)
    xold = get_chain(Rw, ip).clone()
    xold[:, Nb - lo] = _where(active, xend[:, half - 1], xold[:, Nb - lo])
    xnew = _wrap_pos(system, xold + delta * (2.0 * u_dx - 1.0))
    ib = system.arange(lo, hi)
    if fodd is None:
        dS = delta_action_sum(system, Rw, xnew, xold, ip, ib)
    else:
        f_seg, sub, k0 = _codd_window(fodd, lo, hi - lo)
        dS, dfield = delta_action_sum(system, Rw, xnew, xold, ip, ib,
                                      fold=f_seg, fold_sub=sub)
    acc = metropolis_u(u_acc, dS) & active
    seg_fin = _where(acc, xnew, xold)
    xend[:, half - 1] = _where(active, seg_fin[:, Nb - lo], xend[:, half - 1])
    _win_write(paths, lo, ip, seg_fin)
    if fodd is not None:
        _cache_win_write(fodd, f_seg, dfield, acc, k0)
    return paths, xend, acc


# ---------------------------------------------------------------------------
# Staging and end moves (Staging, MoveHead, MoveTail, vpi_mod.f90:480-860)
# and their worm half-chain forms (vpi_mod.f90:1376-1817)
# ---------------------------------------------------------------------------

def _stage(system, paths, ip, active, ii, L: int, gs, u_acc, fodd=None,
           par: int = 0):
    """Interior staging of beads ii+1..ii+L-1 of particle ip, anchored at
    ii and ii+L: ii an int or per-walker starts [W] of parity par, gs
    [L-1, W, D], u_acc [W].  In place; returns acc."""
    W = paths.shape[0]
    R_seg = _slice_beads(paths, ii, L + 1)
    seg = get_chain(R_seg, ip)
    Ls = torch.full((W,), L, dtype=torch.long, device=paths.device)
    kw = {}
    if fodd is not None:
        f_seg, sub, k0 = _codd_window(fodd, ii, L, par)
        kw = dict(fold=f_seg, fold_sub=sub)
    seg_new, dS, *df = segment_regrow(system, seg, R_seg,
                                      bead_index(system, ii, 0, L + 1), ip,
                                      Ls, "fixed", 1.0, None, gs, fixed_L=L,
                                      **kw)
    acc = metropolis_u(u_acc, dS) & active
    _win_write(paths, ii, ip, _where(acc, seg_new, seg))
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df[0], acc, k0)
    return acc


def _regrow_head(system, paths, ip, active, lo: int, Lmax: int, first_w,
                 Ls, g0, gs, u_acc, fodd=None):
    """Regrow beads lo..lo+Ls-1 of particle ip from a gaussian guess of
    bead lo (its dS weighted first_w) toward the anchor lo+Ls.  In place;
    returns (the window [W, Lmax+1, D] as written, acc)."""
    R_seg = paths[:, lo:lo + Lmax + 1]
    seg = get_chain(R_seg, ip)
    kw = {}
    if fodd is not None:
        f_seg, sub, k0 = _codd_window(fodd, lo, Lmax)
        kw = dict(fold=f_seg, fold_sub=sub)
    seg_new, dS, *df = segment_regrow(system, seg, R_seg,
                                      system.arange(lo, lo + Lmax + 1), ip,
                                      Ls, "gauss", first_w, g0, gs, **kw)
    acc = metropolis_u(u_acc, dS) & active
    seg_fin = _where(acc, seg_new, seg)
    _win_write(paths, lo, ip, seg_fin)
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df[0], acc, k0)
    return seg_fin, acc


def _regrow_tail(system, paths, ip, active, hi: int, Lmax: int, first_w,
                 Ls, g0, gs, u_acc, fodd=None):
    """The mirror of _regrow_head: beads hi, hi-1, .., hi-Ls+1 from a guess
    of bead hi.  The partner window is read backwards in place (rev); only
    the small chain segment is flipped.  Returns (the window in head
    orientation, acc)."""
    lo = hi - Lmax
    R_fwd = paths[:, lo:hi + 1]
    seg = get_chain(R_fwd, ip).flip(1)
    kw = {}
    if fodd is not None:
        f_seg, sub, k_lo = _codd_window_rev(fodd, hi, Lmax)
        kw = dict(fold=f_seg, fold_sub=sub)
    seg_new, dS, *df = segment_regrow(system, seg, R_fwd,
                                      system.arange(hi, lo - 1, -1), ip, Ls,
                                      "gauss", first_w, g0, gs, rev=True,
                                      **kw)
    acc = metropolis_u(u_acc, dS) & active
    seg_fin = _where(acc, seg_new, seg)
    _win_write(paths, lo, ip, seg_fin.flip(1))
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df[0], acc, k_lo, reverse=True)
    return seg_fin, acc


def staging_move(system, paths, ip: int, active, L: int, start, gs,
                 u_acc, fodd=None):
    """Interior staging over the even-aligned window start..start+L
    (moves.py:507-542): start a host int shared by every walker, or with
    shared_windows=False per-walker starts [W]; gs [L-1, W, D], u_acc [W].
    Returns (paths, acc)."""
    return paths, _stage(system, paths, ip, active, start, L, gs, u_acc,
                         fodd)


def move_head(system, paths, ip: int, active, Lmax: int, Ls, g0, gs, u_acc,
              fodd=None):
    """MoveHead (moves.py:631-654): regrow the first Ls [W] beads from a
    free-gaussian guess of bead 0.  Returns (paths, acc)."""
    return paths, _regrow_head(system, paths, ip, active, 0, Lmax, 1.0, Ls,
                               g0, gs, u_acc, fodd)[1]


def move_tail(system, paths, ip: int, active, Lmax: int, Ls, g0, gs, u_acc,
              fodd=None):
    """MoveTail (moves.py:657-683): the mirror of move_head at bead M-1.
    Returns (paths, acc)."""
    return paths, _regrow_tail(system, paths, ip, active, system.M - 1,
                               Lmax, 1.0, Ls, g0, gs, u_acc, fodd)[1]


def _pin_center(system, paths, xend, ip, half: int, active, fodd=None):
    """Pin bead Nb of particle ip to xend[half], ACTIVE walkers only (closed
    walkers' xend is stale, vpi_mod.f90:1400-1406).  In place.

    The pin is a configuration change that persists on reject, so with the
    cache its one-row field increment is applied unconditionally; an even
    bead Nb has no cache row (moves.py:545-574)."""
    Nb = system.cfg.Nb
    row = paths[:, Nb:Nb + 1]
    cur = get_chain(row, ip)
    pin = _where(active, xend[:, None, half - 1], cur)
    if fodd is not None and Nb % 2 == 1:
        k = (Nb - 1) // 2
        fodd[:, k:k + 1] += delta_pot_cached(system, row, pin, cur, ip,
                                             fodd[:, k:k + 1])[2]
    _win_write(paths, Nb, ip, pin)
    return paths


def staging_half_chain(system, paths, xend, ip, half: int, active, L: int,
                       start, gs, u_acc, fodd=None):
    """Staging confined to one worm half (vpi_mod.f90:1376-1491).

    start: the even window offset inside the half (a host int, shared by
    every walker, or per-walker offsets [W] with shared_windows=False); gs
    [L-1, W, D]; u_acc [W].  Returns (paths, xend, acc)."""
    base = 0 if half == 1 else system.cfg.Nb
    _pin_center(system, paths, xend, ip, half, active, fodd)
    return paths, xend, _stage(system, paths, ip, active, base + start, L,
                               gs, u_acc, fodd, base % 2)


def move_head_half_chain(system, paths, xend, ip, half: int, active,
                         Lmax: int, Ls, g0, gs, u_acc, fodd=None):
    """MoveHeadHalfChain (vpi_mod.f90:1495-1656): half 1 regrows from bead
    0, half 2 from the centre bead Nb (weight 1/2 on its dS).
    Returns (paths, xend, acc)."""
    Nb = system.cfg.Nb
    _pin_center(system, paths, xend, ip, half, active, fodd)
    seg_fin, acc = _regrow_head(system, paths, ip, active,
                                0 if half == 1 else Nb, Lmax,
                                1.0 if half == 1 else 0.5, Ls, g0, gs, u_acc,
                                fodd)
    if half == 2:
        xend[:, 1] = _where(active, seg_fin[:, 0], xend[:, 1])
    return paths, xend, acc


def move_tail_half_chain(system, paths, xend, ip, half: int, active,
                         Lmax: int, Ls, g0, gs, u_acc, fodd=None):
    """MoveTailHalfChain (vpi_mod.f90:1660-1817): half 1 regrows the centre
    bead Nb (weight 1/2), half 2 the last bead 2Nb.
    Returns (paths, xend, acc)."""
    Nb = system.cfg.Nb
    _pin_center(system, paths, xend, ip, half, active, fodd)
    seg_fin, acc = _regrow_tail(system, paths, ip, active,
                                Nb if half == 1 else 2 * Nb, Lmax,
                                0.5 if half == 1 else 1.0, Ls, g0, gs, u_acc,
                                fodd)
    if half == 1:
        xend[:, 0] = _where(active, seg_fin[:, 0], xend[:, 0])
    return paths, xend, acc
