"""Multilevel bisection moves (Bisection / MoveHeadBisection /
MoveTailBisection, vpi_mod.f90:864-1372) and their fused composites.

The torch counterpart of pathintegralgroundstate_tpu/ops/bisection.py, in
its two forms (cfg.bis_monoshot):

  monoshot (the default): the construction of all levels is a deterministic
      function of (window, gaussians), so ONE pair pass evaluates every
      displaced row and the per-level accepts factorize,
          alive = active AND_k [ u_k < exp(-sum_{rows of level k} dS) ];
      the unfused moves run the construction and the accepts with their
      write-back as one launch each around the pair pass
      (kernels.bis_propose, bis_accept) where the window start is shared,
      and with the cache where the fold kernel runs the pass on the card
      (_glue_cache), bis_accept then writing the cache back too;
  per level (bis_monoshot=False, the Fortran's own order): one pair pass
      per level on the level's midpoints, each built on the previous
      levels' beads, the accept chain cut short by the first rejection.

Every move takes `rand = (start, g_rows [W, L, D], u_acc [W, ngroups])`:
start is the window's even first bead (a host int, shared by every walker,
or with shared_windows=False per-walker starts [W] whose window is gathered
and scattered back, ops/moves._slice_beads; None for the end moves),
g_rows the gaussians by window position (the end gate takes row 0, level
ilev rows d2::delta), u_acc the accept uniforms
(column 0 the end gate, column ilev level ilev).  The reference's batched
randoms come in this layout; its per-level key draws are laid out so by
the draw source (utils/draws.py).  `paths` is updated in place.

The end moves' depth is the caller's: the reference's random depth Nlev ~
U{2..level} (vpi_mod.f90:1023; bisection.py:628-653) is a host int drawn
with the move's randoms, so each depth runs its own static body.

Exact F^2 with the cache (`fodd`, ops/moves.py): a level ilev displaces
beads 2^(nlev-ilev) (2j+1) from the window's even start, so only the LAST
level's midpoints are odd beads.  The monoshot forms pass the window's odd
rows to the one pair pass, the per-level forms only to the last level's;
every form adds the increments to the cache under the FINAL accept mask, so
a walker rejected at any level leaves it untouched (bisection.py:21-30).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import kernels
from .moves import (_cache_win_write, _codd_window, _codd_window_rev, _mi,
                    _slice_beads, _where, _win_write, _wrap_pos, bead_index,
                    metropolis_u)
from .pairwise import delta_action, delta_action_rows, delta_action_sum


@functools.lru_cache(maxsize=None)
def _dyadic_tables(level: int, dt: float):
    """The all-level bisection construction as a linear map (float64):
    y_p = c_p u_L + sum_q T[p, q] g_q over interior positions 1..L-1
    (a copy of the reference's bisection._dyadic_tables)."""
    L = 2 ** level
    T = np.zeros((L + 1, L + 1))
    c = np.zeros(L + 1)
    c[L] = 1.0
    for ilev in range(1, level + 1):
        delta = 2 ** (level - ilev + 1)
        sigma = math.sqrt(0.25 * delta * dt)
        for p in range(delta // 2, L, delta):
            prev, nxt = p - delta // 2, p + delta // 2
            T[p] = 0.5 * (T[prev] + T[nxt])
            T[p, p] += sigma
            c[p] = 0.5 * (c[prev] + c[nxt])
    return T[1:L, 1:L], c[1:L]


def _pos_level(p: int, level: int) -> int:
    """Bisection level (1-based) that displaces window position p."""
    for ilev in range(1, level + 1):
        delta = 2 ** (level - ilev + 1)
        if p % delta == delta // 2:
            return ilev
    raise ValueError(p)


@functools.lru_cache(maxsize=None)
def _level_assign(level: int, gate: bool):
    """[nrows, ngroups] 0/1 matrix of displaced window rows to accept
    groups: interior moves rows 1..L-1 into `level` groups; end moves
    (gate) rows 0..L-1 into 1 + level groups, the terminal gate first."""
    L = 2 ** level
    if gate:
        A = np.zeros((L, level + 1))
        A[0, 0] = 1.0
        for p in range(1, L):
            A[p, _pos_level(p, level)] = 1.0
    else:
        A = np.zeros((L - 1, level))
        for p in range(1, L):
            A[p - 1, _pos_level(p, level) - 1] = 1.0
    return A


def dyadic_tables(system, level: int, dtype):
    """(T [L-1, L-1], c [L-1]) of _dyadic_tables on the System's device in
    dtype, built once."""
    return (system.const(("dyadic_T", level, dtype),
                         lambda: _dyadic_tables(level, system.cfg.dt)[0],
                         dtype),
            system.const(("dyadic_c", level, dtype),
                         lambda: _dyadic_tables(level, system.cfg.dt)[1],
                         dtype))


def _construct_levels(system, seg, level: int, L: int, g_rows):
    """All levels' midpoints as one bridge matmul in displacement space
    (unwrap the far anchor, matmul, wrap once).  seg [..., L+1, D]; g_rows
    indexed by window position.  Returns a new segment."""
    T, c = dyadic_tables(system, level, seg.dtype)
    x0 = seg[..., 0, :]
    uL = -_mi(system, x0 - seg[..., L, :])
    y = (c[:, None] * uL[..., None, :]
         + torch.einsum("pq,...qd->...pd", T, g_rows[..., 1:L, :]))
    x = _wrap_pos(system, x0[..., None, :] + y)
    return torch.cat([seg[..., :1, :], x, seg[..., L:, :]], -2)


def _level_geometry(ilev: int, nlev: int):
    """(delta, m, d2) of bisection level ilev of nlev: its m midpoints sit
    at window positions d2, d2 + delta, ..."""
    delta = 2 ** (nlev - ilev + 1)
    return delta, 2 ** (ilev - 1), delta // 2


def _level_proposal(system, seg, ilev: int, nlev: int, g_rows):
    """Midpoint proposal of one level (bisection.py:78-106): (d2, delta,
    xold, xnew), xold/xnew [..., m, D].  seg [..., 2**nlev+1, D]; g_rows
    [..., L, D] by window position, level ilev taking rows d2::delta;
    sigma = sqrt(delta dt / 4) (vpi_mod.f90:905-907)."""
    L = seg.shape[-2] - 1
    delta, _, d2 = _level_geometry(ilev, nlev)
    xold = seg[..., d2::delta, :]
    xprev = xold + _mi(system, seg[..., 0:L:delta, :] - xold)
    xnext = xold - _mi(system, xold - seg[..., delta::delta, :])
    sigma = math.sqrt(0.25 * delta * system.cfg.dt)
    xnew = _wrap_pos(system, 0.5 * (xprev + xnext)
                     + sigma * g_rows[..., d2::delta, :])
    return d2, delta, xold, xnew


def _construct_levels_loop(system, seg, level: int, g_rows):
    """The literal level-by-level construction (bisection.py:185-193), the
    anchor of _construct_levels' matmul form.  Returns a new segment."""
    seg = seg.clone()
    for ilev in range(1, level + 1):
        d2, delta, _, xnew = _level_proposal(system, seg, ilev, level, g_rows)
        seg[..., d2::delta, :] = xnew
    return seg


def _monoshot_accept(system, active, rows, u_acc, level: int, gate: bool,
                     flip: bool = False):
    """Per-level accept chain from the one-pass row dS values; flip maps
    forward-ordered rows of a reversed (tail) window."""
    key = ("level_assign", level, gate, flip, rows.dtype)
    A = system.const(key, lambda: np.ascontiguousarray(
        _level_assign(level, gate)[::-1] if flip
        else _level_assign(level, gate)), rows.dtype)
    return active & metropolis_u(u_acc, rows @ A).all(-1)


def _fold_kw(fodd, f_seg, sub):
    """delta_action_rows' cache arguments, none without the cache."""
    return {} if fodd is None else dict(fold=f_seg, fold_sub=sub)


def _split(out, fodd):
    """(rows or dS, dfield or None) of a delta_action call."""
    return out if fodd is not None else (out, None)


def _glue_cache(system, paths) -> bool:
    """Whether a move carrying the exact-F^2 cache runs on the glue route:
    only where every kernel of it runs, the paths on the card, the glue
    kernels (kernels.bis_route) and the fold kernel (kernels.fold_route).
    Elsewhere (the CPU, bfloat16, the tables, the trap) the cached moves
    keep their PyTorch glue."""
    return (paths.device.type != "cpu" and kernels.bis_route(system)
            and kernels.fold_route(system))


def _bisection_monoshot(system, paths, ip: int, active, level: int, rand,
                        fodd=None):
    """Interior bisection over an even-aligned window of 2**level links,
    one pair pass for all levels.  With a shared window start, and with the
    cache only on the glue route (_glue_cache), the proposal and the
    accept with its write-back are one launch each around the pair pass
    (kernels.bis_propose, bis_accept): kernel A, or with the cache the fold
    kernel, whose field increments bis_accept adds to the cache rows under
    the window's odd beads for the accepted walkers.
    Returns (paths, alive)."""
    L = 2 ** level
    ii, g_rows, u_acc = rand
    if isinstance(ii, int) and (fodd is None or _glue_cache(system, paths)):
        seg = kernels.bis_propose(system, paths, ip, level, g_rows, ii, 1,
                                  False)
        R_seg = paths[:, ii:ii + L + 1]
        f_seg, _, k0 = _codd_window(fodd, ii, L, 0) if fodd is not None \
            else (None, None, None)
        rows, df = _split(delta_action_rows(
            system, R_seg[:, 1:L], seg[:, 1:L], R_seg[:, 1:L, ip], ip,
            bead_index(system, ii, 1, L), need_wf=False,
            **_fold_kw(fodd, f_seg, (0, 2))), fodd)
        return paths, kernels.bis_accept(system, paths, ip, level, rows,
                                         u_acc, active, seg, ii, 1, False,
                                         fodd, df, k0)
    R_seg = _slice_beads(paths, ii, L + 1)
    seg0 = R_seg[:, :, ip]
    seg = _construct_levels(system, seg0, level, L, g_rows)
    f_seg, _, k0 = _codd_window(fodd, ii, L, 0) if fodd is not None \
        else (None, None, None)
    rows, df = _split(delta_action_rows(
        system, R_seg[:, 1:L], seg[:, 1:L], seg0[:, 1:L], ip,
        bead_index(system, ii, 1, L), need_wf=False,
        **_fold_kw(fodd, f_seg, (0, 2))), fodd)
    alive = _monoshot_accept(system, active, rows, u_acc[:, 1:], level, False)
    _win_write(paths, ii, ip, _where(alive, seg, seg0))
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df, alive, k0)
    return paths, alive


def _bisection_per_level(system, paths, ip: int, active, level: int, rand,
                         fodd=None):
    """Interior bisection level by level (bisection.py:442-510): one pair
    pass per level on its midpoints, need_f2 only on the last (the only
    level on odd beads, the one that reads the cache).
    Returns (paths, alive)."""
    L = 2 ** level
    ii, g_rows, u_acc = rand
    R_seg = _slice_beads(paths, ii, L + 1)
    seg0 = R_seg[:, :, ip]
    seg, alive = seg0.clone(), active
    f_seg, _, k0 = _codd_window(fodd, ii, L, 0) if fodd is not None \
        else (None, None, None)
    for ilev in range(1, level + 1):
        d2, delta, xold, xnew = _level_proposal(system, seg, ilev, level,
                                                g_rows)
        last = ilev == level
        dS, df = _split(delta_action_sum(
            system, R_seg[:, d2::delta], xnew, xold, ip,
            bead_index(system, ii, d2, L, delta), need_wf=False,
            need_f2=last, **_fold_kw(fodd if last else None, f_seg, (0, 1))),
            fodd if last else None)
        seg[:, d2::delta] = xnew
        alive = alive & metropolis_u(u_acc[:, ilev], dS)
    _win_write(paths, ii, ip, _where(alive, seg, seg0))
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df, alive, k0)
    return paths, alive


def _end_window(system, paths, ip: int, nlev: int, tail: bool):
    """(seg0 [W, L+1, D] in head orientation, the terminal guess's partners
    [W, 1, N, D] and bead) of an end window of 2**nlev links."""
    M, L = system.M, 2 ** nlev
    if tail:
        return paths[:, M - 1 - L:, ip].flip(1), paths[:, M - 1:], M - 1
    return paths[:, :L + 1, ip], paths[:, :1], 0


def _end_level_rows(system, paths, nlev: int, ilev: int, tail: bool):
    """(partners, bead indices, rev) of level ilev's midpoints in an end
    window, rows in head orientation.  The tail's midpoints d2 + j delta sit
    at beads M-1-d2-j delta: a forward strided view read backwards."""
    M, L = system.M, 2 ** nlev
    delta, _, d2 = _level_geometry(ilev, nlev)
    if tail:
        return (paths[:, M - 1 - L + d2:M - d2:delta],
                system.arange(M - 1 - d2, M - 1 - L, -delta), True)
    return paths[:, d2:L:delta], system.arange(d2, L, delta), False


def _end_guess(system, seg0, nlev: int, g0):
    """Free-gaussian guess of the terminal bead of seg0 [..., L+1, D],
    sigma sqrt(2**nlev dt) (vpi_mod.f90:1039-1076)."""
    xold0 = seg0[..., 0, :]
    xmid = xold0 - _mi(system, xold0 - seg0[..., 2 ** nlev, :])
    return _wrap_pos(system, xmid + math.sqrt(2 ** nlev * system.cfg.dt) * g0)


def _end_proposal(system, seg0, nlev: int, g_rows):
    """All levels' proposal of an end window seg0 [..., L+1, D] (head
    orientation): the terminal guess from g row 0, then the midpoints built
    on it (_construct_levels).  Returns a new segment."""
    xnew0 = _end_guess(system, seg0, nlev, g_rows[..., 0, :])
    return _construct_levels(system, torch.cat([xnew0[..., None, :],
                                                seg0[..., 1:, :]], -2),
                             nlev, 2 ** nlev, g_rows)


def _end_write(system, paths, ip: int, nlev: int, tail: bool, seg_fin):
    """Write an end window (head orientation) back into paths."""
    if tail:
        paths[:, system.M - 1 - 2 ** nlev:, ip] = seg_fin.flip(1)
    else:
        paths[:, :2 ** nlev + 1, ip] = seg_fin


def _end_cache(system, fodd, nlev: int, tail: bool):
    """(cache rows, row of the write-back) under an end window's odd beads,
    in head orientation: beads 1, 3, .. or M-2, M-4, .. (_codd_window)."""
    L = 2 ** nlev
    if tail:
        f, _, k = _codd_window_rev(fodd, system.M - 1, L)
    else:
        f, _, k = _codd_window(fodd, 0, L)
    return f, k


def _end_bisection_monoshot(system, paths, ip: int, active, nlev: int,
                            tail: bool, rand, defer_write: bool = False,
                            fodd=None):
    """End-segment bisection: the free-gaussian terminal guess (g row 0,
    accept group 0) and all levels in one pair pass.  The tail's partner
    block is read in FORWARD bead order; only the moved particle's small
    segment is reversed.  Returns (paths, alive), or (the window as it
    would be written, alive) with defer_write.  Without it, and with the
    cache only on the glue route (_glue_cache), the proposal and the
    accept with its write-back are one launch each around the pair pass
    (kernels.bis_propose, bis_accept; the tail's window built and its rows
    taken in forward bead order, so its cache rows under beads M-L, M-L+2,
    .., M-2 are a forward view, _codd_window, that bis_accept writes back
    in place with the accepted walkers' increments).  Off that route the
    cached tail's rows are taken in head orientation (a reversed read), as
    the reference takes them on its cache path (bisection.py:363-372)."""
    M = system.M
    L = 2 ** nlev
    _, g_rows, u_acc = rand
    if not defer_write and (fodd is None or _glue_cache(system, paths)):
        b0, step, r0 = (M - 1, -1, M - L) if tail else (0, 1, 0)
        seg = kernels.bis_propose(system, paths, ip, nlev, g_rows, b0, step,
                                  True)
        f_seg, sub, k0 = _codd_window(fodd, r0, L) if fodd is not None \
            else (None, None, None)
        rows, df = _split(delta_action_rows(
            system, paths[:, r0:r0 + L], seg[:, 1:] if tail else seg[:, :L],
            paths[:, r0:r0 + L, ip], ip, system.arange(r0, r0 + L),
            **_fold_kw(fodd, f_seg, sub)), fodd)
        return paths, kernels.bis_accept(system, paths, ip, nlev, rows,
                                         u_acc, active, seg, b0, step, True,
                                         fodd, df, k0)
    seg0, _, _ = _end_window(system, paths, ip, nlev, tail)
    seg = _end_proposal(system, seg0, nlev, g_rows)
    if fodd is not None:
        f_seg, k = _end_cache(system, fodd, nlev, tail)
        rows, df = delta_action_rows(
            system, paths[:, M - L:] if tail else paths[:, :L], seg[:, :L],
            seg0[:, :L], ip, system.arange(M - 1, M - 1 - L, -1) if tail
            else system.arange(L), rev=tail, fold=f_seg, fold_sub=(1, 2))
        alive = _monoshot_accept(system, active, rows, u_acc, nlev, True)
        _end_write(system, paths, ip, nlev, tail, _where(alive, seg, seg0))
        _cache_win_write(fodd, f_seg, df, alive, k, reverse=tail)
        return paths, alive
    if tail:
        # forward row r (beads M-L..M-1) <-> reversed-segment row L-r
        rows = delta_action_rows(system, paths[:, M - L:], seg[:, :L].flip(1),
                                 seg0[:, :L].flip(1), ip,
                                 system.arange(M - L, M))
    else:
        rows = delta_action_rows(system, paths[:, :L], seg[:, :L],
                                 seg0[:, :L], ip, system.arange(L))
    alive = _monoshot_accept(system, active, rows, u_acc, nlev, True,
                             flip=tail)
    return _where(alive, seg, seg0), alive


def _end_bisection_per_level(system, paths, ip: int, active, nlev: int,
                             tail: bool, rand, dense_gate: bool, fodd=None):
    """MoveHead/TailBisection level by level (bisection.py:529-625).

    The terminal guess has its own gate: through the dense delta_action
    (kernels 3 and 4, one launch; under exact F^2 the brute dense form)
    with dense_gate and no cache, the reference's form without batched
    randoms, else through delta_action_sum without forces (kernel A).
    Then one pass per level, need_f2 only on the last, which alone reads
    the cache.  Returns (paths, alive)."""
    _, g_rows, u_acc = rand
    seg0, R0, b0 = _end_window(system, paths, ip, nlev, tail)
    xold0 = seg0[:, 0]
    xnew0 = _end_guess(system, seg0, nlev, g_rows[:, 0])
    ib0 = system.arange(b0, b0 + 1)
    f_seg, k = _end_cache(system, fodd, nlev, tail) if fodd is not None \
        else (None, None)
    if dense_gate and fodd is None:
        dS0 = delta_action(system, R0, xnew0[:, None], xold0[:, None], ip,
                           ib0)[:, 0]
    else:
        dS0 = delta_action_sum(system, R0, xnew0[:, None], xold0[:, None],
                               ip, ib0, need_f2=False)
    alive = active & metropolis_u(u_acc[:, 0], dS0)
    seg = seg0.clone()
    seg[:, 0] = xnew0
    for ilev in range(1, nlev + 1):
        d2, delta, xold, xnew = _level_proposal(system, seg, ilev, nlev,
                                                g_rows)
        R, ib, rev = _end_level_rows(system, paths, nlev, ilev, tail)
        last = ilev == nlev
        dS, df = _split(delta_action_sum(
            system, R, xnew, xold, ip, ib, need_wf=False, need_f2=last,
            rev=rev, **_fold_kw(fodd if last else None, f_seg, (0, 1))),
            fodd if last else None)
        seg[:, d2::delta] = xnew
        alive = alive & metropolis_u(u_acc[:, ilev], dS)
    _end_write(system, paths, ip, nlev, tail, _where(alive, seg, seg0))
    if fodd is not None:
        _cache_win_write(fodd, f_seg, df, alive, k, reverse=tail)
    return paths, alive


def bisection(system, paths, ip: int, active, level: int, rand, fodd=None):
    """Interior multilevel bisection, in the form cfg.bis_monoshot names;
    fodd: the odd-bead force-field cache (exact F^2), updated in place."""
    fn = (_bisection_monoshot if system.cfg.bis_monoshot
          else _bisection_per_level)
    return fn(system, paths, ip, active, level, rand, fodd)


def _end_bisection(system, paths, ip: int, active, level: int, tail: bool,
                   rand, dense_gate: bool, fodd=None):
    nlev = max(level, 2)
    if system.cfg.bis_monoshot:
        return _end_bisection_monoshot(system, paths, ip, active, nlev, tail,
                                       rand, fodd=fodd)
    return _end_bisection_per_level(system, paths, ip, active, nlev, tail,
                                    rand, dense_gate, fodd)


def move_head_bisection(system, paths, ip: int, active, level: int, rand,
                        dense_gate: bool = False, fodd=None):
    """Head-end bisection at the depth max(level, 2); dense_gate: the
    per-level form's gate through the dense delta_action (the reference's
    form without batched randoms and without the cache); fodd: the
    odd-bead cache."""
    return _end_bisection(system, paths, ip, active, level, False, rand,
                          dense_gate, fodd)


def move_tail_bisection(system, paths, ip: int, active, level: int, rand,
                        dense_gate: bool = False, fodd=None):
    """Tail-end bisection at the depth max(level, 2) (see
    move_head_bisection)."""
    return _end_bisection(system, paths, ip, active, level, True, rand,
                          dense_gate, fodd)


def paired_end_bisections(system, paths, ip: int, active, level: int,
                          rand_h, rand_t):
    """Head + tail monoshot end bisections of one particle from the SAME
    input paths, both written back afterwards (bisection.py:394-420): the
    same outcome as the sequential order, as the windows are disjoint and
    non-adjacent (the caller's 2**(level+1) < M-1).
    Returns (paths, acc_h, acc_t)."""
    nlev = max(level, 2)
    fin_h, acc_h = _end_bisection_monoshot(system, paths, ip, active, nlev,
                                           False, rand_h, defer_write=True)
    fin_t, acc_t = _end_bisection_monoshot(system, paths, ip, active, nlev,
                                           True, rand_t, defer_write=True)
    _end_write(system, paths, ip, nlev, False, fin_h)
    _end_write(system, paths, ip, nlev, True, fin_t)
    return paths, acc_h, acc_t


# ---------------------------------------------------------------------------
# Fused composites (fused_sweep=True), monoshot form
#
# Two single-particle window moves whose displaced beads share no action
# term (different particles at different beads; the same particle at
# disjoint, non-adjacent beads) form one product kernel: both proposals
# are made from the same paths and accepted independently.  The caller
# guarantees the geometry (Sweeper: 2 * 2**level < M - 1, K slots of
# 2**level links within M - 1 links).
# ---------------------------------------------------------------------------

def _fused_ends_monoshot(system, paths, ip: int, active, level: int, rand,
                         fodd=None):
    """The head+tail composite in monoshot form (bisection.py:680-759): one
    batched construction of both segments, one pair pass per window (the
    tail read backwards in place), per-level accepts."""
    M = system.M
    L = 2 ** level
    _, g2, u2 = rand
    R_head = paths[:, :L + 1]
    R_tail = paths[:, M - 1 - L:]                         # forward order
    seg0 = torch.stack([R_head[:, :, ip], R_tail[:, :, ip].flip(1)], 1)
    seg = _end_proposal(system, seg0, level, g2)
    caches = [_end_cache(system, fodd, level, t) if fodd is not None
              else (None, None) for t in (False, True)]
    rows_h, df_h = _split(delta_action_rows(
        system, R_head[:, :L], seg[:, 0, :L], seg0[:, 0, :L], ip,
        system.arange(L), **_fold_kw(fodd, caches[0][0], (1, 2))), fodd)
    # tail row b (head orientation, bead M-1-b) pairs with forward row L-1-b
    rows_t, df_t = _split(delta_action_rows(
        system, R_tail[:, 1:], seg[:, 1, :L], seg0[:, 1, :L], ip,
        system.arange(M - 1, M - 1 - L, -1), rev=True,
        **_fold_kw(fodd, caches[1][0], (1, 2))), fodd)
    acc_h = _monoshot_accept(system, active, rows_h, u2[:, 0], level, True)
    acc_t = _monoshot_accept(system, active, rows_t, u2[:, 1], level, True)
    fin = torch.where(torch.stack([acc_h, acc_t], 1)[:, :, None, None], seg,
                      seg0)
    R_head[:, :, ip] = fin[:, 0]
    R_tail[:, :, ip] = fin[:, 1].flip(1)
    if fodd is not None:
        _cache_win_write(fodd, caches[0][0], df_h, acc_h, caches[0][1])
        _cache_win_write(fodd, caches[1][0], df_t, acc_t, caches[1][1],
                         reverse=True)
    return paths, acc_h, acc_t


def _multi_cache(fodd, s: int, span: int):
    """The cache rows under a composite span's odd beads s+1, s+3, ..,
    s+span-1 (s even): one contiguous block, slot-major."""
    return fodd[:, s // 2:(s + span) // 2]


def _multi_write(fodd, f_big, dfield, alive, s: int, L: int):
    """Slot k's L/2 increments gated by its own final accept
    (bisection.py:954-960)."""
    gate = alive.repeat_interleave(L // 2, dim=1)[:, :, None, None]
    fodd[:, s // 2:s // 2 + f_big.shape[1]] = f_big + torch.where(
        gate, dfield, 0.0)


def _bisection_multi_monoshot(system, paths, ips, active, level: int,
                              rand, fodd=None):
    """The K-slot interior composite in monoshot form (bisection.py:891-960).

    ONE pair pass covers every slot: kernel A reads the contiguous span
    beads s+1 .. s+KL-1 in place with a per-row particle index.  The K-1
    slot-boundary rows inside the span are not displaced (new == old, so
    their dS is exactly 0) and are dropped before the accepts."""
    W, D = paths.shape[0], system.cfg.dim
    L, K = 2 ** level, len(ips)
    span = K * L
    s, gK, uK = rand
    R_big = paths[:, s:s + span + 1]
    seg0 = torch.stack([R_big[:, k * L:(k + 1) * L + 1, p]
                        for k, p in enumerate(ips)], 1)   # [W, K, L+1, D]
    seg = _construct_levels(system, seg0, level, L, gK)
    # span rows 1..KL-1; a slot's row 0 is its (unmoved) boundary bead
    xnew = seg[:, :, :L].reshape(W, span, D)[:, 1:]
    xold = seg0[:, :, :L].reshape(W, span, D)[:, 1:]
    f_big = _multi_cache(fodd, s, span) if fodd is not None else None
    # the span rows' odd beads are its rows 0::2
    rows, df = _split(delta_action_rows(
        system, R_big[:, 1:span], xnew, xold,
        _ip_rows(ips, L, paths.device)[:, 1:],
        system.arange(s + 1, s + span), need_wf=False,
        **_fold_kw(fodd, f_big, (0, 2))), fodd)
    rows = torch.nn.functional.pad(rows, (1, 0)).view(W, K, L)[:, :, 1:]
    alive = _monoshot_accept(system, active, rows, uK[:, :, 1:], level, False)
    fin = torch.where(alive[:, :, None, None], seg, seg0)
    for k, p in enumerate(ips):
        R_big[:, k * L + 1:(k + 1) * L, p] = fin[:, k, 1:L]
    if fodd is not None:
        _multi_write(fodd, f_big, df, alive, s, L)
    return paths, alive


def _ip_rows(ips, m: int, device):
    """[1, K m] long: particle ips[k] for rows k m .. (k+1) m - 1."""
    return torch.cat([torch.full((m,), p, dtype=torch.long, device=device)
                      for p in ips])[None]


def _fused_ends_per_level(system, paths, ip: int, active, level: int, rand,
                          fodd=None):
    """The head+tail composite level by level (bisection.py:778-888): one
    gate pass over beads 0 and M-1 together, then per level one pass per
    window (the tail's forward strided midpoints read backwards), 1 + 2
    level launches of kernel A."""
    M = system.M
    L = 2 ** level
    _, g2, u2 = rand
    seg0 = torch.stack([paths[:, :L + 1, ip],
                        paths[:, M - 1 - L:, ip].flip(1)], 1)  # [W,2,L+1,D]
    xold0 = seg0[:, :, 0]
    xnew0 = _end_guess(system, seg0, level, g2[:, :, 0])
    # beads 0 and M-1 as one strided view; even, so no force pass
    dS0 = delta_action_rows(system, paths[:, ::M - 1], xnew0, xold0, ip,
                            system.arange(0, M, M - 1), need_f2=False)
    alive = active[:, None] & metropolis_u(u2[:, :, 0], dS0)
    seg = seg0.clone()
    seg[:, :, 0] = xnew0
    caches = [_end_cache(system, fodd, level, t) if fodd is not None
              else (None, None) for t in (False, True)]
    dfs = [None, None]
    for ilev in range(1, level + 1):
        d2, delta, xold, xnew = _level_proposal(system, seg, ilev, level, g2)
        last = ilev == level
        dS = []
        for e, tail in enumerate((False, True)):
            R, ib, rev = _end_level_rows(system, paths, level, ilev, tail)
            f = fodd if last else None
            d, dfs[e] = _split(delta_action_sum(
                system, R, xnew[:, e], xold[:, e], ip, ib, need_wf=False,
                need_f2=last, rev=rev, **_fold_kw(f, caches[e][0], (0, 1))),
                f)
            dS.append(d)
        seg[:, :, d2::delta] = xnew
        alive = alive & metropolis_u(u2[:, :, ilev], torch.stack(dS, 1))
    fin = torch.where(alive[:, :, None, None], seg, seg0)
    _end_write(system, paths, ip, level, False, fin[:, 0])
    _end_write(system, paths, ip, level, True, fin[:, 1])
    if fodd is not None:
        for e in (0, 1):
            _cache_win_write(fodd, caches[e][0], dfs[e], alive[:, e],
                             caches[e][1], reverse=e == 1)
    return paths, alive[:, 0], alive[:, 1]


def _bisection_multi_per_level(system, paths, ips, active, level: int,
                               rand, fodd=None):
    """The K-slot interior composite level by level (bisection.py:985-1077).
    Level ilev's K m midpoints sit at beads s + d2 + j delta over the whole
    span, one arithmetic sequence: one kernel-A pass per level over that
    strided view, with a per-row particle index [1, K m]."""
    W, D = paths.shape[0], system.cfg.dim
    L, K = 2 ** level, len(ips)
    span = K * L
    s, gK, uK = rand
    R_big = paths[:, s:s + span + 1]
    seg0 = torch.stack([R_big[:, k * L:(k + 1) * L + 1, p]
                        for k, p in enumerate(ips)], 1)   # [W, K, L+1, D]
    seg, alive = seg0.clone(), active
    f_big = _multi_cache(fodd, s, span) if fodd is not None else None
    for ilev in range(1, level + 1):
        d2, delta, xold, xnew = _level_proposal(system, seg, ilev, level, gK)
        m = L // delta
        last = ilev == level
        f = fodd if last else None
        rows, d = _split(delta_action_rows(
            system, R_big[:, d2:span:delta], xnew.reshape(W, K * m, D),
            xold.reshape(W, K * m, D), _ip_rows(ips, m, paths.device),
            system.arange(s + d2, s + span, delta), need_wf=False,
            need_f2=last, **_fold_kw(f, f_big, (0, 1))), f)
        df = d if last else None
        seg[:, :, d2::delta] = xnew
        alive = alive & metropolis_u(uK[:, :, ilev],
                                     rows.view(W, K, m).sum(-1))
    fin = torch.where(alive[:, :, None, None], seg, seg0)
    for k, p in enumerate(ips):
        R_big[:, k * L + 1:(k + 1) * L, p] = fin[:, k, 1:L]
    if fodd is not None:
        _multi_write(fodd, f_big, df, alive, s, L)
    return paths, alive


def fused_end_bisections(system, paths, ip: int, active, level: int, rand,
                         fodd=None):
    """MoveHeadBisection + MoveTailBisection of particle ip as one
    composite, in the form cfg.bis_monoshot names.  rand = (None, g2
    [W, 2, L, D], u2 [W, 2, level+1]); fodd: the odd-bead cache.
    Returns (paths, acc_head[W], acc_tail[W])."""
    fn = (_fused_ends_monoshot if system.cfg.bis_monoshot
          else _fused_ends_per_level)
    return fn(system, paths, ip, active, level, rand, fodd)


def bisection_multi(system, paths, ips, active, level: int, rand,
                    fodd=None):
    """Interior bisections of the K distinct particles ips as one composite
    (bisection.py:963-1077), in the form cfg.bis_monoshot names.  Slot k
    regrows the window of L = 2**level links from bead s + k L, one even
    shift s for every slot.  rand = (s host int, gK [W, K, L, D], uK [W, K,
    level+1]); active [W] or [W, K]; fodd: the odd-bead cache.
    Returns (paths, acc[W, K])."""
    W, K, L = paths.shape[0], len(ips), 2 ** level
    if K * L > system.M - 1:
        raise ValueError(f"K={K} slots of {L} links exceed {system.M - 1} "
                         "links")
    if active.dim() == 1:
        active = active[:, None].expand(W, K)
    fn = (_bisection_multi_monoshot if system.cfg.bis_monoshot
          else _bisection_multi_per_level)
    return fn(system, paths, ips, active, level, rand, fodd)
