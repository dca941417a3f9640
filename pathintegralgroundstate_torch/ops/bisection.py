"""Multilevel bisection moves in monoshot form (Bisection /
MoveHeadBisection / MoveTailBisection, vpi_mod.f90:864-1372).

The torch counterpart of the monoshot path of
pathintegralgroundstate_tpu/ops/bisection.py: the construction of all
levels is a deterministic function of (window, gaussians), so ONE pair pass
evaluates every displaced row and the per-level accepts factorize:

    alive = active AND_k [ u_k < exp(-sum_{rows of level k} dS) ].

Every move takes `rand = (u_start, g_rows [W, L, D], u_acc [W, ngroups])`,
the blocks the reference's batched-randoms path draws (sweep.py:428-447);
u_start is a host float (shared window start), None for the end moves.
`paths` is updated in place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .moves import _mi, _where, _wrap_pos, metropolis_u
from .pairwise import delta_action_rows


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


def _construct_levels(system, seg, level: int, L: int, g_rows):
    """All levels' midpoints as one bridge matmul in displacement space
    (unwrap the far anchor, matmul, wrap once).  seg [..., L+1, D]; g_rows
    indexed by window position.  Returns a new segment."""
    dtype = seg.dtype
    T = system.const(("dyadic_T", level, dtype),
                     lambda: _dyadic_tables(level, system.cfg.dt)[0], dtype)
    c = system.const(("dyadic_c", level, dtype),
                     lambda: _dyadic_tables(level, system.cfg.dt)[1], dtype)
    x0 = seg[..., 0, :]
    uL = -_mi(system, x0 - seg[..., L, :])
    y = (c[:, None] * uL[..., None, :]
         + torch.einsum("pq,...qd->...pd", T, g_rows[..., 1:L, :]))
    x = _wrap_pos(system, x0[..., None, :] + y)
    return torch.cat([seg[..., :1, :], x, seg[..., L:, :]], -2)


def _monoshot_accept(system, active, rows, u_acc, level: int, gate: bool,
                     flip: bool = False):
    """Per-level accept chain from the one-pass row dS values; flip maps
    forward-ordered rows of a reversed (tail) window."""
    key = ("level_assign", level, gate, flip, rows.dtype)
    A = system.const(key, lambda: np.ascontiguousarray(
        _level_assign(level, gate)[::-1] if flip
        else _level_assign(level, gate)), rows.dtype)
    return active & metropolis_u(u_acc, rows @ A).all(-1)


def _bisection_monoshot(system, paths, ip: int, active, level: int, rand):
    """Interior bisection over an even-aligned window of 2**level links,
    one pair pass for all levels.  Returns (paths, alive)."""
    M = system.M
    L = 2 ** level
    u_start, g_rows, u_acc = rand
    ii = 2 * math.floor(u_start * ((M - 1 - L) // 2 + 1))
    R_seg = paths[:, ii:ii + L + 1]
    seg0 = R_seg[:, :, ip]
    seg = _construct_levels(system, seg0, level, L, g_rows)
    rows = delta_action_rows(system, R_seg[:, 1:L], seg[:, 1:L],
                             seg0[:, 1:L], ip, system.arange(ii + 1, ii + L),
                             need_wf=False)
    alive = _monoshot_accept(system, active, rows, u_acc[:, 1:], level, False)
    R_seg[:, :, ip] = _where(alive, seg, seg0)
    return paths, alive


def _end_bisection_monoshot(system, paths, ip: int, active, nlev: int,
                            tail: bool, rand):
    """End-segment bisection: the free-gaussian terminal guess (g row 0,
    accept group 0) and all levels in one pair pass.  The tail's partner
    block is read in FORWARD bead order; only the moved particle's small
    segment is reversed.  Returns (paths, alive)."""
    M = system.M
    dt = system.cfg.dt
    L = 2 ** nlev
    _, g_rows, u_acc = rand
    if tail:
        R_fwd = paths[:, M - 1 - L:]
        seg0 = R_fwd[:, :, ip].flip(1)
    else:
        R_fwd = paths[:, :L + 1]
        seg0 = R_fwd[:, :, ip]
    xold0 = seg0[:, 0]
    xmid = xold0 - _mi(system, xold0 - seg0[:, L])
    xnew0 = _wrap_pos(system, xmid + math.sqrt(L * dt) * g_rows[:, 0])
    seg = _construct_levels(system, torch.cat([xnew0[:, None], seg0[:, 1:]],
                                              1), nlev, L, g_rows)
    if tail:
        # forward row r (beads M-L..M-1) <-> reversed-segment row L-r
        rows = delta_action_rows(system, R_fwd[:, 1:], seg[:, :L].flip(1),
                                 seg0[:, :L].flip(1), ip,
                                 system.arange(M - L, M))
    else:
        rows = delta_action_rows(system, R_fwd[:, :L], seg[:, :L],
                                 seg0[:, :L], ip, system.arange(L))
    alive = _monoshot_accept(system, active, rows, u_acc, nlev, True,
                             flip=tail)
    seg_fin = _where(alive, seg, seg0)
    R_fwd[:, :, ip] = seg_fin.flip(1) if tail else seg_fin
    return paths, alive


def bisection(system, paths, ip: int, active, level: int, rand):
    """Interior multilevel bisection (monoshot)."""
    return _bisection_monoshot(system, paths, ip, active, level, rand)


def move_head_bisection(system, paths, ip: int, active, level: int, rand):
    """Head-end bisection at the clamped depth max(level, 2)."""
    return _end_bisection_monoshot(system, paths, ip, active, max(level, 2),
                                   False, rand)


def move_tail_bisection(system, paths, ip: int, active, level: int, rand):
    """Tail-end bisection at the clamped depth max(level, 2)."""
    return _end_bisection_monoshot(system, paths, ip, active, max(level, 2),
                                   True, rand)
