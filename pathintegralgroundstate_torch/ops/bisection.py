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

def fused_end_bisections(system, paths, ip: int, active, level: int, rand):
    """MoveHeadBisection + MoveTailBisection of particle ip as one
    composite (_fused_ends_monoshot, bisection.py:680-759): one batched
    construction of both segments, one pair pass per window (the tail read
    backwards in place), per-level accepts.  rand = (None, g2 [W, 2, L, D],
    u2 [W, 2, level+1]).  Returns (paths, acc_head[W], acc_tail[W])."""
    M = system.M
    L = 2 ** level
    _, g2, u2 = rand
    R_head = paths[:, :L + 1]
    R_tail = paths[:, M - 1 - L:]                         # forward order
    seg0 = torch.stack([R_head[:, :, ip], R_tail[:, :, ip].flip(1)], 1)
    xold0 = seg0[:, :, 0]
    xmid = xold0 - _mi(system, xold0 - seg0[:, :, L])
    xnew0 = _wrap_pos(system, xmid + math.sqrt(L * system.cfg.dt)
                      * g2[:, :, 0])
    seg = _construct_levels(system, torch.cat([xnew0[:, :, None],
                                               seg0[:, :, 1:]], 2),
                            level, L, g2)
    rows_h = delta_action_rows(system, R_head[:, :L], seg[:, 0, :L],
                               seg0[:, 0, :L], ip, system.arange(L))
    # tail row b (head orientation, bead M-1-b) pairs with forward row L-1-b
    rows_t = delta_action_rows(system, R_tail[:, 1:], seg[:, 1, :L],
                               seg0[:, 1, :L], ip,
                               system.arange(M - 1, M - 1 - L, -1), rev=True)
    acc_h = _monoshot_accept(system, active, rows_h, u2[:, 0], level, True)
    acc_t = _monoshot_accept(system, active, rows_t, u2[:, 1], level, True)
    fin = torch.where(torch.stack([acc_h, acc_t], 1)[:, :, None, None], seg,
                      seg0)
    R_head[:, :, ip] = fin[:, 0]
    R_tail[:, :, ip] = fin[:, 1].flip(1)
    return paths, acc_h, acc_t


def bisection_multi(system, paths, ips, active, level: int, rand):
    """Interior bisections of the K distinct particles ips as one composite
    (_bisection_multi_monoshot, bisection.py:891-960).  Slot k regrows the
    window of L = 2**level links from bead s + k L, one even shift s for
    every slot.  rand = (u_shift host float, gK [W, K, L, D], uK [W, K,
    level+1]); active [W] or [W, K].

    ONE pair pass covers every slot: kernel A reads the contiguous span
    beads s+1 .. s+KL-1 in place with a per-row particle index.  The K-1
    slot-boundary rows inside the span are not displaced (new == old, so
    their dS is exactly 0) and are dropped before the accepts.
    Returns (paths, acc[W, K])."""
    M = system.M
    W, D = paths.shape[0], system.cfg.dim
    L, K = 2 ** level, len(ips)
    span = K * L
    if span > M - 1:
        raise ValueError(f"K={K} slots of {L} links exceed {M - 1} links")
    if active.dim() == 1:
        active = active[:, None].expand(W, K)
    u_shift, gK, uK = rand
    s = 2 * math.floor(u_shift * ((M - 1 - span) // 2 + 1))
    R_big = paths[:, s:s + span + 1]
    seg0 = torch.stack([R_big[:, k * L:(k + 1) * L + 1, p]
                        for k, p in enumerate(ips)], 1)   # [W, K, L+1, D]
    seg = _construct_levels(system, seg0, level, L, gK)
    # span rows 1..KL-1; a slot's row 0 is its (unmoved) boundary bead
    xnew = seg[:, :, :L].reshape(W, span, D)[:, 1:]
    xold = seg0[:, :, :L].reshape(W, span, D)[:, 1:]
    ip_rows = torch.cat([torch.full((L,), p, dtype=torch.long,
                                    device=paths.device) for p in ips])
    rows = delta_action_rows(system, R_big[:, 1:span], xnew, xold,
                             ip_rows[None, 1:], system.arange(s + 1, s + span),
                             need_wf=False)
    rows = torch.nn.functional.pad(rows, (1, 0)).view(W, K, L)[:, :, 1:]
    alive = _monoshot_accept(system, active, rows, uK[:, :, 1:], level, False)
    fin = torch.where(alive[:, :, None, None], seg, seg0)
    for k, p in enumerate(ips):
        R_big[:, k * L + 1:(k + 1) * L, p] = fin[:, k, 1:L]
    return paths, alive
