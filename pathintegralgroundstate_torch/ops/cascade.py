"""Whole-move cascade composites: one kernel per composite update.

The torch counterpart of pathintegralgroundstate_tpu/ops/cascade_kernels.py
(`cfg.cascade=True`).  A cascade runs a whole move in one call: for the
ends, the free-gaussian end guess and its gate; then nlev bisection levels,
each proposing its midpoints from the window as the previous levels left
it and gating on the level's summed dS; then the revert of every slot that
failed a gate.  Unlike the monoshot composites (ops/bisection.py) the
levels are built one after the other with a wrap per level, as the
reference's cascade_jnp builds them.

Every slot is a window of L+1 beads of one particle, read in place from
`paths`: slot (bead0, dir, ip) holds beads bead0 + dir * p, p = 0..L, of
particle ip, so the tail window is head-oriented (bead0 = M-1, dir = -1).
Accepted slots are written back into `paths` in place (ends and rigid: rows
0..L, interior: rows 1..L-1).  The randoms come in pre-drawn, position-
indexed as the reference draws them: rg [W, S, L+1, D] (rigid: the
displacement in row 0), ru [W, S, G].

Modes (all slots independent factors of one product kernel, see
ops/bisection.py):
  ends      head + tail bisection cascades of one particle (S = 2)
  interior  K disjoint interior windows of K distinct particles (S = K)
  rigid     the whole-chain rigid translation of one particle (S = 1,
            L = M-1, one gate)

Routing (`_dispatch`, as cascade_kernels._dispatch does): 'ends' and
'interior' go to kernels.cascade, which runs kernel 5 (csrc/cascade.cu)
under PBC and cascade_ref under the trap and under exact F^2
(kernels.cascade_route, as use_cascade_kernel excludes exact_f2); 'rigid'
NEVER reaches the kernel.  Under exact F^2 every pass of cascade_ref takes
the brute whole-configuration F^2 (pairwise.delta_action_sum), as
cascade_jnp's delta_action_rows calls do.  In the reference the rigid body
exceeds the TPU's scoped memory, and its jnp twin already runs its pair
work on the rows kernel; the port routes it the same way, the plain form
whose pair pass is kernel A.  That is the reference's routing, not a fallback.
"""

from __future__ import annotations

import torch

from . import kernels
from .moves import _mi, _where, _wrap_pos, metropolis_u
from .pairwise import chin_table, delta_action_sum


def cascade_ref(system, mode: str, paths, slots, rg, ru, act, nlev: int,
                pair_rows=kernels.pair_rows):
    """Plain form of kernel 5 (cascade_jnp, cascade_kernels.py:337-421).

    slots: S host tuples (bead0, dir, ip); act [W, S] bool.  Writes the
    accepted windows into paths; returns acc [W, S] bool.  Its pair passes
    run pair_rows: kernel A (kernels.pair_rows, which also weights and sums
    the rows), or kernels.pair_rows_ref for a reference on the card that
    launches no kernel."""
    M, dt = system.M, system.cfg.dt
    dtype = paths.dtype
    tab = chin_table(system, dtype)
    L = M - 1 if mode == "rigid" else 2 ** nlev
    accs, writes = [], []
    for s, (b0, step, ip) in enumerate(slots):
        rev = step < 0
        Rf = paths[:, b0 - L:b0 + 1] if rev else paths[:, b0:b0 + L + 1]

        def dS_of(start, stop, stride, xnew, xold, need_wf):
            """Summed dS of the rows at head positions start:stop:stride."""
            if rev:   # head position p is forward row L - p
                last = start + (len(range(start, stop, stride)) - 1) * stride
                R = Rf[:, L - last:L - start + 1:stride]
            else:
                R = Rf[:, start:stop:stride]
            ib = system.arange(b0 + step * start, b0 + step * stop,
                               step * stride)
            if system.cfg.exact_f2:
                return delta_action_sum(system, R, xnew, xold, ip, ib,
                                        need_wf, rev=rev)
            return pair_rows(system, R, xnew, xold, ip, tab, ib, need_wf,
                             True, rev, reduce=True)

        seg0 = Rf[:, :, ip].flip(1) if rev else Rf[:, :, ip]
        seg = seg0.clone()
        alive = act[:, s]
        if mode == "rigid":
            seg = _wrap_pos(system, seg0 + rg[:, s, 0:1])
            dS = dS_of(0, L + 1, 1, seg, seg0, True)
            alive = alive & metropolis_u(ru[:, s, 0], dS)
        else:
            gate = 0
            if mode == "ends":
                x0 = seg0[:, 0]
                xmid = x0 - _mi(system, x0 - seg0[:, L])
                sig = torch.tensor(L * dt, dtype=dtype).sqrt()
                xn0 = _wrap_pos(system, xmid + sig * rg[:, s, 0])
                dS0 = dS_of(0, 1, 1, xn0[:, None], x0[:, None], True)
                alive = alive & metropolis_u(ru[:, s, 0], dS0)
                seg[:, 0] = xn0
                gate = 1
            for ilev in range(1, nlev + 1):
                delta = 2 ** (nlev - ilev + 1)
                d2 = delta // 2
                sigma = torch.tensor(0.25 * delta * dt, dtype=dtype).sqrt()
                xold = seg[:, d2::delta]
                xp = xold + _mi(system, seg[:, 0:L:delta] - xold)
                xn = xold - _mi(system, xold - seg[:, delta::delta])
                xnew = _wrap_pos(system, 0.5 * (xp + xn)
                                 + sigma * rg[:, s, d2::delta])
                dS = dS_of(d2, L, delta, xnew, xold, False)
                alive = alive & metropolis_u(ru[:, s, gate + ilev - 1], dS)
                seg[:, d2::delta] = xnew
        accs.append(alive)
        writes.append((Rf, ip, rev, _where(alive, seg, seg0)))
    lo, hi = (1, L) if mode == "interior" else (0, L + 1)
    for Rf, ip, rev, fin in writes:
        if rev:
            Rf[:, L + 1 - hi:L + 1 - lo, ip] = fin[:, lo:hi].flip(1)
        else:
            Rf[:, lo:hi, ip] = fin[:, lo:hi]
    return torch.stack(accs, 1)


def _dispatch(system, mode, paths, slots, rg, ru, act, nlev):
    """cascade_kernels._dispatch: the dyadic cascades through
    kernels.cascade (kernel 5 under PBC, cascade_ref under the trap),
    'rigid' the plain form (whose pair pass is kernel A under PBC)."""
    if mode != "rigid":
        return kernels.cascade(system, mode, paths, slots, rg, ru, act, nlev)
    return cascade_ref(system, mode, paths, slots, rg, ru, act, nlev)


def fused_ends_cascade(system, paths, ip: int, active, nlev: int, rg, ru):
    """MoveHeadBisection + MoveTailBisection of particle ip as ONE cascade
    (cascade_kernels.py:448-470).  rg [W, 2, L+1, D], ru [W, 2, nlev+1].
    Returns (paths, acc_head[W], acc_tail[W])."""
    W, M = paths.shape[0], system.M
    acc = _dispatch(system, "ends", paths, [(0, 1, ip), (M - 1, -1, ip)],
                    rg, ru, active[:, None].expand(W, 2), nlev)
    return paths, acc[:, 0], acc[:, 1]


def interior_cascade(system, paths, ips, active, nlev: int, shift: int, rg,
                     ru):
    """K disjoint interior bisection windows of the K distinct particles
    ips as ONE cascade (cascade_kernels.py:473-506): slot k starts at bead
    shift + k L (shift: the host int the reference draws).  active [W] or
    [W, K]; rg [W, K, L+1, D], ru [W, K, nlev].  Returns (paths, acc[W, K])."""
    W, L, K = paths.shape[0], 2 ** nlev, len(ips)
    if K * L > system.M - 1:
        raise ValueError(f"K={K} slots of {L} links exceed {system.M - 1}")
    act = active[:, None].expand(W, K) if active.dim() == 1 else active
    slots = [(shift + k * L, 1, ip) for k, ip in enumerate(ips)]
    return paths, _dispatch(system, "interior", paths, slots, rg, ru, act,
                            nlev)


def rigid_cascade(system, paths, ip: int, active, delta, u_dx, u_acc):
    """Rigid whole-chain translation of particle ip as a cascade
    (cascade_kernels.py:509-527).  u_dx [W, 1, D], u_acc [W]: the uniforms
    of the displacement and the gate.  Returns (paths, acc[W])."""
    dx = delta * (2.0 * u_dx - 1.0)
    acc = _dispatch(system, "rigid", paths, [(0, 1, ip)], dx[:, :, None],
                    u_acc[:, None, None], active[:, None], 0)
    return paths, acc[:, 0]
