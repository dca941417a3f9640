"""The plain reference of the window moves that the timed path runs
(vpi_mod.f90), each worked out again from the positions before the move
and the move's own random numbers:

  cm         TranslateChain: particle ip's whole worldline displaced by
             delta (2 u_dx - 1) and wrapped;
  worm_cm    TranslateHalfChain: the worm particle's half chain (beads
             0..Nb or Nb..2Nb), bead Nb first pinned to its open end
             xend[half] for the walkers whose worm is open;
  bis        Bisection: the interior window of 2**level links from the
             even bead ii (shared, or with per-walker windows each
             walker's own ii [s]), its midpoints built level by level
             (vpi_mod.f90:905-907), sigma = sqrt(delta dt / 4);
  bis_head   MoveHeadBisection / MoveTailBisection at the depth
  bis_tail   max(level, 2), whatever depth the move was handed (the
             random end depth U{2..Nlev} included): the free-gaussian guess
             of the chain's end bead about the window's far anchor, sigma
             sqrt(2**nlev dt), its gate row carrying the end bead's u, then
             the levels as above;
  bis_ends   the head and tail bisections of one particle as one composite
             (both proposed from the same positions);
  bis_multi  K interior bisections of K particles in the slots of 2**level
             links from the even bead s (all proposed from the same
             positions);
  cm_cascade, cascade_ends, cascade_int
             the whole-move cascades, in cascade.py.

Each displaced bead b of the moved particle p changes the action by

    dS_b = wv_b dPot_b + wf_b dF2_b - wpsi_b dU_b

against the other N - 1 particles at bead b (pairs within rcut; the force
on p and u over partners at r^2 > 0).  dF2_b is the change of |F_p|^2,
the moved particle's own (the reference code's partial term), or with
the configuration's `exact_f2` the change of every particle's |F_i|^2
(exact_f2.py), whatever its `f2_cache`.  A move's rows fall into accept
groups (the end gate, then level by level; one group for a rigid move),
and it is accepted where the walker is active and u_g < exp(-sum of its
group's dS) for every group g.  This is the law of the per-level form
(bis_monoshot off) too: each level's proposal is fixed by the gaussians,
so its pass sums the rows of its group, and its accept chain, the active
mask and every gate, is the same conjunction.

A move is returned as its slots (one per particle moved), each a dict:
  p       [s] long: the particle;
  beads   [B] long: the beads the slot writes (per-walker windows: [s, B],
          each walker's own);
  xold    [s, B, D]: what stands there if the move is rejected (for the
          worm move the pinned centre);
  xnew    [s, B, D]: the proposal;
  dS      [s, R]: the compared rows (a rigid move's one row is its sum);
  group   [R] long: each row's accept group, its column of u;
  u       [s, G]: the accept uniforms;
  active  [s] bool;
  xend    for the worm move: (half - 1, the row of bead Nb);
  f2      [B] bool: the rows with a Chin F^2 weight (exact F^2 only);
  dfield  [s, B, N, D]: every particle's field increment at each row,
          F(R') - F(R) (exact F^2 only; 0 on the rows without weight).
"""

from __future__ import annotations

import math

import torch

from . import exact_f2
from .physics import PairModel, chin_weights, geometry, wrap


def _at(R, beads):
    """[s, B, ...]: R [s, M, ...] at beads [B], or per walker at [s, B]."""
    if beads.dim() == 1:
        return R[:, beads]
    return R[torch.arange(R.shape[0], device=R.device)[:, None], beads]


def _rows_dS(cfg, geo, model, R, xnew, xold, p, beads):
    """[s, B]: dS of particle p [s] moved from xold to xnew [s, B, D] at
    beads [B] (or [s, B]), against the other particles of R [s, M, N, D];
    with exact F^2, (dS, the F^2 rows [B] bool, dfield [s, B, N, D])."""
    Rb = _at(R, beads)                                  # [s, B, N, D]
    N = Rb.shape[2]
    self_ = (torch.arange(N, device=R.device)[None, :] == p[:, None])
    self_ = self_[:, None, :]                            # [s, 1, N]

    def side(x):
        dx = wrap(x[:, :, None, :] - Rb, geo.L)
        r2 = (dx * dx).sum(-1)
        m = (r2 <= geo.rcut2) & ~self_
        mf = m & (r2 > 0)
        r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
        zero = torch.zeros_like(r)
        pot = torch.where(m, model.v(r), zero).sum(-1)
        F = (torch.where(mf, model.dv(r) / r, zero)[..., None] * dx).sum(-2)
        return pot, (F * F).sum(-1), torch.where(mf, model.u(r), zero).sum(-1)

    pn, fn, un = side(xnew)
    po, fo, uo = side(xold)
    w = chin_weights(R.shape[1], cfg["dt"], R.dtype, R.device)[:, beads]
    if not cfg.get("exact_f2"):
        return w[0] * (pn - po) + w[1] * (fn - fo) - w[2] * (un - uo)
    df2, dfield = exact_f2.rows(geo, model, R, p, beads, xnew, xold, w[1])
    return (w[0] * (pn - po) + w[1] * df2 - w[2] * (un - uo), w[1] != 0,
            dfield)


def _exact(slot, out):
    """The slot with dS from _rows_dS's output out (and with exact F^2
    its F^2 rows and field increments)."""
    if torch.is_tensor(out):
        return {**slot, "dS": out}
    return {**slot, "dS": out[0], "f2": out[1], "dfield": out[2]}


def _chain(R, p, beads):
    """[s, B, D]: particle p [s] at beads [B] (or [s, B])."""
    s = R.shape[0]
    return R[torch.arange(s, device=R.device)[:, None],
             beads if beads.dim() == 2 else beads[None, :], p[:, None]]


def _rigid(cfg, R, p, beads, xold, u_dx, u_acc, active, extra=None):
    geo, model = geometry(cfg), PairModel(cfg)
    xnew = wrap(xold + geo.delta_cm * (2.0 * u_dx.to(R.dtype) - 1.0), geo.L)
    out = _rows_dS(cfg, geo, model, R, xnew, xold, p, beads)
    rows = out if torch.is_tensor(out) else out[0]
    slot = {"p": p, "beads": beads, "xold": xold, "xnew": xnew,
            "group": torch.zeros(1, dtype=torch.long),
            "u": u_acc.to(R.dtype)[:, None], "active": active}
    slot = _exact(slot, out)
    slot["dS"] = rows.sum(-1)[:, None]
    return [{**slot, **(extra or {})}]


def cm(cfg, R, a):
    """TranslateChain of particle a['ip']."""
    s, M = R.shape[:2]
    p = torch.full((s,), a["ip"], dtype=torch.long, device=R.device)
    beads = torch.arange(M, device=R.device)
    return _rigid(cfg, R, p, beads, _chain(R, p, beads), a["u_dx"],
                  a["u_acc"], a["active"])


def worm_cm(cfg, R, a, xend):
    """TranslateHalfChain of the worm particle a['ip'] [s], half a['half'],
    with the open ends xend [s, 2, D]."""
    Nb, half = cfg["Nb"], a["half"]
    lo, hi = (0, Nb + 1) if half == 1 else (Nb, 2 * Nb + 1)
    beads = torch.arange(lo, hi, device=R.device)
    p, active = a["ip"], a["active"]
    xold = _chain(R, p, beads).clone()
    c = Nb - lo
    xold[:, c] = torch.where(active[:, None], xend[:, half - 1].to(R.dtype),
                             xold[:, c])
    return _rigid(cfg, R, p, beads, xold, a["u_dx"], a["u_acc"], active,
                  {"xend": (half - 1, c)})


def _level_of(pos: int, level: int) -> int:
    for ilev in range(1, level + 1):
        delta = 2 ** (level - ilev + 1)
        if pos % delta == delta // 2:
            return ilev
    raise ValueError(pos)


def _window(cfg, R, p, beads, level, g, u, active, gate):
    """One bisection window of particle p [s] over beads [L+1] or per
    walker [s, L+1] (in head orientation: bead 0 of the window is the
    chain's end for an end move), gaussians g [s, L, D] by window position,
    uniforms u [s, level+1] (randoms of another depth: ValueError)."""
    geo, model = geometry(cfg), PairModel(cfg)
    L, dt = 2 ** level, cfg["dt"]
    if not L <= g.shape[1] <= L + 1 or u.shape[1] != level + 1:
        raise ValueError(f"randoms of depth {level}: g {tuple(g.shape)}, "
                         f"u {tuple(u.shape)}")
    g = g.to(R.dtype)
    seg0 = _chain(R, p, beads)
    seg = seg0.clone()
    if gate:
        x0 = seg[:, 0]
        xmid = x0 - wrap(x0 - seg[:, L], geo.L)
        seg[:, 0] = wrap(xmid + math.sqrt(L * dt) * g[:, 0], geo.L)
    for ilev in range(1, level + 1):
        delta = 2 ** (level - ilev + 1)
        d2 = delta // 2
        xo = seg[:, d2::delta]
        xprev = xo + wrap(seg[:, 0:L:delta] - xo, geo.L)
        xnext = xo - wrap(xo - seg[:, delta::delta], geo.L)
        seg[:, d2::delta] = wrap(0.5 * (xprev + xnext) + math.sqrt(
            0.25 * delta * dt) * g[:, d2::delta], geo.L)
    pos = list(range(0 if gate else 1, L))
    rows = beads[..., pos]
    out = _rows_dS(cfg, geo, model, R, seg[:, pos], seg0[:, pos], p, rows)
    group = torch.tensor([0 if q == 0 else _level_of(q, level) for q in pos],
                         dtype=torch.long)
    return _exact({"p": p, "beads": rows, "xold": seg0[:, pos],
                   "xnew": seg[:, pos], "group": group,
                   "u": u.to(R.dtype), "active": active}, out)


def _end(cfg, R, p, level, g, u, active, tail):
    M, L = R.shape[1], 2 ** level
    beads = torch.arange(L + 1, device=R.device)
    if tail:
        beads = M - 1 - beads
    return _window(cfg, R, p, beads, level, g, u, active, True)


def _full(R, ip):
    return torch.full((R.shape[0],), ip, dtype=torch.long, device=R.device)


def bis(cfg, R, a):
    ii, g, u = a["rand"]
    beads = torch.arange(2 ** a["level"] + 1, device=R.device)
    beads = beads + (ii.to(R.device)[:, None] if torch.is_tensor(ii) else ii)
    return [_window(cfg, R, _full(R, a["ip"]), beads, a["level"], g, u,
                    a["active"], False)]


def bis_head(cfg, R, a):
    _, g, u = a["rand"]
    return [_end(cfg, R, _full(R, a["ip"]), max(a["level"], 2), g, u,
                 a["active"], False)]


def bis_tail(cfg, R, a):
    _, g, u = a["rand"]
    return [_end(cfg, R, _full(R, a["ip"]), max(a["level"], 2), g, u,
                 a["active"], True)]


def bis_ends(cfg, R, a):
    _, g2, u2 = a["rand"]
    p = _full(R, a["ip"])
    return [_end(cfg, R, p, a["level"], g2[:, e], u2[:, e], a["active"],
                 e == 1) for e in (0, 1)]


def bis_multi(cfg, R, a):
    s0, gK, uK = a["rand"]
    L = 2 ** a["level"]
    act = a["active"]
    out = []
    for k, ip in enumerate(a["ips"]):
        beads = torch.arange(s0 + k * L, s0 + (k + 1) * L + 1,
                             device=R.device)
        out.append(_window(cfg, R, _full(R, ip), beads, a["level"], gK[:, k],
                           uK[:, k], act[:, k] if act.dim() == 2 else act,
                           False))
    return out


def group_sums(slot, dS):
    """[s, G]: the rows dS [s, R] summed by accept group."""
    G = slot["u"].shape[1]
    out = torch.zeros(dS.shape[0], G, dtype=dS.dtype, device=dS.device)
    return out.index_add(1, slot["group"].to(dS.device), dS)


def passes(slot, dS):
    """[s, G] bool: u_g < exp(-sum of group g's dS), True for a group
    without rows."""
    G = slot["u"].shape[1]
    used = torch.zeros(G, dtype=torch.bool, device=dS.device)
    used[slot["group"].to(dS.device)] = True
    u = slot["u"].to(dS.dtype)
    return (u < torch.exp(-group_sums(slot, dS))) | ~used


def decide(slot, dS):
    """[s] bool: the reference's decision from rows dS."""
    return slot["active"] & passes(slot, dS).all(-1)


def apply(slots, R, xend, decisions):
    """(positions, open ends) after the slots' write-backs under
    decisions [s] bool each, from R [s, M, N, D] and xend [s, 2, D] (or
    None)."""
    R = R.clone()
    xend = None if xend is None else xend.clone()
    s = R.shape[0]
    rows = torch.arange(s, device=R.device)[:, None]
    for slot, dec in zip(slots, decisions):
        fin = torch.where(dec[:, None, None], slot["xnew"], slot["xold"])
        b = slot["beads"]
        R[rows, b if b.dim() == 2 else b[None, :], slot["p"][:, None]] = \
            fin.to(R.dtype)
        if "xend" in slot:
            h, c = slot["xend"]
            xend[:, h] = torch.where(slot["active"][:, None],
                                     fin[:, c].to(xend.dtype), xend[:, h])
    return R, xend


KINDS = {"cm": cm, "worm_cm": worm_cm, "bis": bis, "bis_head": bis_head,
         "bis_tail": bis_tail, "bis_ends": bis_ends, "bis_multi": bis_multi}


def move(cfg, kind, R, a, xend=None):
    """The slots of one move of `kind` on positions R [s, M, N, D] (the
    arithmetic in R's type) with its arguments a."""
    from .cascade import KINDS as CASCADES
    if kind == "worm_cm":
        return worm_cm(cfg, R, a, xend)
    return (CASCADES.get(kind) or KINDS[kind])(cfg, R, a)
