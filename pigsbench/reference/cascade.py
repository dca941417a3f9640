"""The plain reference of the whole-move cascades (the engine's
cascade_kernels.py:337-527; `cfg.cascade`), each worked out again from the
positions before the move and the move's own random numbers:

  cascade_ends  MoveHeadBisection + MoveTailBisection of particle ip as one
                move: for each end, the free-gaussian guess of the chain's
                end bead about the window's far anchor (sigma sqrt(L dt))
                and its gate, then nlev levels, each building its midpoints
                from the window as the earlier levels left it (one wrap per
                level, sigma sqrt(delta dt / 4)) and gating once on its
                summed dS.  The tail window is head-oriented: bead M-1
                first.
  cascade_int   K interior windows of L = 2**nlev links of the K particles
                ips, slot k from bead shift + k L, its nlev level gates.
  cm_cascade    the rigid whole-chain displacement delta (2 u_dx - 1) of
                particle ip and its one gate: TranslateChain, the `cm` move.

The randoms are indexed by window position, as the engine draws them: rg
[s, S, L+1, D] (row 0 the end guess's, a level's midpoints at their own
positions), ru [s, S, G] (ends: the end gate, then the levels; interior:
the levels).  A slot is accepted where it is active and passes every gate.
Write-back: rows 0..L for the ends (bead L, the anchor, stands as it was)
and the rigid move, rows 1..L-1 for the interior.

The slots are those of moves.py (`_window`), whose level-by-level build
and accept groups are the cascade's: the end row is group 0, a level's
rows group ilev."""

from __future__ import annotations

import torch

from .moves import _end, _full, _window, cm


def cascade_ends(cfg, R, a):
    p, rg, ru = _full(R, a["ip"]), a["rg"], a["ru"]
    return [_end(cfg, R, p, a["nlev"], rg[:, e], ru[:, e], a["active"],
                 e == 1) for e in (0, 1)]


def cascade_int(cfg, R, a):
    nlev, shift, rg = a["nlev"], a["shift"], a["rg"]
    L, act = 2 ** nlev, a["active"]
    # no end gate: group 0 has no rows, and level ilev takes column ilev - 1
    u = torch.cat([torch.ones_like(a["ru"][:, :, :1]), a["ru"]], -1)
    out = []
    for k, ip in enumerate(a["ips"]):
        beads = torch.arange(shift + k * L, shift + (k + 1) * L + 1,
                             device=R.device)
        out.append(_window(cfg, R, _full(R, ip), beads, nlev, rg[:, k],
                           u[:, k], act[:, k] if act.dim() == 2 else act,
                           False))
    return out


KINDS = {"cm_cascade": cm, "cascade_ends": cascade_ends,
         "cascade_int": cascade_int}
