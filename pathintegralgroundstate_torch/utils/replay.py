"""Reference-trajectory replay harness.

The torch port's copy of pathintegralgroundstate_tpu/utils/replay.py.  It
drives the reference's TranslateChain + Staging, Bisection, MoveHead /
MoveTail and worm OpenChain / CloseChain / Swap control flow with the
BIT-EXACT reference RNG stream (utils/refrng.RefRNG: MT19937 with the
reference's 69069 seeding, grnd() and the polar Box-Muller rangauss, the
Metropolis uniform drawn ONLY when exp(-dS) < 1, vpi_mod.f90:356-364), in
the reference's draw order, and evaluates every displaced bead's Delta-S
through the PORT's ops.pairwise.delta_action with the reference-parity
settings (tabulated V and log Psi on the reference grid, the partial
moved-particle dF2), on the device the caller names (default the card,
as make_system; device="cpu" runs the plain forms on the CPU).  The resulting
trajectories are pinned by tests/golden/refrng_replay*.json, so a drift in
the draw order or in the action arithmetic fails them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import SimConfig
from ..ops.pairwise import delta_action
from ..system import make_system
from .refrng import RefRNG


def _delta_s(system):
    """ds(Rrow [Np, dim], xn, xo, ip, ib) -> float: one displaced bead's
    Delta-S through the port's dense delta_action, on system's device."""
    kw = dict(dtype=system.dtype, device=system.device)

    def ds(Rrow, xn, xo, ip, ib):
        ibt = torch.tensor([[ib]], dtype=torch.long, device=system.device)
        out = delta_action(system, torch.as_tensor(Rrow, **kw)[None, None],
                           torch.as_tensor(xn, **kw)[None, None],
                           torch.as_tensor(xo, **kw)[None, None], int(ip),
                           ibt)
        return float(out[0, 0])
    return ds


def replay_trajectory(seed: int = 1982, nsteps: int = 3, Np: int = 2,
                      Nb: int = 2, dim: int = 3, Lstag: int = 2,
                      density: float = 0.3, dt: float = 5e-3,
                      Rm: float = 1.2, Nmax: int = 2000, device=None):
    """Return paths[M, Np, dim] after `nsteps` replayed reference sweeps
    (per step TranslateChain for ip = 0..Np-1, then Staging for each)."""
    cfg = SimConfig(dim=dim, Np=Np, density=density, Nb=Nb, dt=dt, Rm=Rm,
                    Lstag=Lstag, wf_table=True, v_table=True, Nmax=Nmax,
                    dtype="float64", potential="aziz2", n_walkers=1)
    system = make_system(cfg, device)
    geo = system.geo
    Lbox = np.asarray(geo.Lbox)
    half = 0.5 * Lbox
    M = 2 * Nb + 1
    rng = RefRNG(seed)

    # the port's per-bead Delta-S (UpdateAction equivalent)
    ds = _delta_s(system)

    def bc(x, k):
        """BoundaryConditions (pbc_mod.f90:11-25): single-image ifs."""
        if x > half[k]:
            x -= Lbox[k]
        if x < -half[k]:
            x += Lbox[k]
        return x

    def metro(s):
        a = math.exp(-s)
        if a >= 1.0:
            return True
        return a >= rng.grnd()

    # init: fresh uniform box placement (vpi_mod.f90:232-237), replicated
    # to every bead (242-248)
    R = np.empty((Np, dim))
    for ip in range(Np):
        for k in range(dim):
            R[ip, k] = Lbox[k] * (rng.grnd() - 0.5)
    path = np.tile(R[None], (M, 1, 1))           # [M, Np, dim]

    def translate_chain(ip, delta):
        """vpi_mod.f90:313-379."""
        dx = np.array([delta * (2.0 * rng.grnd() - 1.0) for _ in range(dim)])
        newchain = np.empty((M, dim))
        s = 0.0
        for ib in range(M):
            xold = path[ib, ip].copy()
            xnew = xold + dx
            for k in range(dim):
                xnew[k] = bc(xnew[k], k)
            newchain[ib] = xnew
            s += ds(path[ib], xnew, xold, ip, ib)
        if metro(s):
            path[:, ip] = newchain

    def staging(ip, L):
        """vpi_mod.f90:480-578 (note the ANY-alignment window draw and the
        sequential recursion through the already-updated previous bead)."""
        ii = int((2 * Nb - L + 1) * rng.grnd())
        old = path[ii: ii + L + 1, ip].copy()
        s = 0.0
        for j in range(1, L):
            xold = path[ii + j, ip].copy()
            xnew = np.empty(dim)
            for k in range(dim):
                g1, _ = rng.rangauss(1.0, 0.0)
                xprev = path[ii + j - 1, ip, k] - xold[k]
                xprev = bc(xprev, k)
                xprev = xold[k] + xprev
                xnext = xold[k] - path[ii + L, ip, k]
                xnext = bc(xnext, k)
                xnext = xold[k] - xnext
                sigma = math.sqrt((L - j) / (L - j + 1.0) * dt)
                xmid = (xnext + xprev * (L - j)) / (L - j + 1.0)
                xnew[k] = bc(xmid + sigma * g1, k)
                path[ii + j, ip, k] = xnew[k]
            s += ds(path[ii + j], xnew, xold, ip, ii + j)
        if metro(s):
            pass
        else:
            path[ii: ii + L + 1, ip] = old

    for _ in range(nsteps):
        for ip in range(Np):
            translate_chain(ip, geo.delta_cm)
        for ip in range(Np):
            staging(ip, Lstag)
    return path


# ---------------------------------------------------------------------------
# Every remaining move class.
#
# _Replay drives the reference's Bisection (vpi_mod.f90:864-998, per-level
# conditional-accept draw order with early exit), MoveHead/MoveTail
# (582-860, gaussian end guess anchored per the reference's unwrap), and
# the worm OpenChain/CloseChain/Swap streams (1821-2487: even-Ls and half
# draws, the +-log(CWorm rho) and broken-link DeltaK terms, the Swap tower
# selection and pre-acceptance) with the BIT-EXACT reference RNG stream,
# evaluating every displaced bead's Delta-S through the engine's
# delta_action, as replay_trajectory does.
# ---------------------------------------------------------------------------


class _Replay:
    def __init__(self, seed=1982, Np=2, Nb=4, dim=3, density=0.3, dt=5e-3,
                 Rm=1.2, Nmax=2000, CWorm=0.4, device=None):
        cfg = SimConfig(dim=dim, Np=Np, density=density, Nb=Nb, dt=dt,
                        Rm=Rm, wf_table=True, v_table=True, Nmax=Nmax,
                        dtype="float64", potential="aziz2", n_walkers=1,
                        CWorm=CWorm)
        self.cfg = cfg
        self.system = make_system(cfg, device)
        geo = self.system.geo
        self.Lbox = np.asarray(geo.Lbox)
        self.half_box = 0.5 * self.Lbox
        self.Np, self.Nb, self.dim, self.dt = Np, Nb, dim, dt
        self.M = 2 * Nb + 1
        self.rng = RefRNG(seed)
        self.density = geo.density

        self._ds = _delta_s(self.system)
        # init placement (vpi_mod.f90:232-237) replicated to all beads
        R = np.empty((Np, dim))
        for ip in range(Np):
            for k in range(dim):
                R[ip, k] = self.Lbox[k] * (self.rng.grnd() - 0.5)
        self.path = np.tile(R[None], (self.M, 1, 1))     # [M, Np, dim]
        # worm bookkeeping
        self.isopen = False
        self.iw = -1
        self.xend = np.zeros((dim, 2)).T                 # [2, dim]

    def ds(self, ib, xn, xo, ip):
        return self._ds(self.path[ib], xn, xo, ip, ib)

    def bc(self, x, k):
        if x > self.half_box[k]:
            x -= self.Lbox[k]
        if x < -self.half_box[k]:
            x += self.Lbox[k]
        return x

    def mi2(self, xij):
        r2 = 0.0
        for k in range(self.dim):
            xij[k] = self.bc(xij[k], k)
            r2 += xij[k] * xij[k]
        return r2

    def metro(self, s):
        if s < -700.0:
            # Fortran: exp(-s) overflows to +Inf >= 1 -> accept with NO
            # uniform drawn (the else branch never runs); Python raises
            return True
        a = math.exp(-s)  # underflow side (s >> 0) gives 0.0, still draws
        if a >= 1.0:
            return True
        return a >= self.rng.grnd()

    def _stage_row(self, ip, ib, anchor_ib):
        """One staging-recursion row (vpi_mod.f90:509-549 form): displaces
        bead ib of particle ip toward anchor_ib; returns (xnew, xold)."""
        Ls_rem = anchor_ib - ib + 1  # (L - j) + 1 in reference notation
        xold = self.path[ib, ip].copy()
        xnew = np.empty(self.dim)
        for k in range(self.dim):
            g1, _ = self.rng.rangauss(1.0, 0.0)
            xprev = self.bc(self.path[ib - 1, ip, k] - xold[k], k)
            xprev = xold[k] + xprev
            xnext = self.bc(xold[k] - self.path[anchor_ib, ip, k], k)
            xnext = xold[k] - xnext
            nrem = anchor_ib - ib  # Ls - j
            sigma = math.sqrt(nrem / (nrem + 1.0) * self.dt)
            xmid = (xnext + xprev * nrem) / (nrem + 1.0)
            xnew[k] = self.bc(xmid + sigma * g1, k)
            self.path[ib, ip, k] = xnew[k]
        del Ls_rem
        return xnew, xold

    # -- Bisection (vpi_mod.f90:864-998) --------------------------------

    def bisection(self, ip, level):
        Nb, dim, dt = self.Nb, self.dim, self.dt
        L = 2 ** level
        ii = int((2 * Nb - L + 1) * self.rng.grnd())
        old = self.path[ii: ii + L + 1, ip].copy()
        accept = True
        for ilev in range(1, level + 1):
            delta = 2 ** (level - ilev + 1)
            sigma = math.sqrt(0.25 * delta * dt)
            s = 0.0
            for j in range(1, 2 ** (ilev - 1) + 1):
                iprev = ii + (j - 1) * delta
                inext = ii + j * delta
                icur = (iprev + inext) // 2
                xold = self.path[icur, ip].copy()
                xnew = np.empty(dim)
                for k in range(dim):
                    g1, _ = self.rng.rangauss(1.0, 0.0)
                    xprev = self.bc(self.path[iprev, ip, k] - xold[k], k)
                    xprev = xold[k] + xprev
                    xnext = self.bc(xold[k] - self.path[inext, ip, k], k)
                    xnext = xold[k] - xnext
                    xnew[k] = self.bc(0.5 * (xprev + xnext) + sigma * g1, k)
                    self.path[icur, ip, k] = xnew[k]
                s += self.ds(icur, xnew, xold, ip)
            if not self.metro(s):
                accept = False
                break  # reference early exit (vpi_mod.f90:960-969)
        if not accept:
            self.path[ii: ii + L + 1, ip] = old
        return accept

    # -- MoveHead / MoveTail (vpi_mod.f90:582-860) ----------------------

    def _end_guess(self, ip, ib_move, ib_anchor, Ls):
        """Free-gaussian terminal guess: new bead = unwrapped anchor +
        sqrt(Ls dt) g (the reference's xmid = unwrapped anchor form)."""
        xold = self.path[ib_move, ip].copy()
        xnew = np.empty(self.dim)
        sigma = math.sqrt(Ls * self.dt)
        for k in range(self.dim):
            g1, _ = self.rng.rangauss(1.0, 0.0)
            anchor = self.bc(xold[k] - self.path[ib_anchor, ip, k], k)
            anchor = xold[k] - anchor
            xnew[k] = self.bc(anchor + sigma * g1, k)
            self.path[ib_move, ip, k] = xnew[k]
        return xnew, xold

    def move_head(self, ip, Lmax):
        Ls = int((Lmax - 1) * self.rng.grnd()) + 2
        ii, ie = 0, Ls
        old = self.path[ii: ie + 1, ip].copy()
        xnew, xold = self._end_guess(ip, ii, ie, Ls)
        s = self.ds(ii, xnew, xold, ip)
        for j in range(1, Ls):
            xnew, xold = self._stage_row(ip, ii + j, ie)
            s += self.ds(ii + j, xnew, xold, ip)
        if self.metro(s):
            return True
        self.path[ii: ie + 1, ip] = old
        return False

    def move_tail(self, ip, Lmax):
        Ls = int((Lmax - 1) * self.rng.grnd()) + 2
        ii, ie = 2 * self.Nb - Ls, 2 * self.Nb
        old = self.path[ii: ie + 1, ip].copy()
        xnew, xold = self._end_guess(ip, ie, ii, Ls)
        s = self.ds(ie, xnew, xold, ip)
        for j in range(1, Ls):
            xnew, xold = self._stage_row(ip, ii + j, ie)
            s += self.ds(ii + j, xnew, xold, ip)
        if self.metro(s):
            return True
        self.path[ii: ie + 1, ip] = old
        return False

    # -- Worm streams (vpi_mod.f90:1821-2487) ---------------------------

    def open_chain(self, ip, Lmax):
        Nb, dim, dt = self.Nb, self.dim, self.dt
        Ls = 2 * int((Lmax - 2) // 2 * self.rng.grnd()) + 2
        half = int(self.rng.grnd() * 2) + 1
        s = -math.log(self.cfg.CWorm * self.density)
        ii, ie = (Nb - Ls, Nb) if half == 1 else (Nb, Nb + Ls)
        xij = self.path[ii, ip] - self.path[ie, ip]
        rij2 = self.mi2(xij.copy())
        dK = -0.5 * rij2 / (Ls * dt) \
            - 0.5 * dim * math.log(2.0 * math.pi * Ls * dt)
        old = self.path[ii: ie + 1, ip].copy()
        ib_move, ib_anchor = (ie, ii) if half == 1 else (ii, ie)
        xnew, xold = self._end_guess(ip, ib_move, ib_anchor, Ls)
        s += 0.5 * self.ds(ib_move, xnew, xold, ip)
        for j in range(1, Ls):
            xnew, xold = self._stage_row(ip, ii + j, ie)
            s += self.ds(ii + j, xnew, xold, ip)
        if self.metro(s + dK):
            self.isopen = True
            self.iw = ip
            if half == 1:
                self.xend[0] = self.path[Nb, ip]
                self.xend[1] = old[Nb - ii]
            else:
                self.xend[0] = old[Nb - ii]
                self.xend[1] = self.path[Nb, ip]
            return True
        self.path[ii: ie + 1, ip] = old
        self.xend[0] = self.path[Nb, ip]
        self.xend[1] = self.xend[0]
        return False

    def close_chain(self, ip, Lmax):
        Nb, dim, dt = self.Nb, self.dim, self.dt
        Ls = 2 * int((Lmax - 2) // 2 * self.rng.grnd()) + 2
        half = int(self.rng.grnd() * 2) + 1
        s = math.log(self.cfg.CWorm * self.density)
        ii, ie = (Nb - Ls, Nb) if half == 1 else (Nb, Nb + Ls)
        old = self.path[ii: ie + 1, ip].copy()
        ib_pin = ie if half == 1 else ii
        pin = self.xend[1] if half == 1 else self.xend[0]
        xold = self.path[ib_pin, ip].copy()
        self.path[ib_pin, ip] = pin
        s += 0.5 * self.ds(ib_pin, pin.copy(), xold, ip)
        for j in range(1, Ls):
            xnew, xold = self._stage_row(ip, ii + j, ie)
            s += self.ds(ii + j, xnew, xold, ip)
        xij = self.path[ii, ip] - self.path[ie, ip]
        rij2 = self.mi2(xij.copy())
        dK = -0.5 * rij2 / (Ls * dt) \
            - 0.5 * dim * math.log(2.0 * math.pi * Ls * dt)
        if self.metro(s - dK):
            self.isopen = False
            self.xend[0] = self.path[Nb, ip]
            self.xend[1] = self.xend[0]
            return True
        self.path[ii: ie + 1, ip] = old
        return False

    def swap(self, Lmax):
        Nb, dim, dt = self.Nb, self.dim, self.dt
        iw = self.iw
        Ls = 2 * int((Lmax - 2) // 2 * self.rng.grnd()) + 2
        ii, ie = Nb - Ls, Nb
        Pp = np.empty(self.Np)
        for ip in range(self.Np):
            xij = self.path[ii, ip] - self.xend[1]
            Pp[ip] = math.exp(-0.5 * self.mi2(xij.copy()) / (Ls * dt))
        Sw = float(np.sum(Pp))
        uran = self.rng.grnd()
        acc_p = 0.0
        ik = -1
        for ip in range(self.Np):
            acc_p += Pp[ip] / Sw
            if uran <= acc_p:
                ik = ip
                break
        if ik == iw:
            return False
        Sk = 0.0
        for ip in range(self.Np):
            xij = self.path[ii, ip] - self.path[ie, ik]
            Sk += math.exp(-0.5 * self.mi2(xij.copy()) / (Ls * dt))
        if not (self.rng.grnd() <= Sw / Sk):
            return False
        old_chain = self.path[:, ik].copy()
        old_worm = self.path[:, iw].copy()
        self.path[ie, ik] = self.xend[1]
        s = 0.0
        for j in range(1, Ls):
            xnew, xold = self._stage_row(ik, ii + j, ie)
            s += self.ds(ii + j, xnew, xold, ik)
        if self.metro(s):
            wtail = old_worm[Nb: 2 * Nb + 1].copy()
            self.path[Nb: 2 * Nb + 1, iw] = self.path[Nb: 2 * Nb + 1, ik]
            self.path[Nb: 2 * Nb + 1, ik] = wtail
            self.xend[1] = old_chain[Nb]
            self.path[Nb, iw] = self.xend[1]
            return True
        self.path[:, ik] = old_chain
        self.path[:, iw] = old_worm
        return False


def replay_bisection_trajectory(seed=1982, nsteps=3, Np=2, Nb=4, dim=3,
                                Nlev=2, density=0.3, dt=5e-3, Rm=1.2,
                                device=None):
    """Bisection + end-bisection-free sweep: per step, MoveHead, MoveTail
    (Lmax = 2**Nlev) then Bisection per particle — the vpi.f90:431-435
    shape with the reference's per-level draw/accept order."""
    rp = _Replay(seed=seed, Np=Np, Nb=Nb, dim=dim, density=density, dt=dt,
                 Rm=Rm, device=device)
    L = 2 ** Nlev
    for _ in range(nsteps):
        for ip in range(Np):
            rp.move_head(ip, L)
            rp.move_tail(ip, L)
            rp.bisection(ip, Nlev)
    return rp.path


def replay_worm_trajectory(seed=1982, nsteps=6, Np=3, Nb=4, dim=3,
                           Lstag=4, density=0.3, dt=5e-3, Rm=1.2,
                           CWorm=0.4, nequil=3, device=None):
    """Worm open/close/swap streams: per step the vpi.f90:302-323 dispatch
    (coin flip, uniform worm-particle draw, OpenChain/CloseChain) plus one
    Swap attempt per open step — every draw in the reference's order.
    nequil head/tail equilibration sweeps (same stream) precede the worm
    phase so open attempts face a relaxed configuration."""
    rp = _Replay(seed=seed, Np=Np, Nb=Nb, dim=dim, density=density, dt=dt,
                 Rm=Rm, CWorm=CWorm, device=device)
    events = []
    for _ in range(nequil):
        for ip in range(Np):
            rp.move_head(ip, Lstag)
            rp.move_tail(ip, Lstag)
    for _ in range(nsteps):
        iupdate = int(rp.rng.grnd() * 2)
        if rp.isopen and iupdate == 0:
            acc = rp.close_chain(rp.iw, Lstag)
            events.append(("close", int(acc)))
        elif (not rp.isopen) and iupdate == 1:
            ip = int(rp.rng.grnd() * rp.Np)
            acc = rp.open_chain(ip, Lstag)
            events.append(("open", int(acc)))
        if rp.isopen:
            acc = rp.swap(Lstag)
            events.append(("swap", int(acc)))
    return rp.path, rp.xend, events
