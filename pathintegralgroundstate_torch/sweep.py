"""One Monte Carlo step over the whole walker ensemble (vpi.f90:297-475).

The torch counterpart of pathintegralgroundstate_tpu/sweep.py
`Sweeper.step`, with the reference's partial dF^2 or, with cfg.exact_f2,
the exact Chin F^2 (ops/pairwise.py), through the odd-bead force-field
cache (cfg.f2_cache: one field pass at the step's start, then every move
updates it) or by brute force:

  1. open/close attempts toggling the per-walker `isopen` mask,
  2. Np rigid CM translations (as cascades when cfg.cascade, unless the
     cache is on), then with cfg.smart_mc one MALA whole-path move of the
     diagonal walkers,
  3. the diagonal sweep, in one of two orders:
     unfused: Nstag*Np particle visits, each a head, a tail and an interior
         move: bisections (monoshot or per level, the ends at a random
         depth with cfg.bis_end_random_depth, head and tail paired with
         cfg.paired_ends, except with the cache) or, with sampling='sta',
         staging moves (with cfg.mesh_beads > 1 the interior move is the
         SP sweep, one window per bead shard, parallel/beadshard.py);
     fused (cfg.fused_sweep, when the windows fit): Nstag*Np head+tail
         composites (bisection, staging with end_regrow='sta', or the ends
         cascade), then Nstag*ceil(Np/K) interior composites of K particles
         each (bisection, or the interior cascade; with the cache on the
         cascades give way to the bisection composites),
  4. Nobdm worm rounds: half translations, half head/tail/staging, swap,
     permutation bookkeeping and the OBDM histogram,
  5. the estimators of the diagonal walkers (g(r) and S(k) under PBC
     only, the density map with cfg.density_map).

Every random number comes from a draw source (utils/draws.py) at the
address of the reference's key tree, so tests can replay the reference's
own draws; as in the reference, the bisections take batched randoms up to
BATCH_RAND_MAX_W walkers and per-move draws above (or with random end
depths).  The step calls no .item() and indexes with no boolean mask:
all Python-side control flow depends on host integers only.

Under walker sharding (System.mesh, parallel/mesh.py) W is this rank's
walker count, as the reference's per-device W_dev (sweep.py:296-297): the
batched-randoms threshold applies to it, and the draw source keeps this
rank's rows of every block.  Under bead sharding (an sp mesh) the state is
replicated and this rank moves its own shard's windows; without a mesh
the SP sweep runs its unsharded form.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from .ops import bisection as bis
from .ops import cascade as cas
from .ops import estimators as est
from .ops import moves as mv
from .ops import worm as wm
from .ops.pairwise import force_field
from .ops.smartmc import mala_move
from .parallel import beadshard as bs
from .parallel.mesh import reduce_stats
from .state import MCState
from .utils.draws import DeviceDraws


class StepStats(NamedTuple):
    """Per-step statistics summed over walkers (block-accumulated); the
    fields of the reference's StepStats (sweep.py:35-62)."""
    n_diag: torch.Tensor
    n_diag_all: torch.Tensor
    sumE: torch.Tensor
    sumK: torch.Tensor
    sumV: torch.Tensor
    sumE2: torch.Tensor
    sumK2: torch.Tensor
    sumV2: torch.Tensor
    sumEt: torch.Tensor
    sumKt: torch.Tensor
    sumVt: torch.Tensor
    sumEt2: torch.Tensor
    sumKt2: torch.Tensor
    sumVt2: torch.Tensor
    ngr: torch.Tensor
    gr: torch.Tensor           # [Nbin]
    sk: torch.Tensor           # [dim, Nk]
    nrho: torch.Tensor         # [Npw+1, Nbin] OBDM accumulator
    dens: torch.Tensor         # [Nbin, Nbin] with density_map, else [0, 0]
    perm_hist: torch.Tensor    # [Np]
    counters: torch.Tensor     # [len(COUNTER_NAMES)] int32


COUNTER_NAMES = (
    "try_cm", "acc_cm", "try_stag", "acc_bd", "acc_head", "acc_tail",
    "try_cm_half", "acc_cm_half", "try_stag_half", "acc_bd_half",
    "acc_head_half", "acc_tail_half",
    "try_open", "acc_open", "try_close", "acc_close", "try_swap", "acc_swap",
    "try_mala", "acc_mala", "try_int",
)
_CIDX = {n: i for i, n in enumerate(COUNTER_NAMES)}

# the reference's walker count up to which the bisections take batched
# randoms (sweep.py:82); a copy, held equal by tests/test_torch_import.py
BATCH_RAND_MAX_W = 1024


def zero_stats(system) -> StepStats:
    cfg = system.cfg
    kw = dict(dtype=system.dtype, device=system.device)
    z = lambda *shape: torch.zeros(shape, **kw)  # noqa: E731
    return StepStats(
        n_diag=z(), n_diag_all=z(), sumE=z(), sumK=z(), sumV=z(), sumE2=z(),
        sumK2=z(), sumV2=z(), sumEt=z(), sumKt=z(), sumVt=z(), sumEt2=z(),
        sumKt2=z(), sumVt2=z(), ngr=z(), gr=z(cfg.Nbin), sk=z(cfg.dim, cfg.Nk),
        nrho=z(cfg.Npw + 1, cfg.Nbin),
        dens=z(cfg.Nbin, cfg.Nbin) if cfg.density_map else z(0, 0),
        perm_hist=z(cfg.Np),
        counters=torch.zeros(len(COUNTER_NAMES), dtype=torch.int32,
                             device=system.device))


def stats_from_numpy(system, d: dict) -> StepStats:
    """StepStats from the reference's fields ({name: array})."""
    return StepStats(**{
        k: torch.as_tensor(np.array(d[k]), device=system.device,
                           dtype=torch.int32 if k == "counters"
                           else system.dtype)
        for k in StepStats._fields})


def stats_to_numpy(stats: StepStats) -> dict:
    """{field: numpy array} of the statistics, copied."""
    return {k: v.detach().cpu().numpy().copy()
            for k, v in stats._asdict().items()}


def bead_updates_per_step(cfg) -> int:
    """Bead updates attempted per MC step per walker (displaced beads).

    A pure-Python copy of the reference's sweep.bead_updates_per_step (its
    module imports JAX); tests/test_torch_import.py holds the two equal.
    THE throughput definition: bead-updates/s = W * this / (s per step)."""
    M = 2 * cfg.Nb + 1
    Np = cfg.Np
    per = 0
    if cfg.CMFreq > 0:
        per += Np * M // max(cfg.CMFreq, 1)
    if cfg.smart_mc > 0.0:
        per += Np * M
    if cfg.Nstag > 0:
        if cfg.sampling == "bis":
            L = 2 ** cfg.Nlev
            fused = (cfg.fused_sweep and not cfg.bis_end_random_depth
                     and 2 * L < M - 1)
            if fused:
                K = min(max(1, (M - 1 - L) // L), Np)
                ngroups = -(-Np // K)
                per += cfg.Nstag * Np * 2 * L
                per += cfg.Nstag * ngroups * K * (L - 1)
            else:
                per += cfg.Nstag * Np * 3 * L
        else:
            n_int = max(cfg.mesh_beads, 1)
            per += cfg.Nstag * Np * (2 * cfg.Lstag
                                     + n_int * (cfg.Lstag - 1)
                                     + (1 if n_int == 1 else 0))
    if cfg.CWorm > 0.0:
        per += cfg.Nobdm * (2 * (cfg.Nb + 1) + 2 * 3 * cfg.Lstag)
    return per


class Sweeper:
    """The flagship Monte Carlo step for one System."""

    def __init__(self, system):
        cfg = system.cfg
        if cfg.smart_mc > 0.0 and not cfg.exact_f2:
            # sweep.py:166-175: MALA's target is the exact Chin action, the
            # partial-dF^2 moves sample a different measure
            raise ValueError(
                "smart_mc > 0 requires exact_f2=True: MALA's target is the "
                "exact Chin action; the reference-parity partial-dF2 moves "
                "(exact_f2=False) sample a different measure")
        self.system = system
        self.Lstag, self.Nlev = cfg.Lstag, cfg.Nlev
        self.delta = system.geo.delta_cm
        L = 2 ** cfg.Nlev
        if L + 1 > system.M or 2 ** max(cfg.Nlev, 2) + 1 > system.M:
            raise ValueError(f"bisection windows of 2**Nlev={L} links do not "
                             f"fit M={system.M} beads")
        if cfg.CWorm > 0.0 and not 4 <= cfg.Lstag <= cfg.Nb:
            raise ValueError("the worm moves need 4 <= Lstag <= Nb")
        # the fused composite sweep (sweep.py:258-266): the head and tail
        # windows disjoint and non-adjacent, K interior slots in the chain
        self.fused_diag = (cfg.fused_sweep and cfg.sampling == "bis"
                           and not cfg.bis_end_random_depth
                           and 2 * L < system.M - 1)
        self.K_int = (min(max(1, (system.M - 1 - L) // L), cfg.Np)
                      if self.fused_diag else 1)
        # the reference's gates of batched randoms and paired ends
        # (sweep.py:216-228)
        self.batch_rand = (cfg.sampling == "bis" and cfg.shared_windows
                           and not cfg.bis_end_random_depth)
        self.paired_ends = (cfg.paired_ends and cfg.bis_monoshot
                            and 2 ** (max(cfg.Nlev, 2) + 1) < system.M - 1)
        # the exact-F^2 force-field cache (sweep.py:310-320)
        self.use_fcache = cfg.exact_f2 and cfg.f2_cache
        # the SP bead sharding (sweep.py:233-256): S shards of the interior
        # staging sweep, this rank's under an sp mesh, else all of them
        self.sp = max(cfg.mesh_beads, 1)
        mesh = system.mesh
        self.sp_sharded = mesh is not None and mesh.sp > 1
        if self.sp > 1:
            bs.check_sp_config(cfg)
        if self.sp_sharded and mesh.sp != self.sp:
            raise ValueError(f"mesh_beads={cfg.mesh_beads} on an sp mesh "
                             f"of {mesh.sp} ranks")

    def draws(self, state: MCState) -> DeviceDraws:
        """The port's own draw source for `state`."""
        return DeviceDraws(self.system, state.gen, state.host_gen)

    def step(self, state: MCState, stats: StepStats, draws=None):
        """One full MC step for every walker; returns (state, stats).

        state.paths is updated in place.  draws: a draw source (default:
        the state's own generators)."""
        system = self.system
        cfg = system.cfg
        dtype = system.dtype
        src = draws if draws is not None else self.draws(state)
        src.begin_step()
        W = state.paths.shape[0]
        Np, Lstag = cfg.Np, self.Lstag
        step_no = state.step + 1
        ctr = stats.counters.clone()
        paths, xend = state.paths, state.xend
        isopen, iworm = state.isopen, state.iworm
        in_cycle, iperm = state.in_cycle, state.iperm
        perm_hist = stats.perm_hist.clone()
        parts = system.arange(Np)
        # the field at the odd beads, the only rows whose F^2 carries Chin
        # weight, fresh once per step and then kept by every move
        fodd = force_field(system, paths[:, 1::2]) if self.use_fcache \
            else None

        def count(name, x):
            ctr[_CIDX[name]] += x.sum()

        # ---- 1. open/close attempts (vpi.f90:302-323) ----
        if cfg.CWorm > 0.0:
            iupdate = src.iupdate(W)
            do_close = isopen & (iupdate == 0)
            paths, xend, closed = wm.close_chain(
                system, paths, xend, iworm, do_close, Lstag,
                src.worm(1, W, Lstag), fodd)
            perm_hist.index_add_(0, (iperm - 1).clamp(0, Np - 1),
                                 closed.to(dtype))
            isopen = isopen & ~closed
            do_open = ~isopen & ~closed & (iupdate == 1)
            cand = src.cand(W, Np)
            paths, xend_o, opened = wm.open_chain(
                system, paths, xend, cand, do_open, Lstag,
                src.worm(3, W, Lstag), fodd)
            xend = mv._where(do_open, xend_o, xend)
            iworm = torch.where(opened, cand, iworm)
            isopen = isopen | opened
            in_cycle = torch.where(opened[:, None], cand[:, None] == parts,
                                   in_cycle)
            iperm = torch.where(opened, 1, iperm)
            count("try_close", do_close)
            count("acc_close", closed)
            count("try_open", do_open)
            count("acc_open", opened)

        # per-particle activity of the diagonal sweeps: the worm particle
        # of an open walker stays put
        active_all = ~isopen[:, None] | (iworm[:, None] != parts)  # [W, Np]

        # ---- 2. CM translations (vpi.f90:329-342 / 412-419) ----
        if cfg.CMFreq > 0 and step_no % max(cfg.CMFreq, 1) == 0:
            acc_cm = torch.zeros(W, dtype=torch.int32, device=system.device)
            for ip in range(Np):
                u_dx, u_acc = src.translate(10, ip, W)
                if cfg.cascade and fodd is None:
                    paths, acc = cas.rigid_cascade(
                        system, paths, ip, active_all[:, ip], self.delta,
                        u_dx, u_acc)
                else:
                    paths, acc = mv.translate_chain(
                        system, paths, ip, active_all[:, ip], self.delta,
                        u_dx, u_acc, fodd)
                acc_cm += acc
            count("try_cm", active_all)
            count("acc_cm", acc_cm)

        # ---- 2b. MALA whole-path move of the diagonal walkers ----
        if cfg.smart_mc > 0.0:
            diag = ~isopen
            paths, acc_m = mala_move(system, paths, diag, cfg.smart_mc,
                                     *src.mala(paths.shape), fodd)
            count("try_mala", diag)
            count("acc_mala", acc_m)

        # ---- 3. staging/bisection sweeps (vpi.f90:344-366 / 421-439) ----
        use_rand = self.batch_rand and W <= BATCH_RAND_MAX_W
        if cfg.Nstag > 0 and self.fused_diag:
            self._fused_sweep(src, paths, active_all, ctr, use_rand, fodd)
        elif cfg.Nstag > 0:
            self._unfused_sweep(src, paths, active_all, ctr, use_rand, fodd)

        # ---- 4. worm updates + OBDM (vpi.f90:370-404) ----
        nrho = stats.nrho.clone()
        if cfg.CWorm > 0.0 and cfg.Nobdm > 0:
            act = isopen
            nact = act.sum()
            n_opts = (cfg.Nb - Lstag) // 2 + 1
            acc6 = torch.zeros((6, W), dtype=torch.int32, device=system.device)
            for iobdm in range(cfg.Nobdm):
                for h in (1, 2):
                    u_dx, u_acc = src.translate(30 + h, iobdm, W)
                    paths, xend, acc = mv.translate_half_chain(
                        system, paths, xend, iworm, h, act, self.delta, u_dx,
                        u_acc, fodd)
                    acc6[0] += acc
                for h in (1, 2):
                    paths, xend, acc_h = mv.move_head_half_chain(
                        system, paths, xend, iworm, h, act, Lstag,
                        *src.regrow_half(40 + h, iobdm, W, Lstag), fodd)
                    paths, xend, acc_t = mv.move_tail_half_chain(
                        system, paths, xend, iworm, h, act, Lstag,
                        *src.regrow_half(42 + h, iobdm, W, Lstag), fodd)
                    paths, xend, acc_s = mv.staging_half_chain(
                        system, paths, xend, iworm, h, act, Lstag,
                        *src.staging_half(44 + h, iobdm, W, n_opts, Lstag),
                        fodd)
                    acc6[1] += acc_h
                    acc6[2] += acc_t
                    acc6[3] += acc_s
                if cfg.swapping:
                    paths, xend, acc_sw, partner = wm.swap_move(
                        system, paths, xend, iworm, act, Lstag,
                        src.swap(iobdm, W, Np, Lstag), fodd)
                    acc6[4] += acc_sw
                    # permutation-cycle bookkeeping (sample_mod.f90:556-581)
                    rows = system.arange(W)
                    already = in_cycle[rows, partner]
                    iperm = iperm + (acc_sw & ~already)
                    in_cycle = in_cycle.clone()
                    in_cycle[rows, partner] = already | acc_sw
                # OBDM in both geometries (obdm_terms)
                ibin, wpw, valid = wm.obdm_terms(system, xend)
                contrib = wpw * (act & valid)[:, None].to(dtype)
                nrho.index_add_(1, ibin, contrib.T)
            ctr[_CIDX["try_cm_half"]] += 2 * cfg.Nobdm * nact
            ctr[_CIDX["try_stag_half"]] += 2 * cfg.Nobdm * nact
            count("acc_cm_half", acc6[0])
            count("acc_head_half", acc6[1])
            count("acc_tail_half", acc6[2])
            count("acc_bd_half", acc6[3])
            if cfg.swapping:
                ctr[_CIDX["try_swap"]] += cfg.Nobdm * nact
                count("acc_swap", acc6[4])

        # ---- 5. estimators for diagonal walkers (vpi.f90:441-469) ----
        state = dataclasses.replace(state, paths=paths, xend=xend,
                                    isopen=isopen, iworm=iworm,
                                    in_cycle=in_cycle, iperm=iperm,
                                    step=step_no)
        base = stats._replace(
            nrho=nrho, perm_hist=perm_hist, counters=ctr,
            n_diag_all=stats.n_diag_all + (~isopen).to(dtype).sum())
        if cfg.measure_every <= 0 or step_no % cfg.measure_every != 0:
            return state, base
        return state, self._measure(paths, isopen, base)

    def _unfused_sweep(self, src, paths, active_all, ctr, use_rand,
                       fodd=None):
        """The reference-order sweep (sweep.py:412-519), in place on paths,
        the cache fodd and the counters ctr: per particle visit a head, a
        tail and an interior move; with the cache one after the other even
        with paired ends, so that the cache sees each write-back
        (sweep.py:448-458)."""
        system = self.system
        cfg = system.cfg
        W, Np, nlev, Lstag = paths.shape[0], cfg.Np, self.Nlev, self.Lstag
        per_level = not cfg.bis_monoshot
        paired = self.paired_ends and fodd is None
        n_bis = (system.M - 1 - 2 ** nlev) // 2 + 1
        n_sta = (system.M - 1 - Lstag) // 2 + 1
        n_sp = bs.n_starts((system.M - 1) // self.sp, Lstag)
        acc3 = torch.zeros((3, W), dtype=torch.int32, device=system.device)
        for it in range(cfg.Nstag * Np):
            ip = it % Np
            active = active_all[:, ip]
            if cfg.sampling != "bis":
                paths, acc_h = mv.move_head(system, paths, ip, active, Lstag,
                                            *src.regrow_half(20, it, W, Lstag),
                                            fodd)
                paths, acc_t = mv.move_tail(system, paths, ip, active, Lstag,
                                            *src.regrow_half(21, it, W, Lstag),
                                            fodd)
                if self.sp > 1:
                    # one window per bead shard, every shard's accepts
                    # counted (sweep.py:492-500; diagonal-only, so every
                    # walker is active)
                    draws = src.sp_staging(it, W, self.sp, n_sp, Lstag)
                    acc_b = (bs.sp_staging_sweep(system, paths, ip, Lstag,
                                                 draws)
                             if self.sp_sharded else
                             bs.sp_staging_sweep_ref(system, paths, ip,
                                                     self.sp, Lstag, draws)
                             ).sum(0)
                else:
                    paths, acc_b = mv.staging_move(
                        system, paths, ip, active, Lstag,
                        *src.staging_half(22, it, W, n_sta, Lstag), fodd)
            else:
                if use_rand:
                    d_h = d_t = max(nlev, 2)
                    r_h = src.bisect(25, it, W, d_h)
                    r_t = src.bisect(26, it, W, d_t)
                    r_b = src.bisect(27, it, W, nlev, n_bis)
                else:
                    # paired ends keep the fixed depth (bisection.py:406)
                    rd = cfg.bis_end_random_depth and not paired
                    d_h, r_h = src.end_bisect(20, it, W, nlev, per_level, rd)
                    d_t, r_t = src.end_bisect(21, it, W, nlev, per_level, rd)
                    r_b = src.bisect_keyed(22, it, W, nlev, n_bis, per_level)
                if paired:
                    paths, acc_h, acc_t = bis.paired_end_bisections(
                        system, paths, ip, active, nlev, r_h, r_t)
                else:
                    paths, acc_h = bis.move_head_bisection(
                        system, paths, ip, active, d_h, r_h, not use_rand,
                        fodd)
                    paths, acc_t = bis.move_tail_bisection(
                        system, paths, ip, active, d_t, r_t, not use_rand,
                        fodd)
                paths, acc_b = bis.bisection(system, paths, ip, active, nlev,
                                             r_b, fodd)
            acc3[0] += acc_h
            acc3[1] += acc_t
            acc3[2] += acc_b
        # the SP sweep counts a try per shard (sweep.py:513-514)
        ctr[_CIDX["try_stag"]] += cfg.Nstag * active_all.sum() * self.sp
        for i, name in enumerate(("acc_head", "acc_tail", "acc_bd")):
            ctr[_CIDX[name]] += acc3[i].sum()

    def _fused_sweep(self, src, paths, active_all, ctr, use_rand, fodd=None):
        """The fused composite sweep (sweep.py:521-618), in place on paths,
        the cache fodd and the counters ctr; with the cache the cascades
        give way to the bisection composites (sweep.py:535, 601)."""
        system = self.system
        cfg = system.cfg
        W, Np, nlev = paths.shape[0], cfg.Np, self.Nlev
        L, K = 2 ** nlev, self.K_int
        per_level = not cfg.bis_monoshot
        acc2 = torch.zeros((2, W), dtype=torch.int32, device=system.device)
        for it in range(cfg.Nstag * Np):
            ip = it % Np
            active = active_all[:, ip]
            if cfg.end_regrow == "sta":
                _, acc_h, acc_t = mv.fused_end_stagings(
                    system, paths, ip, active, L, *src.end_stagings(it, W, L),
                    fodd)
            elif cfg.cascade and fodd is None:
                _, acc_h, acc_t = cas.fused_ends_cascade(
                    system, paths, ip, active, nlev,
                    *src.cascade_ends(it, W, nlev))
            else:
                rand = (src.fused_ends(it, W, nlev) if use_rand else
                        src.fused_ends_keyed(it, W, nlev, per_level))
                _, acc_h, acc_t = bis.fused_end_bisections(
                    system, paths, ip, active, nlev, rand, fodd)
            acc2[0] += acc_h
            acc2[1] += acc_t
        ctr[_CIDX["try_stag"]] += cfg.Nstag * active_all.sum()
        ctr[_CIDX["acc_head"]] += acc2[0].sum()
        ctr[_CIDX["acc_tail"]] += acc2[1].sum()

        n_shift = (system.M - 1 - K * L) // 2 + 1
        int2 = torch.zeros((2, W, K), dtype=torch.int32, device=system.device)
        for it in range(cfg.Nstag * -(-Np // K)):
            # the particle -> slot assignment rotates with a drawn offset,
            # so every particle sees every slot over the groups
            off = src.group_offset(it, Np)
            ips = [(it * K + k + off) % Np for k in range(K)]
            act = torch.stack([active_all[:, p] for p in ips], 1)
            if cfg.cascade and fodd is None:
                _, acc = cas.interior_cascade(
                    system, paths, ips, act, nlev,
                    *src.cascade_interior(it, W, K, nlev, n_shift))
            else:
                # batched randoms as sweep.py:589-599 takes them: not when
                # the cascade is configured
                rand = (src.bisect_multi(it, W, K, nlev, n_shift)
                        if use_rand and not cfg.cascade
                        else src.bisect_multi_keyed(it, W, K, nlev, n_shift,
                                                    per_level))
                _, acc = bis.bisection_multi(system, paths, ips, act, nlev,
                                             rand, fodd)
            int2[0] += act
            int2[1] += acc
        ctr[_CIDX["try_int"]] += int2[0].sum()
        ctr[_CIDX["acc_bd"]] += int2[1].sum()

    def _measure(self, paths, isopen, st: StepStats) -> StepStats:
        system = self.system
        cfg = system.cfg
        fdiag = (~isopen).to(paths.dtype)
        nd = fdiag.sum()
        E1, _, _ = est.local_energy(system, paths[:, 0])
        E2, _, _ = est.local_energy(system, paths[:, -1])
        E = 0.5 * (E1 + E2)
        Et, Kt, Ep = est.therm_energy(system, paths)
        Kin = E - Ep

        def msum(x):
            return (x * fdiag).sum()

        centre = paths[:, cfg.Nb]
        st = st._replace(
            n_diag=st.n_diag + nd,
            sumE=st.sumE + msum(E), sumK=st.sumK + msum(Kin),
            sumV=st.sumV + msum(Ep),
            sumE2=st.sumE2 + msum(E * E),
            sumK2=st.sumK2 + msum(Kin * Kin),
            sumV2=st.sumV2 + msum(Ep * Ep),
            sumEt=st.sumEt + msum(Et), sumKt=st.sumKt + msum(Kt),
            sumVt=st.sumVt + msum(Ep),
            sumEt2=st.sumEt2 + msum(Et * Et),
            sumKt2=st.sumKt2 + msum(Kt * Kt),
            sumVt2=st.sumVt2 + msum(Ep * Ep),
            ngr=st.ngr + nd,
        )
        if system.pbc:     # no g(r) or S(k) under the trap (sweep.py:748)
            st = st._replace(
                gr=st.gr + est.pair_correlation(system, centre, fdiag),
                sk=st.sk + (est.structure_factor(system, cfg.Nk, centre)
                            * fdiag[:, None, None]).sum(0))
        if cfg.density_map:
            st = st._replace(dens=st.dens + est.density_map(system, centre,
                                                             fdiag))
        return st


def run_block(sweeper: Sweeper, state: MCState, nstep: int, draws=None):
    """nstep MC steps from zero statistics: (state, block StepStats).
    Under walker sharding the statistics are this rank's walkers' until the
    block's end, then summed over the dp group (parallel/mesh.reduce_stats),
    as the reference's sharded block all-reduces them."""
    stats = zero_stats(sweeper.system)
    for _ in range(nstep):
        state, stats = sweeper.step(state, stats, draws)
    return state, reduce_stats(sweeper.system, stats)
