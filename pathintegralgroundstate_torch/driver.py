"""Simulation driver: block loop, statistics, reporting, outputs, checkpoint.

The torch counterpart of pathintegralgroundstate_tpu/driver.py, which
mirrors the reference driver (vpi.f90:244-653): per-block accumulators and
their normalization (vpi.f90:477-545), the console block report with
acceptance telemetry (vpi.f90:552-586), the output files `e_vpi.out`,
`et_vpi.out`, `gr_vpi.out`, `sk_vpi.out` (PBC only), `nr_vpi.out` (both
geometries), `density_vpi.out` (density_map) with identical columns
(sample_mod.f90:633-652, 794-870), the permutation histogram
`perm_histogram.out`, a structured `metrics.jsonl`, and per-block
checkpoint/resume.

A block is `sweep.run_block`: Nstep steps issued with no host sync, then
one read-back of the block's statistics (`stats_to_numpy`).  The blocks run
one after the other: `Sweeper.step` updates `state.paths` in place, so the
reference's pipelining (block k+1 dispatched before block k's checkpoint
reads its state) would checkpoint block k+1's half-written paths here.

The checkpoint is the reference's npz archive with the threefry key
replaced by the two torch generators' states (`gen_state`, `host_gen_state`).

Multi-device runs (driver.py:80-135, 170-183, 507-531): distributed=True
initialises torch.distributed from torchrun's environment
(parallel/mesh.init_from_env), and mesh_walkers x mesh_pairs > 1 shards
the walkers over dp and the partner axis over tp (parallel/mesh.py), one
rank per mesh position; mesh_beads > 1 (alone) shards the bead axis of the
SP staging sweep over as many ranks (parallel/beadshard.py), the state
replicated.  Every rank holds the replicated block statistics;
only rank 0 makes the output directory, writes the files and the
checkpoint, and prints.  The checkpoint gathers the walker slices into the
unsharded layout, so that a run resumes under any mesh; both generators
are identical on every rank and saved once.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import SimConfig
from .parallel.beadshard import check_sp_config
from .parallel.mesh import gather_state, init_from_env, local_device, \
    make_mesh, reduce_stats
from .state import MCState, generator_states, init_state, \
    set_generator_states, state_from_numpy, state_to_numpy
from .sweep import _CIDX, StepStats, Sweeper, bead_updates_per_step, \
    run_block, stats_to_numpy, zero_stats
from .system import System, make_system


def var(nitem, s, s2):
    """Var = sqrt((<x^2> - <x>^2)/N) (sample_mod.f90:921-932)."""
    if nitem <= 0:
        return 0.0
    return math.sqrt(max((s2 - s * s) / nitem, 0.0))


def drift_z(x, min_n: int = 8) -> float:
    """First-half vs second-half drift statistic of a block-mean series
    (a Geweke-style equilibration check):

        z = (mean(second half) - mean(first half)) / sqrt(se1^2 + se2^2)

    |z| >> 1 on a stationary chain is evidence the burn-in was too short.
    The scale is the SECOND half's standard error (assumed stationary),
    applied to both halves, so that a still-relaxing first half does not
    inflate the variance with its own transient.  Returns 0 while fewer
    than min_n blocks exist."""
    x = np.asarray(x, dtype=float)
    n = len(x)
    if n < min_n:
        return 0.0
    h = n // 2
    a, b = x[:h], x[h:]
    d2 = b.var(ddof=1) * (1.0 / len(a) + 1.0 / len(b))
    if d2 <= 0.0:
        return 0.0
    return float((b.mean() - a.mean()) / math.sqrt(d2))


def shell_norm(dim: int, density: float, rbin: float, nbin: int):
    """Ideal-gas shell weights nid[ibin] (NormalizeGr, sample_mod.f90:656-679)."""
    k_n = math.pi ** (0.5 * dim) / math.gamma(0.5 * dim + 1.0)
    r = (np.arange(1, nbin + 1) - 0.5) * rbin
    return density * k_n * ((r + 0.5 * rbin) ** dim - (r - 0.5 * rbin) ** dim)


def _nonfinite(state: MCState, stats: StepStats):
    """The first field of the state's paths or of the statistics with a
    non-finite value, or None."""
    fields = [("paths", state.paths), ("xend", state.xend)] + [
        (k, v) for k, v in stats._asdict().items() if v.is_floating_point()]
    for name, t in fields:
        if not bool(torch.isfinite(t).all()):
            return name
    return None


class Driver:
    """The block loop of one run.

    device: the System's device (default the card, under a process group
    the rank's card cuda:(LOCAL_RANK % device_count); "cpu" runs the plain
    forms).  draws: a draw source for every step (default the state's own
    generators), passed on to run_block.  init_positions: the crystal
    start's positions [N, D] (config_ini.in) for a fresh ensemble."""

    def __init__(self, cfg: SimConfig, out_dir: str = ".", device=None,
                 verbose: bool = True, draws=None, init_positions=None):
        self.cfg = cfg
        self.out_dir = out_dir
        self.draws = draws
        if cfg.distributed:
            init_from_env(device)
        grouped = dist.is_initialized()
        self.backend = dist.get_backend() if grouped else None
        world = dist.get_world_size() if grouped else 1
        self.rank = dist.get_rank() if grouped else 0
        self.is_main = self.rank == 0
        self.verbose = verbose and self.is_main
        if grouped:
            device = local_device(device)
        self.mesh = None
        n_dp, n_tp = cfg.mesh_walkers, cfg.mesh_pairs
        if cfg.mesh_beads > 1:
            # the SP envelope first (sweep.py:234-250), then one rank per
            # bead shard, as the reference wants a device per shard
            # (sweep.py:251-254)
            check_sp_config(cfg)
            if cfg.mesh_beads != world:
                raise ValueError(
                    f"mesh_beads={cfg.mesh_beads} does not match the {world} "
                    "ranks of the process group: run it as torchrun "
                    f"--nproc-per-node {cfg.mesh_beads} -m "
                    "pathintegralgroundstate_torch in.in --set "
                    f"mesh_beads={cfg.mesh_beads}")
            self.mesh = make_mesh(1, 1, cfg.mesh_beads)
        elif n_dp * n_tp > 1:
            # driver.py:119-130, with the process group in place of the
            # visible devices
            if n_dp * n_tp != world:
                raise ValueError(
                    f"mesh_walkers*mesh_pairs={n_dp * n_tp} does not match "
                    f"the {world} ranks of the process group: run it as "
                    f"torchrun --nproc-per-node {n_dp * n_tp} -m "
                    "pathintegralgroundstate_torch in.in --set "
                    f"mesh_walkers={n_dp} --set mesh_pairs={n_tp}")
            if cfg.n_walkers % n_dp:
                raise ValueError(f"n_walkers={cfg.n_walkers} must divide "
                                 f"mesh_walkers={n_dp}")
            if n_tp > 1 and cfg.Np % n_tp:
                raise ValueError(f"Np={cfg.Np} must divide "
                                 f"mesh_pairs={n_tp}")
            self.mesh = make_mesh(n_dp, n_tp)
        if self.is_main:
            os.makedirs(out_dir, exist_ok=True)
        self.system: System = make_system(cfg, device, mesh=self.mesh)
        self.sweeper = Sweeper(self.system)
        if self.is_main:
            self._write_tables()
        if self.verbose and grouped:
            sp = (f", bead shards (sp) = {cfg.mesh_beads}"
                  if cfg.mesh_beads > 1 else "")
            print(f"# Process group       : {world} ranks, backend "
                  f"{self.backend}, mesh dp x tp = {n_dp} x {n_tp}{sp}")

        ckpt = os.path.join(out_dir, "checkpoint.npz")
        if cfg.resume and world > 1 and not os.path.exists(ckpt):
            # only rank 0 writes checkpoints; a fresh start on this rank
            # would mix resumed and fresh walkers into one ensemble
            raise RuntimeError(
                f"resume=True but {ckpt} is not visible on rank "
                f"{self.rank}: a multi-process resume needs the checkpoint "
                "on storage that every rank reaches")
        if cfg.resume and os.path.exists(ckpt):
            self.state, self.acc = self.load_checkpoint(ckpt)
        else:
            self.state = init_state(self.system,
                                    init_positions=init_positions)
            self.acc = self._zero_global()

    # ------------------------------------------------------------------

    def _zero_global(self):
        cfg = self.cfg
        return dict(
            diag_bl=0, obdm_bl=0, iblock=0,
            # OBDM super-block carry (vpi.f90:522-539): nrho accumulates
            # across blocks and is flushed only once at least one block's
            # worth of diagonal walker-steps has been collected
            idiag_aux=0.0,
            nrho_carry=np.zeros((cfg.Npw + 1, cfg.Nbin)),
            AvE=0.0, AvK=0.0, AvV=0.0, AvE2=0.0, AvK2=0.0, AvV2=0.0,
            AvEt=0.0, AvKt=0.0, AvVt=0.0, AvEt2=0.0, AvKt2=0.0, AvVt2=0.0,
            AvGr=np.zeros(cfg.Nbin), AvGr2=np.zeros(cfg.Nbin),
            AvSk=np.zeros((cfg.dim, cfg.Nk)), AvSk2=np.zeros((cfg.dim, cfg.Nk)),
            AvNr=np.zeros((cfg.Npw + 1, cfg.Nbin)),
            AvNr2=np.zeros((cfg.Npw + 1, cfg.Nbin)),
            AvDens=np.zeros((cfg.Nbin, cfg.Nbin)),
            AvDens2=np.zeros((cfg.Nbin, cfg.Nbin)),
            perm_hist=np.zeros(cfg.Np),
            # equilibration monitor (drift_z): per-block E means and
            # per-super-block OBDM weights
            hist_E=np.zeros(0),
            hist_n0=np.zeros(0),
        )

    def _write_tables(self):
        """Echo the tables as JastrowTable / PotentialTable do (jastrow.out,
        potential.out; vpi_mod.f90:96, 129; driver.py:214-229): r, exp(u)
        and u, or r and V, on the first min(Nmax, 10000) grid points."""
        tables, dr = self.system.tables, self.system.geo.dr
        n = min(self.cfg.Nmax, 10000)
        r = (np.arange(1, n + 1) - 1) * dr
        if tables.logwf is not None:
            wf = tables.logwf[1:n + 1].cpu().numpy()
            np.savetxt(os.path.join(self.out_dir, "jastrow.out"),
                       np.column_stack([r, np.exp(wf), wf]))
        if tables.vtab is not None:
            np.savetxt(os.path.join(self.out_dir, "potential.out"),
                       np.column_stack([r, tables.vtab[1:n + 1].cpu()
                                        .numpy()]))

    # ------------------------------------------------------------------

    def _block(self):
        """One block of Nstep steps: (state, block statistics).  With
        cfg.debug each step is checked, and the first non-finite path or
        statistic raises FloatingPointError naming the step."""
        cfg = self.cfg
        if not cfg.debug:
            return run_block(self.sweeper, self.state, cfg.Nstep, self.draws)
        state, stats = self.state, zero_stats(self.system)
        for _ in range(cfg.Nstep):
            state, stats = self.sweeper.step(state, stats, self.draws)
            bad = _nonfinite(state, stats)
            if bad is not None:
                raise FloatingPointError(
                    f"debug: non-finite {bad} after MC step {state.step}")
        return state, reduce_stats(self.system, stats)

    def _open(self, path, mode):
        """The output file on rank 0, a sink on every other rank."""
        return open(path if self.is_main else os.devnull, mode)

    def run_burnin(self, nblocks: int):
        """Equilibration: advance the ensemble without touching the global
        accumulators (the reference has no burn-in support; users discard
        early blocks by hand)."""
        for i in range(nblocks):
            t0 = time.time()
            self.state, _ = self._block()
            if self.state.paths.is_cuda:
                torch.cuda.synchronize(self.state.paths.device)
            if self.verbose:
                print(f"# burn-in block {i + 1}/{nblocks} "
                      f"({time.time() - t0:.1f}s)")
        self.save_checkpoint(os.path.join(self.out_dir, "checkpoint.npz"))

    def run(self, nblocks: int | None = None):
        """Block loop, one block after the other: each block's statistics
        are read back, reported and checkpointed before the next starts."""
        cfg = self.cfg
        nblocks = nblocks if nblocks is not None else cfg.Nblock
        mode = "a" if (cfg.resume or self.acc["iblock"] > 0) else "w"
        paths = [os.path.join(self.out_dir, f)
                 for f in ("e_vpi.out", "et_vpi.out", "metrics.jsonl")]
        with self._open(paths[0], mode) as fe, \
                self._open(paths[1], mode) as fet, \
                self._open(paths[2], mode) as fjl:
            for _ in range(nblocks):
                t0 = time.time()
                self.state, stats = self._block()
                self._consume_block(stats, t0, fe, fet, fjl)
        self.finalize()
        return self.acc

    def _consume_block(self, stats_dev, t0, fe, fet, fjl):
        cfg = self.cfg
        acc = self.acc
        # the block's one read-back of its statistics
        stats = stats_to_numpy(stats_dev)
        dt_block = time.time() - t0
        acc["iblock"] += 1
        ib = acc["iblock"]

        nd = float(stats["n_diag"])           # measured diagonal walker-steps
        nd_all = float(stats["n_diag_all"])   # ALL diagonal walker-steps
        blk = {}
        if nd > 0:
            for nm in ("E", "K", "V", "Et", "Kt", "Vt"):
                s = float(stats[f"sum{nm}"]) / nd
                s2 = float(stats[f"sum{nm}2"]) / nd
                blk[f"Av{nm}"] = s
                blk[f"Var{nm}"] = var(nd, s, s2)
            acc["diag_bl"] += 1
            for nm in ("E", "K", "V", "Et", "Kt", "Vt"):
                acc[f"Av{nm}"] += blk[f"Av{nm}"]
                acc[f"Av{nm}2"] += blk[f"Av{nm}"] ** 2

            if not cfg.trap:
                ngr = float(stats["ngr"])
                nid = shell_norm(cfg.dim, self.system.geo.density,
                                 self.system.geo.rbin, cfg.Nbin)
                gr = stats["gr"] / (nid * cfg.Np * max(ngr, 1.0))
                acc["AvGr"] += gr
                acc["AvGr2"] += gr * gr
                sk = stats["sk"] / (cfg.Np * max(ngr, 1.0))
                acc["AvSk"] += sk
                acc["AvSk2"] += sk * sk
            if cfg.density_map:
                # per-configuration mean counts; PrintDensity's /rbin^2 is
                # applied at output time (sample_mod.f90:645)
                dens = stats["dens"] / max(float(stats["ngr"]), 1.0)
                acc["AvDens"] += dens
                acc["AvDens2"] += dens * dens

            fe.write("%20.10e%20.10e%20.10e%20.10e\n" % (
                ib, blk["AvE"] / cfg.Np, blk["AvK"] / cfg.Np,
                blk["AvV"] / cfg.Np))
            fet.write("%20.10e%20.10e%20.10e%20.10e\n" % (
                ib, blk["AvEt"] / cfg.Np, blk["AvKt"] / cfg.Np,
                blk["AvVt"] / cfg.Np))

        # OBDM super-block (vpi.f90:522-539): accumulate nrho and the
        # diagonal-step count across blocks; flush into the global average
        # only when at least one block's worth of diagonal steps (Nstep*W)
        # has been collected.  The denominator counts every diagonal
        # walker-step, as nrho accumulates at every step.
        if cfg.CWorm > 0.0:
            acc["nrho_carry"] = acc["nrho_carry"] + stats["nrho"]
            acc["idiag_aux"] += nd_all
            if acc["idiag_aux"] / (cfg.Nstep * cfg.n_walkers) >= 1.0:
                acc["obdm_bl"] += 1
                nid = shell_norm(cfg.dim, self.system.geo.density,
                                 self.system.geo.rbin, cfg.Nbin)
                nrho = acc["nrho_carry"] / (
                    cfg.CWorm * nid[None, :] * acc["idiag_aux"]
                    * max(cfg.Nobdm, 1))
                acc["AvNr"] += nrho
                acc["AvNr2"] += nrho * nrho
                acc["idiag_aux"] = 0.0
                acc["nrho_carry"] = np.zeros_like(acc["nrho_carry"])
                # OBDM plateau monitor: total normalized m=0 weight per
                # super-block
                acc["hist_n0"] = np.append(acc["hist_n0"],
                                           float(np.sum(nrho[0])))

        acc["perm_hist"] += stats["perm_hist"]

        # ---- equilibration monitor (drift_z) ----
        zE = zn0 = 0.0
        if nd > 0:
            acc["hist_E"] = np.append(acc["hist_E"], blk["AvE"] / cfg.Np)
            zE = drift_z(acc["hist_E"])
        if cfg.CWorm > 0.0:
            zn0 = drift_z(acc["hist_n0"], min_n=6)
        for what, z, n in (
                ("energy block means", zE, len(acc["hist_E"])),
                ("OBDM super-block weight", zn0, len(acc["hist_n0"]))):
            if abs(z) > 3.0 and self.is_main:
                print(f"# WARNING: {what} drift z={z:+.1f} (first vs "
                      f"second half of {n} points) — the chain looks "
                      "non-stationary; burn-in was probably "
                      "insufficient (re-run with --burnin or discard "
                      "early blocks)")

        ctr = stats["counters"].astype(np.int64)
        c = {n: int(ctr[i]) for n, i in _CIDX.items()}
        W = cfg.n_walkers
        nsteps_tot = cfg.Nstep * W
        rec = dict(block=ib, time_s=dt_block, n_diag=nd,
                   diag_frac=nd_all / nsteps_tot,
                   drift_zE=round(zE, 3), drift_zn0=round(zn0, 3),
                   **{k: v / cfg.Np for k, v in blk.items()}, **c)
        # throughput: bead updates attempted per second (one definition:
        # sweep.bead_updates_per_step)
        rec["bead_updates"] = cfg.Nstep * W * bead_updates_per_step(cfg)
        rec["bead_updates_per_s"] = rec["bead_updates"] / max(dt_block, 1e-9)
        if self.backend is not None:
            # the route by layout and this rank's collectives so far
            rec["backend"] = self.backend
            if self.mesh is not None:
                rec["mesh"] = [self.mesh.dp, self.mesh.tp]
                if self.mesh.sp > 1:
                    rec["sp"] = self.mesh.sp
                rec["collectives"] = self.mesh.collectives
                rec["collective_s"] = self.mesh.coll_s
        fjl.write(json.dumps(rec) + "\n")
        fjl.flush()

        if self.verbose:
            self._print_block(ib, blk, c, nd_all, nsteps_tot, dt_block)

        # acceptance-collapse alarm: a dead move class signals a broken
        # action or step size
        n_int_trials = "try_int" if c.get("try_int", 0) > 0 else "try_stag"
        for trial, accepted, label in (
                ("try_cm", "acc_cm", "CM"),
                (n_int_trials, "acc_bd", "staging/bisection"),
                ("try_stag", "acc_head", "head"),
                ("try_stag", "acc_tail", "tail")):
            if self.is_main and c[trial] >= 1000 \
                    and c[accepted] < 0.005 * c[trial]:
                print(f"# WARNING: {label} acceptance collapsed "
                      f"({c[accepted]}/{c[trial]} = "
                      f"{100.0 * c[accepted] / c[trial]:.2f}%) — "
                      f"check dt/delta_cm/window sizes")

        # the state after this block matches the accumulators: the next
        # block has not started
        self.save_checkpoint(os.path.join(self.out_dir, "checkpoint.npz"))

    def _print_block(self, ib, blk, c, nd, nsteps_tot, dt_block):
        cfg = self.cfg
        Np = cfg.Np
        pct = lambda a, b: 100.0 * a / b if b > 0 else 0.0  # noqa: E731
        print("-----------------------------------------------------------")
        print(f"BLOCK NUMBER : {ib}")
        if blk:
            print(f"  > <E>  = {blk['AvE']/Np: .8g} +/- {blk['VarE']/Np:.3g}")
            print(f"  > <Ec> = {blk['AvK']/Np: .8g} +/- {blk['VarK']/Np:.3g}")
            print(f"  > <Ep> = {blk['AvV']/Np: .8g} +/- {blk['VarV']/Np:.3g}")
            print(f"  > <Et> = {blk['AvEt']/Np: .8g} +/- {blk['VarEt']/Np:.3g}")
            print(f"  > <Kt> = {blk['AvKt']/Np: .8g} +/- {blk['VarKt']/Np:.3g}")
            print(f"  > <Vt> = {blk['AvVt']/Np: .8g} +/- {blk['VarVt']/Np:.3g}")
        print("# Acceptance of diagonal movements:")
        print(f"> CM movements      = {pct(c['acc_cm'], c['try_cm']):7.2f} %")
        # the fused sweep counts interior-window tries separately (try_int)
        n_int = c["try_int"] if c.get("try_int", 0) > 0 else c["try_stag"]
        print(f"> Staging movements = {pct(c['acc_bd'], n_int):7.2f} %")
        print(f"> Head movements    = {pct(c['acc_head'], c['try_stag']):7.2f} %")
        print(f"> Tail movements    = {pct(c['acc_tail'], c['try_stag']):7.2f} %")
        if cfg.smart_mc > 0:
            print(f"> MALA movements    = {pct(c['acc_mala'], c['try_mala']):7.2f} %")
        if cfg.CWorm > 0:
            print("# Acceptance of off-diagonal movements:")
            print(f"> CM movements      = {pct(c['acc_cm_half'], c['try_cm_half']):7.2f} %")
            print(f"> Staging movements = {pct(c['acc_bd_half'], c['try_stag_half']):7.2f} %")
            print(f"> Head movements    = {pct(c['acc_head_half'], c['try_stag_half']):7.2f} %")
            print(f"> Tail movements    = {pct(c['acc_tail_half'], c['try_stag_half']):7.2f} %")
            print(f"> Diagonal conf.    = {pct(nd, nsteps_tot):7.2f} %")
            print(f"> Open acc          = {pct(c['acc_open'], c['try_open']):7.2f} %")
            print(f"> Close acc         = {pct(c['acc_close'], c['try_close']):7.2f} %")
            print(f"> Swap acc          = {pct(c['acc_swap'], c['try_swap']):7.2f} %")
        print(f"# Time per block    = {dt_block:9.3f} seconds")

    # ------------------------------------------------------------------

    def finalize(self):
        """Global averages + final profile outputs (vpi.f90:590-642)."""
        cfg, acc = self.cfg, self.acc
        nb = acc["diag_bl"]
        out = {}
        if nb > 0:
            for nm in ("E", "K", "V", "Et", "Kt", "Vt"):
                m = acc[f"Av{nm}"] / nb
                m2 = acc[f"Av{nm}2"] / nb
                out[nm] = m / cfg.Np
                out[f"Var{nm}"] = var(nb, m, m2) / cfg.Np
        if nb > 0 and self.is_main:
            r = (np.arange(1, cfg.Nbin + 1) - 0.5) * self.system.geo.rbin
            if not cfg.trap:
                avg = acc["AvGr"] / nb
                vg = np.sqrt(np.maximum(acc["AvGr2"] / nb - avg**2, 0) / nb)
                np.savetxt(os.path.join(self.out_dir, "gr_vpi.out"),
                           np.column_stack([r, avg, vg]))
                q = np.asarray(self.system.geo.qbin)[:, None] * np.arange(
                    1, cfg.Nk + 1)
                avs = acc["AvSk"] / nb
                vs = np.sqrt(np.maximum(acc["AvSk2"] / nb - avs**2, 0) / nb)
                cols = [q.T, avs.T, vs.T]
                np.savetxt(os.path.join(self.out_dir, "sk_vpi.out"),
                           np.hstack([c.reshape(cfg.Nk, -1) for c in cols]))
            if cfg.CWorm > 0:
                nob = max(acc["obdm_bl"], 1)
                avn = acc["AvNr"] / nob
                vn = np.sqrt(np.maximum(acc["AvNr2"] / nob - avn**2, 0) / nob)
                np.savetxt(os.path.join(self.out_dir, "nr_vpi.out"),
                           np.column_stack([r] + [x for m in
                                                  range(cfg.Npw + 1)
                                                  for x in (avn[m], vn[m])]))
            if cfg.density_map:
                self._write_density(acc["AvDens"] / nb)
        if cfg.swapping and self.is_main:
            np.savetxt(os.path.join(self.out_dir, "perm_histogram.out"),
                       np.column_stack([np.arange(1, cfg.Np + 1),
                                        acc["perm_hist"]]), fmt="%d %.0f")
        if self.verbose and out:
            print("==============================================================")
            print("FINAL RESULTS:")
            for nm in ("E", "K", "V", "Et", "Kt", "Vt"):
                print(f"  > <{nm}> = {out[nm]: .8g} +/- {out['Var'+nm]:.3g}")
        self.final = out
        return out

    def _write_density(self, avd):
        """density_vpi.out in PrintDensity's layout (sample_mod.f90:633-652):
        rows "x y dens/rbin^2" with x running inside y, a blank line after
        each y; x and y are the bins' upper edges."""
        geo, nbin = self.system.geo, self.cfg.Nbin
        avd = avd / geo.rbin ** 2
        with open(os.path.join(self.out_dir, "density_vpi.out"), "w") as fh:
            for j in range(nbin):
                yv = -0.5 * geo.rcut + (j + 1) * geo.rbin
                for i in range(nbin):
                    xv = -0.5 * geo.rcut + (i + 1) * geo.rbin
                    fh.write(f" {xv:.10g} {yv:.10g} {avd[i, j]:.10g}\n")
                fh.write("\n")

    # ------------------------------------------------------------------

    def save_checkpoint(self, path):
        """Full-state checkpoint (CheckPoint, vpi_mod.f90:263-309) as one
        npz archive: the walker ensemble, both generators' states
        (`gen_state`, `host_gen_state`: their get_state() bytes, read
        without a device sync) in place of the reference's key, the host
        step counter, the configuration and the global accumulators.
        Written to a temporary file, then moved into place.  Under walker
        sharding the walker slices are first gathered (every rank takes
        part), and rank 0 alone writes the unsharded layout."""
        st = gather_state(self.system, self.state)
        if not self.is_main:
            return
        gen, host = generator_states(st)
        arrs = dict(state_to_numpy(st), gen_state=gen, host_gen_state=host)
        scalars = {k: v for k, v in self.acc.items() if np.isscalar(v)}
        arrays = {f"acc_{k}": np.asarray(v) for k, v in self.acc.items()
                  if not np.isscalar(v)}
        tmp = path + ".tmp.npz"
        np.savez(tmp, __config__=json.dumps(dataclasses.asdict(self.cfg)),
                 __scalars__=json.dumps(scalars), **arrs, **arrays)
        os.replace(tmp, path)

    def load_checkpoint(self, path):
        """(state, accumulators) of a checkpoint written by save_checkpoint;
        both generators resume where they stopped."""
        z = np.load(path, allow_pickle=False)
        if "gen_state" not in z:
            raise ValueError(
                f"{path} holds no torch generator states ('gen_state'): "
                + ("it is a checkpoint of the JAX package, whose threefry "
                   "'key' the port cannot continue; start this run without "
                   "resume" if "key" in z else "not a checkpoint of this "
                   "package"))
        st = state_from_numpy(self.system, z)
        set_generator_states(st, z["gen_state"], z["host_gen_state"])
        acc = self._zero_global()
        acc.update(json.loads(str(z["__scalars__"])))
        for k in list(acc):
            if f"acc_{k}" in z:
                acc[k] = z[f"acc_{k}"]
        return st, acc

    def close(self):
        """Leave the process group that distributed=True opened, every rank
        together (a rank that exits while a peer still holds its gloo
        connection can abort)."""
        if self.cfg.distributed and dist.is_initialized():
            dist.barrier()
            dist.destroy_process_group()
