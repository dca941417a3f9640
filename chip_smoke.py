"""Drive the torch port's flagship paths once on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Phases (each prints one line or a short block; any failure raises, so the
run exits non-zero):
  1. device  : a CUDA device is required; its name and power limit.
  2. build   : nvcc builds pathintegralgroundstate_torch/csrc into build/
               (one nvcc per source, all started together).
  3. kernels : kernels A and B against their plain PyTorch forms at the
               flagship's shapes (kernel A's weighted rows and walker sums,
               with and without row weights, ib [B] and [W, B], also over
               the fused interior span with a per-window-row ip [1, B], and
               at each lane-group width at B=1 and B=65, with W chosen so
               that the wrapper's rule picks it), float32 and float64, then
               both timed with CUDA events: kernel A at B in 1, 2, 4, 8,
               16, 32, 65, L2-warm and L2-cold, at the lane-group width the
               rule picks; kernel B's two ThermEnergy calls (without and
               with force), each with its own bound.
  4. cascade : kernel 5 against its plain form (cascade_ref) at the
               flagship's shapes, modes 'ends' (S=2) and 'interior' (S=3),
               float64 and float32, then both timed; then kernels A and 5
               where a row of partners is no multiple of 16 bytes (N=30 in
               float32, N=31 in float64), which they stage element by
               element.
  5. pot     : kernel B at N=30 float32 and N=31 float64 (rows staged
               element by element) on both ThermEnergy views, on a view
               that starts off 16-byte alignment, on a row with two
               coincident particles (non-finite f2 from kernel and plain
               form alike), and two launches bitwise equal.
  6. dense   : the dense kernel (kernels 3 and 4 in one source,
               csrc/pair_delta.cu, one warp per row) against its plain
               forms: kernel 3's raw mode and kernel
               4's u mode at the end gate's shape [1024, 1, 64, 3] with ip
               scalar and at [1024, 16, 64, 3] with ip [W] and [W, B],
               float64 and float32; the action mode (the whole dense
               delta_action in one launch, u on the chain-end rows) at the
               gate's rows and over whole chains (end, odd and even
               interior rows), ib [B] and [W, B], with and without force,
               NaN where the reference gives NaN; then, in float32 at the
               gate's shape, the action mode on an end row and on an
               interior row (kernel 3 alone) in alternating turns, u's
               marginal time between them, the raw and u modes and the
               whole delta_action timed.
  7. dims    : every kernel at D = 1 and D = 2 under PBC (a 1-D chain,
               a 2-D He-4 film), float32 and float64, N = 30, 31 and 64,
               against its plain form: kernel A (windows, ip forms, rev,
               walker sums, every lane-group width), kernel B (both views),
               the dense kernel's raw, u and action modes, kernel 5 ends and
               interior; each case prints whether kernels A and B staged
               with 16-byte copies and kernel 5 with its bulk copy.
  8. replay  : one step at W=16 in float64 on the card and on the CPU
               (plain forms) from the same recorded draws, for the
               flagship and the reference-order step (per-level bisection,
               random end depth) at their full depth (Nstag=5, Nobdm=10),
               and with the depth cut to Nstag=1 and at most 2 worm rounds
               (every move site still runs; the cut saves about 60 s of
               the CPU side's plain forms) for the fused sweep with
               cascade off and on, the staging sampler with
               regrow='scan', the fused sweep in per-level form and the
               flagship's moves on a 2-D He-4 film: states,
               counters and statistics must agree.  Then the trap's
               replays (the trapped worm flagship, dim 2, and the 1-D
               oscillator with bisection), with every kernel's launch count
               0 across both: the trap runs the plain forms, as the
               reference routes it.
 8b. exact_f2: exact F^2 (exact_f2=T): kernel B on the brute path's end
               windows [1024, 16, 64, 3] (R and R with the moved particle
               at its proposal) and kernels 3 raw / 4 u on the same rows
               against their plain forms, float32 and float64; the dense
               exact delta_action and the brute window rows card == CPU
               in float64 with their launch counts; W=16 float64 replays
               (the depth cut to Nstag=1 and at most 2 worm rounds) of
               the cached flagship, reference order, fused sweep, worm with
               staging, the brute flagship and a MALA step (smart_mc > 0),
               kernels A and 5 launching 0 times across them; the cached
               and the brute flagship over 3 steps on the card equal.
  9. main    : six paths at W=1024 in float32, each with its launch
               counts set to 0 just before it and read just after: the
               flagship (unfused sweep), the fused sweep, the fused sweep
               with cascade=True, the reference-order step, and the exact-F^2
               flagship cached and brute (exact counts: A and 5 never, B
               twice per step, and without the cache twice per window
               call), each with its peak memory.  Each: one
               warm-up step, timed steps with the kernels' launch counts
               (exact where the move sites fix them; kernel A's from the
               end moves' drawn depths), the acceptance table,
               bead-updates/s, then one step under
               torch.cuda.set_sync_debug_mode("warn").
 9b. mala    : the cached exact flagship with MALA at W=256 float32: an eps
               scan, the eps whose acceptance lies in 30-80 %, its MALA
               phase timed (ms, acceptance, peak memory), one step's host
               syncs (0).
 10. cli     : `cli.main` on a namelist of the flagship at W=1024 float32,
               the launch counts set to 0 before each run and read after:
               the flagship order (Nstep=3, --blocks 2), the reference
               order (Nstep=2, --blocks 1: the dense kernel 2 Nstag Np
               times per step, kernel 4 never on its own), then the resume
               probe `python3 -m pathintegralgroundstate_torch ... --set
               resume=T --blocks 1` as a process of its own (BLOCK NUMBER :
               3, three finite rows of e_vpi.out); each block's
               bead-updates/s; then the flagship with exact_f2 = T and the
               MALA eps at W=256 (Nstep=2, --blocks 2): a MALA line per
               block, kernel B twice per step and no other kernel.
 11. trap    : `cli.main` on the card, each run with the launch counts
               set to 0 before and read after (all must stay 0): the 1-D
               oscillator with its exact trial WF (<E> = 0.5 +/- 0 in each
               block, E within 1e-12), the same with exact_f2 = T and
               smart_mc = 0.05, and the trapped worm flagship at
               W=256 float64, 3 blocks of 20 steps (E/N = 1 within 1e-12,
               finite non-empty nr_vpi.out and density_vpi.out); each
               block's ms/step and bead-updates/s and one step's host syncs.
 7b. variants: every kernel against its plain form for six pair models
               (potential/Jastrow aziz2/mcmillan_c1, soft/dipolar2d,
               dipolar/dipolar2d, dipolar/none, none/none, none/mcmillan_c1:
               every potential on every kernel, every Jastrow on every
               kernel that carries u) at the flagship's 3-D N=64 and the
               dipolar gas's 2-D N=256 shapes, float32 and float64; non-finite
               values (a coincident partner of the soft or dipolar core,
               soft's r^-12 overflow in float32) exactly where the plain
               form has them; then each kernel timed at the dipolar shapes
               in float64 beside its plain form and its bound.
 12. tables  : the three RefRNG goldens replayed on the card in float64
               (atol 1e-12, no kernel launch); BASELINE #2, the flagship's
               He-4 at Np=16 with v_table = wf_table = T, W=1024 float32,
               through cli.main (2 blocks, every launch count 0); v_table
               alone in the reference order, where only kernel 4 launches.
 13. dipolar : BASELINE #5, the 2-D dipolar gas at N=256 float64
               (flagship.dipolar_cfg): W=16 card == CPU replays without and
               with cascade, the path at W=1024 without and with cascade
               (main_path), cli.main with 2 burn-in and 2 blocks (E/N > 0,
               Et/N > 0, g[0] < 0.05, g[1] < 0.5), and the ideal Bose gas
               under PBC in the flagship's box and order through cli.main
               (<E> = 0 +/- 0 exactly in each block, the flagship's
               launches).
 9c. windows : per-walker windows (shared_windows=False): kernel A on
               gathered per-walker windows (ib [W, B], ip scalar and [W],
               rows and walker sums) against its float64 plain form,
               float32 and float64; the window's gather and scatter timed;
               a W=16 float64 step card == CPU on recorded draws (full
               depth); the
               flagship with per-walker windows as a main path (exact
               launch counts, equal to the shared flagship's, peak memory,
               0 host syncs), read beside [main]'s shared-window flagship,
               then both timed in turns (shared, per-walker, per-walker,
               shared; 2 steps each).
 15. mesh    : dp walker sharding over 2 ranks on the one card (gloo;
               torchrun starts the ranks, `chip_smoke.py --mesh-rank`):
               one Driver block of the flagship at global W=1024 float32
               (kernel A's lane width pinned from the global W; counters
               and perm_hist equal, the statistics within rtol 1e-5, the
               paths within 1e-4) and at
               W=64 float64 (rtol 1e-10) against the same blocks unsharded
               in this process, each rank's ms/step and collectives; then
               the dry run (parallel/dryrun.py) at dp 2 x tp 2 over 4
               ranks.
 16. dipolar mesh: BASELINE #5 at dp 2 x tp 2 over 4 ranks through the CLI
               (2 blocks of 2 steps, started by torchrun) against the
               unsharded CLI run: the outputs within rtol 1e-9, counters
               equal, rank 0 alone printing and writing; ms/step,
               collectives per step and their share.
 18. routes  : use_pallas=False (every kernel route off) on the flagship
               and the fused sweep with cascade, and a plug-in potential (a
               registered copy of the soft core) against the built-in soft:
               W=16 float64 steps on the card, each launching 0 kernels and
               equal to the kernel step on the same draws (the replay
               tolerances); then a W=1024 float32 flagship step with
               use_pallas=False timed (0 launches).
 19. sp      : the SP bead sharding (mesh_beads=4) over 4 ranks on the one
               card (gloo; torchrun starts `chip_smoke.py --sp-rank`): at
               W=16 float64, M=129, 3 sharded sweeps == sp_staging_sweep_ref
               on one process bit for bit (kernel A in both, the ring's halo
               == the local copy) and == the CPU's plain forms; the He-4
               long-M path (Np=64, M=257, W=1024 float32, staging Lstag=32,
               Nstag=5) per rank: 1 warm-up and 3 timed steps, exact
               launches, collectives and their ms by CUDA events, 0 host
               syncs outside the exchanges; the same path on one process
               as a main path; the CLI with --set mesh_beads=4 under
               torchrun (2 blocks of 2 steps), its E/N equal to the
               one-process blocks within float32 rtol 1e-5.
 17. imports : no JAX module and no module of the reference package
               (pathintegralgroundstate_tpu) was loaded.
The last two lines are the kernels JSON and the device JSON.  Each kernel's
bound_ms is the larger of its bytes (each input read once, each output
written once) over 3.35 TB/s and its operations over 67 TFLOP/s (float32
outside the tensor cores), the H100 SXM's published peaks, counted from
the inputs of its timed case (float64 cases: 34 TFLOP/s, the data sheet's
float64 rate outside the tensor cores); library_ms is null, as no single
PyTorch call computes these pair sums.  Each entry also carries its
launches over the 3 timed steps of the exact-F^2 flagship, cached and
brute, over the 3 timed steps of the per-walker-window flagship
(windows_launches), and over the 3 timed steps of the SP path on rank 0
(sp_launches).  The entries '[dipolar N=256 float64]' are the same
kernels at the dipolar gas's shapes, with their launches on the dipolar
path.
"""

import functools
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np
import torch


def _card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _events_ms(fn, reps=20):
    """Device ms per call of fn(): reps calls queued behind a device sleep,
    so the events time the device's work and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s of device cycles
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# Operations per pair and Metropolis side, counted from csrc/pigs_pair.cuh
# (an FMA counts two; exp, sqrt, rsqrt and a division one each): the
# minimum image and r^2 12, V and dV/dr 45 (V alone 25), the force sum 7,
# u 8, one per masked accumulate.
_OPS = {"rows": 12 + 2 + 45 + 1 + 7 + 8 + 1,        # kernel A, f2 and u
        "delta_force": 12 + 2 + 45 + 1 + 7,          # kernel 3
        "delta_pot": 12 + 1 + 25 + 1,                # kernel 3, no force
        "u": 12 + 1 + 8 + 1,                         # kernel 4
        "u_fused": 8 + 1,             # u from kernel 3's r and 1/r
        "pot_pair": 12 + 2 + 45 + 1 + 2 * 7,         # kernel B, per pair
        "pot_pair_plain": 12 + 1 + 25 + 1}           # kernel B, no force
_PEAK_BYTES, _PEAK_OPS = 3.35e12, 67e12              # H100 SXM, float32


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    tb, to = nbytes / _PEAK_BYTES * 1e3, ops / _PEAK_OPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _close(name, got, ref, rtol, atol, plain=None, near_cut=None):
    """Max abs error of got against the float64 reference ref.

    float64 (plain is None): every value within atol + rtol |ref|.
    float32: atol grows by twice the plain float32 form's own error at the
    99.99th percentile of the block (32-bit rounding of row sums whose
    terms cancel); a value beyond that must belong to a row with a partner
    within 1e-5 of the cutoff (near_cut), where a 32-bit r^2 lands on the
    other side of the rcut mask than the 64-bit one: V(rcut) = -0.042 K
    for aziz2 at the flagship's box.  Returns (max abs err, rows excused
    by the cutoff)."""
    # non-finite values (a coincident partner of a soft or dipolar core,
    # an overflow of r^-12 in float32): got must be non-finite exactly
    # where the plain form in its own type is (the float64 form where
    # there is none); the finite values are compared
    fin = torch.isfinite(plain if plain is not None else ref)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{name}: non-finite values differ from the "
                             f"plain form's ({int((~fin).sum())} there, "
                             f"{int((~torch.isfinite(got)).sum())} here)")
    if not bool(fin.all()):
        fin = fin & torch.isfinite(ref)
        got, ref = torch.where(fin, got, 0.0), torch.where(fin, ref, 0.0)
        if plain is not None:
            plain = torch.where(fin, plain, 0.0)
        if isinstance(atol, torch.Tensor):
            atol = torch.where(fin, atol, 0.0)
    err = (got.double() - ref).abs()
    if plain is not None:
        pe = (plain.double() - ref).abs().flatten()
        atol = atol + 2.0 * float(torch.quantile(pe, 0.9999))
    bad = ~(err <= atol + rtol * ref.abs())
    excused = 0
    if bool(bad.any()) and near_cut is not None:
        idx = bad.nonzero()
        cut = near_cut(idx)
        excused = int(cut.sum())
        bad[tuple(idx[cut].T)] = False
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} values beyond rtol={rtol} atol={atol}"
            f" (first: got {got.flatten()[i].item()!r}, "
            f"ref {ref.flatten()[i].item()!r})")
    return float(err.max()), excused


def _tol(dtype, name):
    """(rtol, atol).  float64 differs only by the summation order: rtol
    1e-11, atol 1e-9 for two potential sums that cancel and 1e-7 for the
    force terms, whose pair forces (~1e2 each) cancel to a net |F| and move
    |F|^2 by ~2 |F| eps sum|f_j| ~ 1e-9.  float32 takes the tolerances of
    tests/test_pallas_kernel.py (see _close)."""
    if dtype == torch.float64:
        return 1e-11, (1e-7 if name in ("df2", "f2") else 1e-9)
    return {"dpot": (2e-4, 1e-4), "du": (2e-4, 1e-4), "df2": (2e-4, 1e-3),
            "pot": (2e-4, 1e-3), "f2": (2e-4, 1e-2)}[name]


def _wrap(d, L):
    return torch.remainder(d + 0.5 * L, L) - 0.5 * L


def _near_cut_rows(system, R, xnew, xold, ip, rev):
    """For [k, 2] (w, b) row indices: whether the row has a partner within
    1e-5 of rcut^2 on either side (float64)."""
    L, rc2 = system.geo.Lbox[0], system.geo.rcut2

    def f(idx):
        w, b = idx[:, 0], idx[:, 1]
        br = R.shape[1] - 1 - b if rev else b
        P = R[w, br].double()                              # [k, N, D]
        if isinstance(ip, int):
            p = torch.full_like(w, ip)
        else:
            p = ip[w] if ip.dim() == 1 else ip.expand(R.shape[0], -1)[w, b]
        self_ = torch.arange(P.shape[1], device=P.device) == p[:, None]
        out = torch.zeros_like(w, dtype=torch.bool)
        for x in (xnew, xold):
            d2 = (_wrap(x[w, b].double()[:, None] - P, L) ** 2).sum(-1)
            near = ((d2 / rc2 - 1.0).abs() < 1e-5) & ~self_
            out |= near.any(-1)
        return out
    return f


def _near_cut_confs(system, R):
    """For [k, 2] (w, b) indices of configurations R: whether any pair lies
    within 1e-5 of rcut^2 (float64)."""
    L, rc2 = system.geo.Lbox[0], system.geo.rcut2

    def f(idx):
        P = R[idx[:, 0], idx[:, 1]].double()               # [k, N, D]
        d2 = (_wrap(P[:, :, None] - P[:, None], L) ** 2).sum(-1)
        return ((d2 / rc2 - 1.0).abs() < 1e-5).flatten(1).any(-1)
    return f


def _flagship_paths(cfg, W, dtype, device, seed, dmin=0.95):
    """Liquid-like worldlines: each walker's particles placed by random
    sequential addition with a minimum distance dmin (no lattice shell at
    the cutoff), then 0.03 of gaussian noise per bead."""
    x = _paths64(cfg.Np, cfg.dim, cfg.density, cfg.M, W, seed, dmin)
    return x.to(device=device, dtype=dtype, copy=True)


@functools.lru_cache(maxsize=16)
def _paths64(N, D, density, M, W, seed, dmin):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L = (N / density) ** (1.0 / D)
    X = torch.zeros(W, N, D, dtype=torch.float64)
    for i in range(N):
        todo = torch.ones(W, dtype=torch.bool)
        while bool(todo.any()):
            c = (torch.rand(W, D, generator=g, dtype=torch.float64) - 0.5) * L
            ok = todo.clone()
            if i:
                d2 = (_wrap(c[:, None] - X[:, :i], L) ** 2).sum(-1)
                ok &= d2.min(1).values > dmin * dmin
            X[ok, i] = c[ok]
            todo &= ~ok
    x = X[:, None] + 0.03 * torch.randn(W, M, N, D, generator=g,
                                        dtype=torch.float64)
    return _wrap(x, L)


def _rows_tol(sys64, dtype, R, xnew, xold, ip, ib, need_wf, need_f2, rev,
              rw, reduce):
    """Absolute tolerance of each value of kernel A's weighted output: each
    raw term's own (_tol: atol + rtol |term|, the term from the float64
    plain form) weighted as the term is, times |rw|, summed over the
    walker's rows with reduce."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    terms = K.pair_terms_ref(sys64, R.double(), xnew.double(), xold.double(),
                             ip, need_wf, need_f2, rev)
    w = chin_table(sys64)[:, ib]
    tol = 0.0
    for i, name in enumerate(("dpot", "df2", "du")):
        if terms[i] is not None:
            rtol, atol = _tol(dtype, name)
            tol = tol + w[i] * (atol + rtol * terms[i].abs())
    if rw is not None:
        tol = tol * rw.double().abs()
    return tol.sum(-1) if reduce else tol


def rows_parity(system, sys64, R, xnew, xold, ip, ib, rev, flags, label,
                rw=None, reduce=False):
    """Kernel A (kernels.pair_rows) against its float64 plain form on the
    same inputs, for each (need_wf, need_f2) of flags: float64 within the
    raw terms' tolerances of _tol, weighted as the terms; float32 also
    within twice the plain float32 form's own error (see _close).  Returns
    (max abs err, values excused by the cutoff, cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    f32 = system.dtype == torch.float32
    near = None
    if f32:
        rows_near = _near_cut_rows(system, R, xnew, xold, ip, rev)
        B = R.shape[1]

        def near(idx):
            if not reduce:
                return rows_near(idx)
            w = idx[:, 0].repeat_interleave(B)
            b = torch.arange(B, device=w.device).repeat(len(idx))
            return rows_near(torch.stack([w, b], 1)).view(-1, B).any(-1)
    rw64 = rw.double() if rw is not None else None
    err, excused = 0.0, 0
    for need_wf, need_f2 in flags:
        got = K.pair_rows(system, R, xnew, xold, ip, chin_table(system), ib,
                          need_wf, need_f2, rev, rw, reduce)
        ref = K.pair_rows_ref(sys64, R.double(), xnew.double(),
                              xold.double(), ip, chin_table(sys64), ib,
                              need_wf, need_f2, rev, rw64, reduce)
        plain = (K.pair_rows_ref(system, R, xnew, xold, ip,
                                 chin_table(system), ib, need_wf, need_f2,
                                 rev, rw, reduce) if f32 else None)
        tol = _rows_tol(sys64, system.dtype, R, xnew, xold, ip, ib, need_wf,
                        need_f2, rev, rw, reduce)
        e, n = _close(f"pair_rows {system.dtype} {label} rev={rev} "
                      f"reduce={reduce} wf={need_wf} "
                      f"f2={need_f2}", got, ref, 0.0, tol, plain, near)
        err, excused = max(err, e), excused + n
    return err, excused, len(flags)


def _window_ip(R, ip, g, sigma=0.05):
    """(xnew, xold) of the window R [W, B, N, D] for ip (int, [W], [W, B]
    or [1, B]): xold the moved particle's positions, xnew a gaussian step
    away, with one exactly coincident partner (the worm-pin case)."""
    W, B, N, D = R.shape
    if isinstance(ip, int):
        xold = R[:, :, ip]
    elif ip.dim() == 1:
        xold = R[torch.arange(W, device=R.device), :, ip]
    else:
        xold = R.gather(2, ip.expand(W, B)[:, :, None, None].expand(
            W, B, 1, D))[:, :, 0]
    xnew = xold + sigma * torch.randn(xold.shape, generator=g,
                                      device=R.device, dtype=R.dtype)
    p3 = ip if isinstance(ip, int) else int(
        ip[3] if ip.dim() == 1 else ip.expand(W, B)[3, B // 2])
    xnew[3, B // 2] = R[3, B // 2, (p3 + 1) % N]
    return xnew, xold


def lanes_walkers(G, B, N=64):
    """The fewest walkers at which kernel A's rule (kernels.rows_lanes)
    runs G lanes per row for windows of B rows."""
    from pathintegralgroundstate_torch.ops import kernels as K

    W = -(-K.ROWS_FILL // (G * B))
    if K.rows_lanes(W, B, N) != G:
        raise AssertionError(f"rows_lanes({W}, {B}, {N}) is not {G}")
    return W


def lanes_parity(cfg, dtype, seed=5, base=256):
    """Each lane-group width of kernel A against the plain form at B=1 and
    B=65 (the last B beads of liquid-like paths of `base` walkers, repeated
    to lanes_walkers(G, B) walkers), with ip scalar and [1, B], rows and
    walker sums.  Returns (max abs err, values excused by the cutoff,
    cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, dtype)
    sys64 = make_system(cfg, dev, torch.float64)
    paths = _flagship_paths(cfg, base, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    N, M = cfg.Np, cfg.M
    err, excused, n = 0.0, 0, 0
    for B in (1, 65):
        ib = torch.arange(M - B, M, device=dev)
        for G in K.ROWS_LANES:
            W = lanes_walkers(G, B, N)
            R = paths[:, M - B:].repeat(-(-W // base), 1, 1, 1)[:W]
            for ip in (7, torch.randint(0, N, (1, B), generator=g,
                                        device=dev)):
                xnew, xold = _window_ip(R, ip, g)
                for reduce in (False, True):
                    e, x, c = rows_parity(
                        system, sys64, R, xnew, xold, ip, ib, False,
                        [(True, True), (False, False)],
                        f"B={B} W={W} G={G} ip={ip}", reduce=reduce)
                    err, excused, n = max(err, e), excused + x, n + c
    return err, excused, n


def kernel_parity(cfg, card, W=1024):
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    N, D, M = cfg.Np, cfg.dim, cfg.M
    sys64 = make_system(cfg, dev, torch.float64)
    errs = {"pair_rows": 0.0, "pair_pot": 0.0}   # float64: kernel vs plain
    excused = {"pair_rows": 0, "pair_pot": 0}    # float32 rows at the cutoff
    ncase = 0
    for dtype in (torch.float32, torch.float64):
        system = make_system(cfg, dev, dtype)
        paths = _flagship_paths(cfg, W, dtype, dev, seed=1)
        g = torch.Generator(device=dev).manual_seed(2)
        f32 = dtype == torch.float32
        half = torch.ones(65, dtype=dtype, device=dev)
        half[0] = 0.5                                 # the worm centre's 1/2

        def check(*args, **kw):
            nonlocal ncase
            e, x, c = rows_parity(system, sys64, *args, **kw)
            excused["pair_rows"] += x
            if not f32:
                errs["pair_rows"] = max(errs["pair_rows"], e)
            ncase += c

        every = [(wf, f2) for wf in (True, False) for f2 in (True, False)]
        for B in (15, 16, 30, 32, 33, 65):
            lo = (M - B) // 2
            R = paths[:, lo:lo + B]                     # strided window view
            ibs = (torch.arange(lo, lo + B, device=dev),
                   torch.randint(0, M, (W, B), generator=g, device=dev))
            ipw = torch.randint(0, N, (W,), generator=g, device=dev)
            ipwb = torch.randint(0, N, (W, B), generator=g, device=dev)
            for k, ip in enumerate((7, ipw, ipwb)):
                xnew, xold = _window_ip(R, ip, g)
                for rev in (False, True):
                    reduce = bool((k + rev) % 2)
                    check(R, xnew, xold, ip, ibs[k % 2], rev, every,
                          f"B={B}", rw=half[:B] if reduce else None,
                          reduce=reduce)
        # the fused interior span of bisection_multi: K=3 slots of L links
        # from an even shift s, rows s+1..s+KL-1 read in place, ip [1, B]
        # per window row; the slot-boundary rows are unmoved (dS exactly 0)
        L, s0 = 2 ** cfg.Nlev, 2
        B = 3 * L - 1
        R = paths[:, s0 + 1:s0 + 1 + B]
        ib = torch.arange(s0 + 1, s0 + 1 + B, device=dev)
        ip = torch.cat([torch.full((L,), p, dtype=torch.long, device=dev)
                        for p in (7, 30, 61)])[None, 1:]
        xnew, xold = _window_ip(R, ip, g)
        xnew[:, L - 1::L] = xold[:, L - 1::L]
        check(R, xnew, xold, ip, ib, False, [(False, True)],
              f"B={B} span ip[1, B]")
        got = K.pair_rows(system, R, xnew, xold, ip,
                          chin_table(system), ib, False, True)
        if bool(got[:, L - 1::L].any()):
            raise AssertionError("pair_rows span: an unmoved slot-boundary "
                                 "row has a nonzero dS")
        e, x, c = lanes_parity(cfg, dtype)
        excused["pair_rows"] += x
        if not f32:
            errs["pair_rows"] = max(errs["pair_rows"], e)
        ncase += c
        for sl in (slice(0, M - 1, 2), slice(1, M - 1, 2)):
            R = paths[:, sl]
            near = _near_cut_confs(system, R)
            for wf in (False, True):
                got = K.pair_pot(system, R, wf)
                ref = K.pair_pot_ref(sys64, R.double(), wf)
                plain = K.pair_pot_ref(system, R, wf) if f32 else (None, None)
                for i, name in enumerate(("pot", "f2")):
                    e, n = _close(f"pair_pot {dtype} force={wf} {name}",
                                  got[i], ref[i], *_tol(dtype, name),
                                  plain[i], near if f32 else None)
                    excused["pair_pot"] += n
                    if not f32:
                        errs["pair_pot"] = max(errs["pair_pot"], e)
                ncase += 1
    torch.cuda.synchronize()
    print(f"[kernels] {ncase} parity cases pass against the plain form in "
          f"float64 on the same inputs (kernel A at each lane-group width "
          f"{K.ROWS_LANES} too): float64 max abs err pair_rows "
          f"{errs['pair_rows']:.3e}, pair_pot {errs['pair_pot']:.3e} (rtol "
          f"1e-11, atol 1e-9, forces 1e-7, weighted as the terms); float32 "
          f"values beyond tolerance, each at a partner within 1e-5 of "
          f"rcut^2: pair_rows {excused['pair_rows']}, pair_pot "
          f"{excused['pair_pot']}")

    shapes, bounds = rows_timing(cfg, card, W)
    system = make_system(cfg, dev, torch.float32)
    paths = _flagship_paths(cfg, W, torch.float32, dev, seed=3)
    for wf in (False, True):
        R = paths[:, wf::2][:, :cfg.Nb]
        shapes[f"pair_pot [1024,32,64,3] force={wf}"] = (
            _events_ms(lambda: K.pair_pot(system, R, wf)),
            _events_ms(lambda: K.pair_pot_ref(system, R, wf)))
    R = paths[:, 1::2][:, :cfg.Nb]
    for wf, key in ((False, "pot_pair_plain"), (True, "pot_pair")):
        bounds[f"pair_pot force={wf}"] = _bound(
            _nbytes(R) + 2 * W * cfg.Nb * 4,
            W * cfg.Nb * N * (N - 1) // 2 * _OPS[key])
    for name, (k, p) in shapes.items():
        print(f"[time] {name}: kernel {k:.4f} ms, plain {p:.4f} ms "
              f"({card})")
    for name, (b, by) in bounds.items():
        print(f"[bound] {name} at its timed case: {b:.5f} ms ({by}; "
              f"{card})")
    return errs, shapes, bounds


ROWS_TIMED_B = (1, 2, 4, 8, 16, 32, 65)


def rows_case(cfg, W, B, seed=3):
    """Kernel A's inputs of an end move's window of B rows at W walkers,
    float32, ip scalar (5), both chain-end rows weighted: (system, window
    pairs for L2-cold rotation, ib).  The window is paths[:, :B] of
    liquid-like paths; for the L2-cold case, enough distinct windows [W,
    B, N, D] (contiguous copies) that more than 64 MB are read between two
    reads of one."""
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, torch.float32)
    paths = _flagship_paths(cfg, W, torch.float32, dev, seed)
    R = paths[:, :B]
    xold = R[:, :, 5]
    xnew = (xold + 0.05).contiguous()
    nbuf = 2 + (64 << 20) // _nbytes(R)
    cold = [(R.contiguous() if i == 0 else
             R.roll(i, 0).contiguous(), xnew.roll(i, 0), xold.roll(i, 0))
            for i in range(nbuf)]
    return system, (R, xnew, xold), cold, torch.arange(B, device=dev)


def rows_bound(cfg, W, B):
    """(bound_ms, by) of one kernel-A pass over W x B rows with f2 and u,
    float32: bytes of the window, both positions, ib, the Chin table and
    the rows out; operations of both sides of every pair."""
    N, D, M = cfg.Np, cfg.dim, cfg.M
    return _bound(W * B * N * D * 4 + 2 * W * B * D * 4 + B * 8 + 3 * M * 4
                  + W * B * 4, 2 * W * B * N * _OPS["rows"])


def time_rows(system, case, cold, ib):
    """(L2-warm ms, L2-cold ms) of kernel A on one window, and on the
    rotation of `cold` windows, by CUDA events over 20 (warm) or at least
    as many launches as windows (cold)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    tab = chin_table(system)

    def fn(R, xn, xo):
        return K.pair_rows(system, R, xn, xo, 5, tab, ib, True, True)
    warm = _events_ms(lambda: fn(*case))
    it = iter(range(1 << 30))
    cold_ms = _events_ms(lambda: fn(*cold[next(it) % len(cold)]),
                         reps=max(20, len(cold)))
    return warm, cold_ms


def rows_timing(cfg, card, W=1024):
    """Kernel A at W=1024, float32, at B in ROWS_TIMED_B (the reference
    order's levels, the flagship's end and interior windows, the worm half
    and the CM move): L2-warm and L2-cold, each with the lanes per row the
    rule picks and its bound; then the plain form at the B=16 end move (the
    kernels JSON's timed case).  Returns (shapes, bounds) for the JSON."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    N = cfg.Np
    shapes, bounds = {}, {}
    for B in ROWS_TIMED_B:
        system, case, cold, ib = rows_case(cfg, W, B)
        G = K.rows_lanes(W, B, N)
        b, by = rows_bound(cfg, W, B)
        warm, cold_ms = time_rows(system, case, cold, ib)
        print(f"[time] pair_rows B={B} W={W} end move f2+u float32: chosen "
              f"G={G}: L2-warm {warm:.4f} ms, L2-cold {cold_ms:.4f} ms "
              f"({len(cold)} windows), bound {b:.5f} ms ({by}; {card})")
        if B == 16:
            plain = _events_ms(lambda: K.pair_rows_ref(
                system, *case, 5, chin_table(system), ib, True, True))
            shapes["pair_rows B=16 end move"] = (warm, plain)
            bounds["pair_rows"] = (b, by)
        del case, cold
    return shapes, bounds


def _cascade_inputs(cfg, W, dtype, mode, seed):
    """(system, paths, slots, rg, ru, act) of one flagship-shaped cascade
    move on the card; about one slot in ten inactive."""
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, dtype)
    paths = _flagship_paths(cfg, W, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, M = 2 ** cfg.Nlev, cfg.M
    if mode == "ends":
        slots = [(0, 1, 5), (M - 1, -1, 5)]
    else:
        slots = [(2 + k * L, 1, p * cfg.Np // 64)
                 for k, p in enumerate((7, 30, 61))]
    S, G = len(slots), cfg.Nlev + (mode == "ends")
    rg = torch.randn((W, S, L + 1, cfg.dim), generator=g, device=dev,
                     dtype=dtype)
    ru = torch.rand((W, S, G), generator=g, device=dev, dtype=dtype)
    act = torch.rand((W, S), generator=g, device=dev) < 0.9
    return system, paths, slots, rg, ru, act


def cascade_check(cfg, W, dtype, mode, seed=11, outcomes="both"):
    """Kernel 5 against cascade_ref (plain pair pass) on the same inputs.

    float64: accepts exactly equal, paths within rtol 1e-11 (atol 1e-12
    for coordinates near 0).  float32: decisions agree on more than 95 %
    of the slots, and where they agree the slot's window within rtol 2e-4 /
    atol 2e-5 (tests/test_cascade.py's criteria); every other bead exactly
    unchanged.  outcomes: 'both' (some active slots accepted and some
    not: the default), 'all' (every active slot accepted: the ideal gas,
    whose gates all see dS = 0) or 'any'.  Returns (agreement share, max
    abs err where agreeing, accepted slots)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref

    system, paths, slots, rg, ru, act = _cascade_inputs(cfg, W, dtype, mode,
                                                        seed)
    nlev, L = cfg.Nlev, 2 ** cfg.Nlev
    got, ref = paths.clone(), paths.clone()
    n = K.cascade.launches
    acc = K.cascade(system, mode, got, slots, rg, ru, act, nlev)
    acc_ref = cascade_ref(system, mode, ref, slots, rg, ru, act, nlev,
                          K.pair_rows_ref)
    torch.cuda.synchronize()
    if K.cascade.launches != n + 1:
        raise AssertionError("cascade did not count its launch")
    n_acc, n_act = int(acc.sum()), int(act.sum())
    if outcomes == "both" and not 0 < n_acc < n_act:
        raise AssertionError(f"cascade {mode}: {n_acc} of {n_act} active "
                             "slots accepted; the check needs both outcomes")
    if outcomes == "all" and n_acc != n_act:
        raise AssertionError(f"cascade {mode}: {n_acc} of {n_act} active "
                             "slots accepted; every gate sees dS = 0")
    if bool((acc & ~act).any()):
        raise AssertionError(f"cascade {mode}: an inactive slot accepted")
    agree = acc == acc_ref
    share = float(agree.double().mean())
    moved = torch.zeros(paths.shape[:3], dtype=torch.bool, device=paths.device)
    err = 0.0
    for s, (b0, step, ip) in enumerate(slots):
        beads = torch.arange(L + 1, device=paths.device) * step + b0
        moved[:, beads, ip] = True
        a = agree[:, s]
        wg, wr = got[a][:, beads, ip], ref[a][:, beads, ip]
        if dtype == torch.float64:
            torch.testing.assert_close(wg, wr, rtol=1e-11, atol=1e-12)
        else:
            torch.testing.assert_close(wg, wr, rtol=2e-4, atol=2e-5)
        err = max(err, float((wg - wr).abs().max()))
    if dtype == torch.float64 and share != 1.0:
        raise AssertionError(f"cascade {mode} float64: accepts differ on "
                             f"{int((~agree).sum())} slots")
    if share <= 0.95:
        raise AssertionError(f"cascade {mode} {dtype}: decisions agree on "
                             f"{share:.4f} of the slots, not > 0.95")
    if not (torch.equal(got[~moved], paths[~moved])
            and torch.equal(ref[~moved], paths[~moved])):
        raise AssertionError(f"cascade {mode}: a bead outside the slots' "
                             "windows moved")
    return share, err, n_acc


def cascade_parity(cfg, card):
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref

    W = 1024
    err64 = 0.0
    for dtype in (torch.float64, torch.float32):
        for mode in ("ends", "interior"):
            share, err, n_acc = cascade_check(cfg, W, dtype, mode)
            if dtype == torch.float64:
                err64 = max(err64, err)
            print(f"[cascade] {mode} W={W} {str(dtype)[6:]}: decisions "
                  f"agree on {share:.6f} of the slots, max abs err "
                  f"{err:.3e} where they agree, {n_acc} slots accepted")
    times = {}
    for mode in ("ends", "interior"):
        system, paths, slots, rg, ru, act = _cascade_inputs(
            cfg, W, torch.float32, mode, seed=12)
        k = _events_ms(lambda: K.cascade(system, mode, paths, slots, rg, ru,
                                         act, cfg.Nlev))
        p = _events_ms(lambda: cascade_ref(system, mode, paths, slots, rg,
                                           ru, act, cfg.Nlev,
                                           K.pair_rows_ref))
        # the bound counts what these inputs need: every displaced row of
        # an accepted slot, the first row pass of a rejected one (it may
        # have read more before its first failed gate: a lower bound)
        acc = K.cascade(system, mode, paths.clone(), slots, rg, ru, act,
                        cfg.Nlev)
        L, N, D = 2 ** cfg.Nlev, cfg.Np, cfg.dim
        n_acc = int(acc.sum())
        nrows = (n_acc * (L if mode == "ends" else L - 1)
                 + int((act & ~acc).sum()))
        es = paths.element_size()
        times[mode] = (k, p, _bound(
            nrows * N * D * es + _nbytes(rg, ru, act)
            + W * len(slots) * (L + 1) * D * es + n_acc * L * D * es,
            2 * nrows * N * _OPS["delta_force"]))
        print(f"[time] cascade {mode} S={len(slots)} [1024, {len(slots)}, "
              f"{L + 1}, {N}, 3] float32: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms, bound {times[mode][2][0]:.5f} ms "
              f"({times[mode][2][1]}; {card})")
    return err64, times


def layout_parity(cfg, W=256):
    """Kernels A and 5 where a row of partners is no multiple of 16 bytes,
    so that both stage the partners element by element: N=30 in float32
    (N*D*4 = 360 bytes) and N=31 in float64 (744 bytes), against the plain
    forms with the tolerances above.  Kernel A: windows of B=16 and 65 read
    in place, ip scalar, [W] and [W, B], forward and reversed, rows and
    walker sums; kernel 5: both modes (cascade_check).  Returns the cases."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    n, shares = 0, []
    for dtype, Np in ((torch.float32, 30), (torch.float64, 31)):
        c = cfg.replace(Np=Np)
        system = make_system(c, dev, dtype)
        sys64 = make_system(c, dev, torch.float64)
        paths = _flagship_paths(c, W, dtype, dev, seed=31)
        if K.slabs16(paths):
            raise AssertionError(f"N={Np} {dtype}: rows are 16-byte slabs")
        g = torch.Generator(device=dev).manual_seed(31)
        for B in (16, 65):
            R = paths[:, c.M - B:]
            ib = torch.arange(c.M - B, c.M, device=dev)
            ips = (7, torch.randint(0, Np, (W,), generator=g, device=dev),
                   torch.randint(0, Np, (W, B), generator=g, device=dev))
            for k, ip in enumerate(ips):
                xnew, xold = _window_ip(R, ip, g)
                for rev in (False, True):
                    n += rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                     rev, [(True, True), (False, False)],
                                     f"N={Np} B={B}",
                                     reduce=bool((k + rev) % 2))[2]
        for mode in ("ends", "interior"):
            shares.append(cascade_check(c, W, dtype, mode)[0])
            n += 1
    print(f"[layout] {n} parity cases of kernels A and 5 pass where the "
          f"partners are staged element by element (N=30 float32, N=31 "
          f"float64, W={W}); kernel 5 decisions agree on "
          + ", ".join(f"{s:.6f}" for s in shares) + " of the slots")
    return n


def _by_walkers(fn, R, chunk):
    """fn(R) of a plain form returning a tuple of [W, ...] tensors, computed
    on chunks of `chunk` walkers (the plain forms' [W, B, N, N, D] pair
    tensors of a whole W=1024, N=256 batch would take tens of GB)."""
    outs = [fn(R[i:i + chunk]) for i in range(0, R.shape[0], chunk)]
    return tuple(torch.cat(o) for o in zip(*outs))


def pot_check(system, sys64, R, label, chunk=256):
    """Kernel B (kernels.pair_pot) without and with force against its
    float64 plain form on the same inputs (_close with _tol: float32 also
    within twice the plain float32 form's own error); the plain forms run
    on `chunk` walkers at a time.  Returns (max abs err, values excused by
    the cutoff)."""
    from pathintegralgroundstate_torch.ops import kernels as K

    f32 = system.dtype == torch.float32
    near = _near_cut_confs(system, R) if f32 else None
    err, excused = 0.0, 0
    for wf in (False, True):
        got = K.pair_pot(system, R, wf)
        ref = _by_walkers(lambda r: K.pair_pot_ref(sys64, r.double(), wf),
                          R, chunk)
        plain = (_by_walkers(lambda r: K.pair_pot_ref(system, r, wf), R,
                             chunk) if f32 else (None, None))
        for i, name in enumerate(("pot", "f2")):
            e, n = _close(f"pair_pot {system.dtype} {label} force={wf} "
                          f"{name}", got[i], ref[i], *_tol(system.dtype, name),
                          plain[i], near)
            err, excused = max(err, e), excused + n
    return err, excused


def pot_parity(cfg, W=256):
    """Kernel B beyond the flagship's aligned views: N=30 float32 and N=31
    float64 (rows of partners that are no 16-byte multiple, staged element
    by element) and N=64 in both types, each on both ThermEnergy views
    paths[:, 0:M-1:2] and paths[:, 1:M-1:2]; the odd view of a copy that
    starts one element past 16-byte alignment; a row with two exactly
    coincident particles, whose f2 must be non-finite from the kernel and
    the plain form alike while every other value agrees; and two launches
    on the flagship's views at W=1024 bitwise equal.  Returns the float64
    max abs err."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    n, err64, excused = 0, 0.0, 0
    for dtype, Np in ((torch.float32, 30), (torch.float64, 31),
                      (torch.float32, 64), (torch.float64, 64)):
        c = cfg.replace(Np=Np)
        system = make_system(c, dev, dtype)
        sys64 = make_system(c, dev, torch.float64)
        paths = _flagship_paths(c, W, dtype, dev, seed=33)
        M = c.M
        views = [(paths[:, 0:M - 1:2], "even view"),
                 (paths[:, 1:M - 1:2], "odd view")]
        flat = torch.empty(paths.numel() + 1, dtype=dtype, device=dev)
        flat[1:] = paths.flatten()
        views.append((flat[1:].view(paths.shape)[:, 1:M - 1:2],
                      "odd view, unaligned start"))
        for R, label in views:
            if K.slabs16(R) != (Np == 64 and "unaligned" not in label):
                raise AssertionError(f"pair_pot N={Np} {label}: slabs16 is "
                                     f"{K.slabs16(R)}")
            e, x = pot_check(system, sys64, R, f"N={Np} {label}")
            excused += x
            if dtype == torch.float64:
                err64 = max(err64, e)
            n += 2
        R = paths[:, 1:M - 1:2].clone()
        R[3, 5, 7] = R[3, 5, 8]
        got = K.pair_pot(system, R, True)
        plain = K.pair_pot_ref(system, R, True)
        for name, f2 in (("kernel", got[1]), ("plain form", plain[1])):
            if bool(torch.isfinite(f2[3, 5])) \
                    or not bool(torch.isfinite(got[0][3, 5])):
                raise AssertionError(f"pair_pot N={Np} {dtype}: coincident "
                                     f"pair, {name} f2 {float(f2[3, 5])}, "
                                     f"pot {float(got[0][3, 5])}")
        ref = K.pair_pot_ref(sys64, R.double(), True)
        f32 = dtype == torch.float32
        for i, name in enumerate(("pot", "f2")):
            g, r, p = got[i].clone(), ref[i].clone(), plain[i].clone()
            if name == "f2":          # the coincident row, checked above
                g[3, 5] = r[3, 5] = p[3, 5] = 0.0
            _close(f"pair_pot N={Np} {dtype} coincident pair {name}", g, r,
                   *_tol(dtype, name), p if f32 else None,
                   _near_cut_confs(system, R) if f32 else None)
        n += 1
    system = make_system(cfg, dev, torch.float32)
    paths = _flagship_paths(cfg, 1024, torch.float32, dev, seed=35)
    for wf in (False, True):
        R = paths[:, int(wf):cfg.M - 1:2]
        a, b = K.pair_pot(system, R, wf), K.pair_pot(system, R, wf)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            raise AssertionError(f"pair_pot force={wf}: two launches on the "
                                 "same input differ")
        n += 1
    torch.cuda.synchronize()
    print(f"[pot] {n} cases of kernel B pass: N=30 float32, N=31 float64 and "
          f"N=64 on both ThermEnergy views and an unaligned view (float64 "
          f"max abs err {err64:.3e}; float32 values beyond tolerance, each "
          f"at a pair within 1e-5 of rcut^2: {excused}), a coincident pair "
          f"(non-finite f2 from kernel and plain form), two launches "
          f"bitwise equal at [1024, 32, 64, 3] without and with force")
    return err64


def dense_wf(system, with_force):
    """The dense F^2 weight delta_action passes kernel 3."""
    dt = system.cfg.dt
    return (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0


def action_check(system, sys64, R, xnew, xold, ip, ib, with_force, label):
    """The dense action delta in one launch (kernels.pair_delta given the
    Chin table: kernel 3 with kernel 4's pass on the chain-end rows) against
    its float64 plain form on the same inputs: NaN or inf exactly where the
    plain form does; elsewhere within the raw terms' tolerances of _tol
    weighted as the terms, float32 also within twice the plain float32
    form's own error (see _close).  Returns (max abs err, values excused by
    the cutoff, non-finite rows)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    f32 = system.dtype == torch.float32
    wf = dense_wf(system, with_force)
    got = K.pair_delta(system, R, xnew, xold, ip, with_force,
                       chin_table(system), ib, wf)
    args64 = (R.double(), xnew.double(), xold.double(), ip)
    du64 = K.pair_u_ref(sys64, *args64)
    tab64 = chin_table(sys64)
    ref = K.pair_delta_ref(sys64, *args64, with_force, tab64, ib, wf)
    nf = ~torch.isfinite(ref)        # NaN (or inf) where the reference is
    torch.testing.assert_close(got[nf], ref[nf].to(got.dtype), rtol=0.0,
                               atol=0.0, equal_nan=True,
                               msg=f"pair_delta action {label}: "
                                   "non-finite rows differ")
    dpot, df2 = K.pair_delta_ref(sys64, *args64, with_force)
    w = tab64[:, ib]
    tol = 0.0
    for term, weight, name in ((dpot, w[0], "dpot"),
                               (df2, (w[1] > 0) * wf, "df2"),
                               (du64, (w[2] > 0).double(), "du")):
        rtol, atol = _tol(system.dtype, name)
        tol = tol + torch.where(weight != 0, weight * (atol + rtol
                                                       * term.abs()), 0.0)
    plain = None
    if f32:
        plain = K.pair_delta_ref(system, R, xnew, xold, ip, with_force,
                                 chin_table(system), ib, wf)
        plain = torch.where(nf, 0.0, plain)
    e, x = _close(f"pair_delta action {system.dtype} {label} "
                  f"force={with_force}",
                  torch.where(nf, 0.0, got), torch.where(nf, 0.0, ref), 0.0,
                  torch.where(nf, 1.0, tol), plain,
                  _near_cut_rows(system, R, xnew, xold, ip, False)
                  if f32 else None)
    return e, x, int(nf.sum())


def dense_raw_check(system, sys64, R, ip, g, label):
    """Kernel 3's raw mode (with and without force) and kernel 4's u mode
    against their float64 plain forms on the rows R [W, B, N, D] of the
    moved particle ip (int, [W] or [W, B]), moved by 0.05 gaussians from g
    (no coincident partner: the dense forms have no r^2 > 0 guard), with
    _close and _tol.  Returns (max abs err of pair_delta, of pair_u, values
    excused by the cutoff, cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K

    W, B, _, D = R.shape
    dtype, f32 = system.dtype, system.dtype == torch.float32
    if isinstance(ip, int):
        xold = R[:, :, ip]
    else:
        ipb = ip[:, None].expand(W, B) if ip.dim() == 1 else ip
        xold = R.gather(2, ipb[:, :, None, None].expand(W, B, 1, D))[:, :, 0]
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g,
                                     device=R.device, dtype=dtype)
    near = _near_cut_rows(system, R, xnew, xold, ip, False) if f32 else None
    args64 = (R.double(), xnew.double(), xold.double(), ip)
    e_delta, excused = 0.0, 0
    for wf in (True, False):
        ref = K.pair_delta_ref(sys64, *args64, wf)
        plain = (K.pair_delta_ref(system, R, xnew, xold, ip, wf)
                 if f32 else (None, None))
        got = K.pair_delta(system, R, xnew, xold, ip, wf)
        for i, name in enumerate(("dpot", "df2")):
            e, n = _close(f"pair_delta {dtype} {label} force={wf} {name}",
                          got[i], ref[i], *_tol(dtype, name), plain[i], near)
            e_delta, excused = max(e_delta, e), excused + n
    ref = K.pair_u_ref(sys64, *args64)
    plain = K.pair_u_ref(system, R, xnew, xold, ip) if f32 else None
    got = K.pair_u(system, R, xnew, xold, ip)
    e_u, n = _close(f"pair_u {dtype} {label} du", got, ref,
                    *_tol(dtype, "du"), plain, near)
    return e_delta, e_u, excused + n, 3


def dense_parity(cfg, card):
    """The dense kernel (kernels 3 and 4 in one source) against
    pair_delta_ref / pair_u_ref on the same inputs: the raw mode of kernel 3
    (delta_pot) and kernel 4's
    u mode (delta_wf) at the end gate's row view [1024, 1, 64, 3] (bead 0
    and bead M-1) with ip scalar, and at a strided window [1024, 16, 64, 3]
    with ip [W] and [W, B], kernel 3 with and without force; then the
    action mode (the whole dense delta_action in one launch) at the gate's
    rows and over whole chains (ends, odd and even interior rows), ib [B]
    and [W, B], with one coincident partner per case (NaN where the
    reference gives NaN).  float64 within rtol 1e-11, float32 within
    tests/test_pallas_kernel.py's tolerances plus twice the plain float32
    form's own 99.99th-percentile error (see _close).  Then, at the gate's
    shape in float32, in one call: the action mode on an end row, the
    action mode on an interior row (kernel 3 alone: u skipped), u's marginal
    time between the two, the raw mode, the u mode and the whole
    delta_action, each beside its bound."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    W, N, M = 1024, cfg.Np, cfg.M
    sys64 = make_system(cfg, dev, torch.float64)
    errs = {"pair_delta": 0.0, "pair_u": 0.0}     # float64: kernel vs plain
    excused, ncase = 0, 0
    n0 = K.pair_delta.launches, K.pair_u.launches
    for dtype in (torch.float64, torch.float32):
        system = make_system(cfg, dev, dtype)
        paths = _flagship_paths(cfg, W, dtype, dev, seed=21)
        g = torch.Generator(device=dev).manual_seed(22)
        f32 = dtype == torch.float32
        lo = (M - 16) // 2
        Rw = paths[:, lo:lo + 16]
        cases = [(paths[:, :1], 5, "gate bead 0"),
                 (paths[:, M - 1:], 5, "gate bead M-1"),
                 (Rw, torch.randint(0, N, (W,), generator=g, device=dev),
                  "B=16 ip[W]"),
                 (Rw, torch.randint(0, N, (W, 16), generator=g, device=dev),
                  "B=16 ip[W, B]")]
        for R, ip, label in cases:
            ed, eu, x, c = dense_raw_check(system, sys64, R, ip, g, label)
            excused, ncase = excused + x, ncase + c
            if not f32:
                errs["pair_delta"] = max(errs["pair_delta"], ed)
                errs["pair_u"] = max(errs["pair_u"], eu)
    torch.cuda.synchronize()
    if (K.pair_delta.launches - n0[0], K.pair_u.launches - n0[1]) != (16, 8):
        raise AssertionError("pair_delta / pair_u did not count their "
                             "launches")
    print(f"[dense] {ncase} parity cases of kernel 3's raw mode and kernel "
          f"4's u mode pass against the plain forms: "
          f"float64 max abs err pair_delta {errs['pair_delta']:.3e}, pair_u "
          f"{errs['pair_u']:.3e} (rtol 1e-11, atol 1e-9, forces 1e-7); "
          f"float32 values beyond tolerance, each at a partner within 1e-5 "
          f"of rcut^2: {excused}")

    # the action mode: the gate's rows (ends) and whole chains (ends, odd
    # and even interior rows), ib [B] and [W, B], one coincident partner
    # per case (_window_ip) for the NaN case
    ep_err, ep_excused, ep_nf, ep_n = 0.0, 0, 0, 0
    n1 = K.pair_delta.launches
    for dtype in (torch.float64, torch.float32):
        system = make_system(cfg, dev, dtype)
        paths = _flagship_paths(cfg, W, dtype, dev, seed=24)
        g = torch.Generator(device=dev).manual_seed(25)
        cases = [
            (paths[:, :1], 5, system.arange(0, 1), "gate bead 0 ib[B]"),
            (paths[:, M - 1:], 5,
             torch.full((W, 1), M - 1, dtype=torch.long, device=dev),
             "gate bead M-1 ib[W, B]"),
            (paths, torch.randint(0, N, (W,), generator=g, device=dev),
             system.arange(0, M), "whole chains ib[B] ip[W]"),
            (paths, torch.randint(0, N, (W, M), generator=g, device=dev),
             torch.randint(0, M, (W, M), generator=g, device=dev),
             "whole chains ib[W, B] ip[W, B]")]
        for R, ip, ib, label in cases:
            xnew, xold = _window_ip(R, ip, g)
            for wf in (True, False):
                e, x, nf = action_check(system, sys64, R, xnew, xold, ip, ib,
                                        wf, label)
                ep_excused, ep_nf = ep_excused + x, ep_nf + nf
                ep_n += 1
                if dtype == torch.float64:
                    ep_err = max(ep_err, e)
    torch.cuda.synchronize()
    if ep_nf == 0:
        raise AssertionError("pair_delta action: no case gave a NaN row")
    if K.pair_delta.launches - n1 != ep_n or K.pair_u.launches != n0[1] + 8:
        raise AssertionError("pair_delta action: not one launch per case, "
                             "or a separate pair_u launch")
    errs["pair_delta"] = max(errs["pair_delta"], ep_err)
    print(f"[dense] {ep_n} cases of the action mode (kernels 3 and 4 in one "
          f"launch each) pass against the plain form: "
          f"float64 max abs err {ep_err:.3e} (the terms' tolerances, "
          f"weighted); {ep_nf} non-finite rows (coincident partners), "
          f"non-finite alike in both; float32 values excused at the "
          f"cutoff: {ep_excused}")
    return errs, dense_timing(cfg, card)


def dense_timing(cfg, card, W=1024, rounds=10, reps=200):
    """The dense kernel at the end gate's shape [1024, 1, 64, 3], float32,
    ip scalar, in one call: the action mode (kernels 3 and 4 in one launch)
    on the gate's end row (u evaluated) and on an interior row (u skipped:
    kernel 3 alone), in `rounds` alternating turns of `reps` launches each;
    u's marginal time is their difference, given as the median over the
    turns with its range.  Then the raw mode, the u mode, the whole
    delta_action and the plain forms.  Returns {name: (ms, plain ms,
    (bound ms, by))} for the kernels JSON, pair_u's being u's marginal time
    in the fused launch (the only form of kernel 4 on a path) with u's
    added operations as its bound, and 'pair_u_extra', the range of the
    marginal and the u mode's own time."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import (chin_table,
                                                            delta_action)
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    N, D = cfg.Np, cfg.dim
    system = make_system(cfg, dev, torch.float32)
    paths = _flagship_paths(cfg, W, torch.float32, dev, seed=23)
    R = paths[:, :1]
    xold = R[:, :, 5]
    xnew = (xold + 0.05).contiguous()
    xb = 2 * W * D * 4
    tab, wf = chin_table(system), dense_wf(system, True)
    ib_end, ib_int = system.arange(0, 1), system.arange(1, 2)
    pairs = 2 * W * (N - 1)
    b_fused = _bound(_nbytes(R, ib_end, tab) + xb + W * 4,
                     pairs * (_OPS["delta_force"] + _OPS["u_fused"]))
    b_k3 = _bound(_nbytes(R, ib_int, tab) + xb + W * 4,
                  pairs * _OPS["delta_force"])
    b_raw = _bound(_nbytes(R) + xb + 2 * W * 4, pairs * _OPS["delta_force"])
    b_u = _bound(_nbytes(R) + xb + W * 4, pairs * _OPS["u"])
    b_marg = _bound(0, pairs * _OPS["u_fused"])

    def fused(ib):
        return lambda: K.pair_delta(system, R, xnew, xold, 5, True, tab, ib,
                                    wf)
    ends, ints = [], []
    for _ in range(rounds):
        ends.append(_events_ms(fused(ib_end), reps))
        ints.append(_events_ms(fused(ib_int), reps))
    marg = sorted(e - i for e, i in zip(ends, ints))
    ms, k3 = float(np.median(ends)), float(np.median(ints))
    u_marg = float(np.median(marg))
    raw = _events_ms(lambda: K.pair_delta(system, R, xnew, xold, 5))
    u_ms = _events_ms(lambda: K.pair_u(system, R, xnew, xold, 5))
    action = _events_ms(lambda: delta_action(system, R, xnew, xold, 5,
                                             ib_end))
    times = {
        "pair_delta": (ms, _events_ms(lambda: K.pair_delta_ref(
            system, R, xnew, xold, 5, True, tab, ib_end, wf)), b_fused),
        "pair_u": (u_marg, _events_ms(lambda: K.pair_u_ref(
            system, R, xnew, xold, 5)), b_marg),
        "pair_u_extra": {"marginal_range_ms": [marg[0], marg[-1]],
                         "u_mode_ms": u_ms}}
    print(f"[time] pair_delta action (kernels 3+4, one launch) [1024,1,64,3] "
          f"end row float32: {ms:.5f} ms (median of {rounds} turns of {reps} "
          f"launches, range {min(ends):.5f}-{max(ends):.5f}), bound "
          f"{b_fused[0]:.5f} ms ({b_fused[1]}; {card})")
    print(f"[time] pair_delta action on an interior row (u skipped: kernel 3 "
          f"alone) [1024,1,64,3] float32: {k3:.5f} ms (range "
          f"{min(ints):.5f}-{max(ints):.5f}), bound {b_k3[0]:.5f} ms "
          f"({b_k3[1]}); u's marginal time in the fused launch {u_marg:.6f} "
          f"ms (median of {rounds} paired turns, range {marg[0]:.6f} to "
          f"{marg[-1]:.6f}), bound {b_marg[0]:.6f} ms ({b_marg[1]}; {card})")
    print(f"[time] pair_delta raw (dpot, df2) [1024,1,64,3] float32: kernel "
          f"{raw:.5f} ms, bound {b_raw[0]:.5f} ms ({b_raw[1]}; {card})")
    print(f"[time] pair_u (u mode alone, on no path) [1024,1,64,3] float32: "
          f"kernel {u_ms:.5f} ms, plain {times['pair_u'][1]:.4f} ms, bound "
          f"{b_u[0]:.5f} ms ({b_u[1]}; {card})")
    print(f"[time] delta_action (one launch) [1024,1,64,3] float32: "
          f"{action:.5f} ms; plain {times['pair_delta'][1]:.4f} ms ({card})")
    return times


def _kernel_fns():
    """{name: wrapper} of the five kernels; each wrapper's .launches counts
    its kernel's launches."""
    from pathintegralgroundstate_torch.ops import kernels as K
    return {"pair_rows": K.pair_rows, "pair_pot": K.pair_pot,
            "cascade": K.cascade, "pair_delta": K.pair_delta,
            "pair_u": K.pair_u}


class _Recorder:
    """A draw source that records what another one returns."""

    def __init__(self, src):
        self.src, self.log = src, []

    def __getattr__(self, name):
        fn = getattr(self.src, name)

        def call(*a, **k):
            out = fn(*a, **k)
            if name != "begin_step":
                self.log.append(out)
            return out
        return call


class _Replayer:
    """Replays recorded draws on another device."""

    def __init__(self, log, device):
        self.log, self.device, self.i = list(log), device, 0

    def _move(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, tuple):
            return type(x)(*map(self._move, x)) if hasattr(x, "_fields") \
                else tuple(map(self._move, x))
        return x

    def __getattr__(self, name):
        def call(*a, **k):
            if name == "begin_step":
                return None
            out = self.log[self.i]
            self.i += 1
            return self._move(out)
        return call


def replay_check(cfg, label="flagship", cut=False):
    from pathintegralgroundstate_torch.state import (init_state,
                                                     state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import (Sweeper, stats_to_numpy,
                                                     zero_stats)
    from pathintegralgroundstate_torch.system import make_system

    cfg = cfg.replace(n_walkers=16, dtype="float64")
    if cut:
        # the CPU side of a replay runs the plain forms: the depth is cut
        # to one particle sweep and at most two worm rounds, and every move
        # site of the step still runs
        cfg = cfg.replace(Nstag=min(cfg.Nstag, 1), Nobdm=min(cfg.Nobdm, 2))
    out = []
    rec = start = None
    for dev in ("cpu", "cuda"):
        system = make_system(cfg, dev)
        sweeper = Sweeper(system)
        if dev == "cpu":
            state = init_state(system)
            start = state_to_numpy(state)
            src = rec = _Recorder(sweeper.draws(state))
        else:
            state = state_from_numpy(system, start)
            src = _Replayer(rec.log, torch.device("cuda"))
        state, stats = sweeper.step(state, zero_stats(system), src)
        out.append((state_to_numpy(state), stats_to_numpy(stats)))
    (s_cpu, t_cpu), (s_gpu, t_gpu) = out
    for k in s_cpu:
        if s_cpu[k].dtype.kind == "f":
            np.testing.assert_allclose(s_gpu[k], s_cpu[k], rtol=1e-9,
                                       atol=1e-11, err_msg=k)
        else:
            np.testing.assert_array_equal(s_gpu[k], s_cpu[k], err_msg=k)
    np.testing.assert_array_equal(t_gpu["counters"], t_cpu["counters"])
    for k in t_cpu:
        if k != "counters":
            np.testing.assert_allclose(t_gpu[k], t_cpu[k], rtol=1e-9,
                                       atol=1e-9, err_msg=k)
    print(f"[replay] {label} step at W=16 float64 (Nstag={cfg.Nstag}, "
          f"Nobdm={cfg.Nobdm}): card (kernels) == CPU (plain forms) on "
          f"{len(rec.log)} recorded draw sites; sumE {t_gpu['sumE']:.10g}")


class _Depths:
    """A draw source that passes another one through and keeps the depths
    that its end moves drew."""

    def __init__(self, src):
        self.src, self.depths = src, []

    def __getattr__(self, name):
        return getattr(self.src, name)

    def end_bisect(self, *a, **k):
        out = self.src.end_bisect(*a, **k)
        self.depths.append(out[0])
        return out


def expected_launches(cfg, sweeper, nstep, use_rand, depths):
    """Launches over nstep steps, from the move sites the steps visit:
    {kernel: (count, exact)}, every count exact.  Kernel A: one pass per CM
    move; with the worm two for each of open and close (both worm halves)
    and per worm round eight (the half translations, heads, tails and
    stagings of both halves) and the swap's one; one per window of the
    diagonal sweep, in the per-level form from the end moves' drawn
    depths: one pass per level, plus the gate's own pass with batched
    randoms (without them the gate is the dense delta_action, one launch of
    kernel 3 that also runs kernel 4's pass, and no separate kernel-4
    launch).  Per-walker windows (shared_windows=False) launch as shared
    ones: the gathered window is one kernel-A pass like the view."""
    Np, Ns = cfg.Np, cfg.Nstag
    rows = (Np * (cfg.CMFreq > 0)
            + ((4 + cfg.Nobdm * (8 + cfg.swapping)) if cfg.CWorm > 0 else 0))
    rows, casc, dense = nstep * rows, 0, 0
    visits = nstep * Ns * Np
    if cfg.exact_f2:
        return exact_launches(cfg, sweeper, nstep, use_rand, rows, visits)
    if sweeper.fused_diag:
        ends, ints = visits, nstep * Ns * -(-Np // sweeper.K_int)
        if cfg.cascade and cfg.end_regrow != "sta":
            casc += ends
        else:
            rows += 2 * ends           # one pair pass per end window
        if cfg.cascade:
            casc += ints
        else:
            rows += ints
    elif cfg.sampling != "bis":
        # head, tail and the interior window; under mesh_beads > 1 one
        # window per shard on one process, this rank's shard's on a rank
        rows += (2 + (1 if sweeper.sp_sharded else sweeper.sp)) * visits
    elif cfg.bis_monoshot:
        rows += 3 * visits
    else:
        nlev = cfg.Nlev
        rows += visits * nlev
        if use_rand:
            rows += 2 * visits * (max(nlev, 2) + 1)
        else:
            if len(depths) != 2 * visits:
                raise AssertionError(f"{len(depths)} end-move depths drawn, "
                                     f"expected {2 * visits}")
            rows += sum(depths)
            dense = 2 * visits
    return {"pair_rows": (rows, True),
            "pair_pot": (2 * nstep, True),
            "cascade": (casc, True), "pair_delta": (dense, True),
            "pair_u": (0, True)}


def exact_launches(cfg, sweeper, nstep, use_rand, calls, visits):
    """Exact launches of the unfused monoshot sweep with exact F^2 over
    nstep steps (calls: its CM and worm window calls): kernels A and 5
    never (the reference's routing), kernel B twice per step for
    ThermEnergy and, without the cache, twice per F^2-carrying window call
    (every call of the monoshot sweep; the field difference of R' and R),
    kernels 3 and 4 never (batched randoms: no dense gate)."""
    if sweeper.fused_diag or cfg.sampling != "bis" or not cfg.bis_monoshot \
            or not use_rand:
        raise ValueError("exact_launches models the unfused monoshot sweep "
                         "with batched randoms only")
    brute = 0 if cfg.f2_cache else 2 * (calls + 3 * visits)
    return {"pair_rows": (0, True), "pair_pot": (2 * nstep + brute, True),
            "cascade": (0, True), "pair_delta": (0, True),
            "pair_u": (0, True)}


def main_path(cfg, card, label="main"):
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import (BATCH_RAND_MAX_W,
                                                     COUNTER_NAMES, Sweeper,
                                                     bead_updates_per_step,
                                                     run_block)
    from pathintegralgroundstate_torch.system import make_system

    system = make_system(cfg, torch.device("cuda"))
    sweeper = Sweeper(system)
    state = init_state(system)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, warm = run_block(sweeper, state, 1)
    torch.cuda.synchronize()
    print(f"[{label}] warm-up step: {time.perf_counter() - t0:.3f} s")

    nstep = 3
    kern = _kernel_fns()
    src = _Depths(sweeper.draws(state))
    for fn in kern.values():
        fn.launches = 0
    t0 = time.perf_counter()
    state, stats = run_block(sweeper, state, nstep, src)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / nstep
    launches = {k: fn.launches for k, fn in kern.items()}

    use_rand = sweeper.batch_rand and cfg.n_walkers <= BATCH_RAND_MAX_W
    want = expected_launches(cfg, sweeper, nstep, use_rand, src.depths)
    for k, (n, exact) in want.items():
        if (launches[k] != n) if exact else (launches[k] < n):
            raise AssertionError(f"{k} launched {launches[k]} times over "
                                 f"{nstep} steps, expected "
                                 f"{'' if exact else 'at least '}{n}")

    c = dict(zip(COUNTER_NAMES, (stats.counters + warm.counters).tolist()))
    tries = ("try_cm", "try_stag") + (
        ("try_open",) if cfg.CWorm > 0 else ()) + (
        ("try_int",) if sweeper.fused_diag else ())
    for k in tries:
        if c[k] <= 0:
            raise AssertionError(f"{k} = {c[k]}")
    if c["acc_open"] > 0:
        for k in ("try_close", "try_cm_half", "try_stag_half"):
            if c[k] <= 0:
                raise AssertionError(f"{k} = {c[k]} with open walkers")
    table = []
    pairs = [("acc_cm", "try_cm"), ("acc_head", "try_stag"),
             ("acc_tail", "try_stag"),
             ("acc_bd", "try_int" if sweeper.fused_diag else "try_stag"),
             ("acc_open", "try_open"), ("acc_close", "try_close"),
             ("acc_cm_half", "try_cm_half"),
             ("acc_head_half", "try_stag_half"),
             ("acc_tail_half", "try_stag_half"),
             ("acc_bd_half", "try_stag_half"), ("acc_swap", "try_swap")]
    for a, t in pairs:
        if c[t] > 0:
            ratio = c[a] / c[t]
            if not 0.0 < ratio <= 1.0:
                raise AssertionError(f"{a}/{t} = {c[a]}/{c[t]} outside (0, 1]")
            table.append(f"{a}/{t}={c[a]}/{c[t]}={ratio:.4f}")
    for k in ("sumE", "sumEt"):
        if not math.isfinite(float(getattr(stats, k))):
            raise AssertionError(f"{k} is not finite")
    for k in ("gr", "sk"):
        if not bool(torch.isfinite(getattr(stats, k)).all()):
            raise AssertionError(f"{k} is not finite")
    nd = float(stats.n_diag)
    bups = cfg.n_walkers * bead_updates_per_step(cfg) / dt
    what = ("fused sweep" + (" + cascade" if cfg.cascade else "")
            if sweeper.fused_diag else "flagship" if cfg.bis_monoshot
            else "reference order")
    if cfg.exact_f2:
        what += " exact F^2 " + ("cached" if cfg.f2_cache else "brute")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[{label}] {what} W={cfg.n_walkers} Np={cfg.Np} M={cfg.M} "
          f"D={cfg.dim} {cfg.potential}/{cfg.jastrow} {cfg.dtype}: "
          f"{dt * 1e3:.1f} ms/step, {bups:.4e} bead-updates/s, "
          f"peak memory {peak:.3f} GiB ({card})")
    if src.depths:
        hist = {d: src.depths.count(d) for d in sorted(set(src.depths))}
        print(f"[{label}] end-move depths drawn over {nstep} steps: {hist}")
    print(f"[{label}] launches over {nstep} steps: {launches}; "
          f"<E>/N={float(stats.sumE) / nd / cfg.Np:.4f} "
          f"<Et>/N={float(stats.sumEt) / nd / cfg.Np:.4f} (n_diag {nd:.0f})")
    print(f"[{label}] acceptance: " + ", ".join(table))

    syncs = step_syncs(sweeper, state, src, label)
    if syncs:
        raise AssertionError(f"{label}: {syncs} host syncs in one step")
    return launches, dt, bups


def step_syncs(sweeper, state, src, label):
    """The host syncs of one step (run_block) under
    torch.cuda.set_sync_debug_mode('warn'): printed with the first three
    messages, and returned."""
    from pathintegralgroundstate_torch.sweep import run_block

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_block(sweeper, state, 1, src)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    print(f"[{label}] host syncs in one step under sync_debug_mode('warn'): "
          f"{len(syncs)}")
    for w in syncs[:3]:
        print(f"[{label}]   {str(w.message)[:160]}")
    return len(syncs)


def _block_rates(out_dir, card, label, first=1, nstep=None, tag="cli"):
    """Print the bead-updates/s of each block from `first` on, from
    metrics.jsonl, and its ms/step given the block's nstep; return them."""
    import os
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f][first - 1:]
    for r in recs:
        per = (f", {r['time_s'] * 1e3 / nstep:.1f} ms/step" if nstep
               else "")
        print(f"[{tag}] {label} block {r['block']}: {r['time_s']:.3f} s"
              f"{per}, {r['bead_updates_per_s']:.4e} bead-updates/s "
              f"({card})")
    return [r["bead_updates_per_s"] for r in recs]


def cli_run(nml, label, out_dir, *args, tag="cli"):
    """cli.main on the namelist nml into out_dir, on the card (without
    PIGS_PLATFORM), in this process, with every kernel's launch count set
    to 0 just before and read just after; its console goes to out_dir's
    console.log.  Returns (launches, console)."""
    import contextlib
    import io
    import os

    from pathintegralgroundstate_torch import cli

    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    saved = os.environ.pop("PIGS_PLATFORM", None)
    try:
        with contextlib.redirect_stdout(log):
            rc = cli.main([nml, "-o", out_dir, *args])
    finally:
        if saved is not None:
            os.environ["PIGS_PLATFORM"] = saved
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with open(os.path.join(out_dir, "console.log"), "w") as f:
        f.write(log.getvalue())
    if rc != 0:
        raise AssertionError(f"{tag} {label}: exit {rc}")
    launches = {k: fn.launches for k, fn in kern.items()}
    print(f"[{tag}] {label}: cli.main {' '.join(args)} in {seconds:.1f} s; "
          f"launches {launches}")
    return launches, log.getvalue()


def cli_phase(cfg, card):
    """The port as its users run it: `cli.main` on a namelist of the
    flagship (config.namelist_text) at W=1024 float32, in this process, with
    the launch counts set to 0 just before each run and read just after:
      1. the flagship order, Nstep=3, --blocks 2;
      2. the reference order (bis_monoshot=F, bis_end_random_depth=T),
         Nstep=2, --blocks 1: the dense delta_action (kernels 3 and 4 in
         one launch) at every end gate, 2 Nstag Np per step, and no
         separate kernel-4 launch;
    then the resume probe as its own process, `python3 -m
    pathintegralgroundstate_torch ... --set resume=T --blocks 1` on run 1's
    directory: it must print BLOCK NUMBER : 3 and leave 3 finite rows in
    e_vpi.out.  Each block's bead-updates/s is printed beside the card.
    Outputs under build/chip_smoke_cli/; each run's console in its
    directory's console.log."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import namelist_text
    from pathintegralgroundstate_torch.sweep import Sweeper
    from pathintegralgroundstate_torch.system import make_system

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    nml = os.path.join(root, "flagship.in")
    with open(nml, "w") as f:
        f.write(namelist_text(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PIGS_PLATFORM"}

    def run(label, out_dir, *args):
        return cli_run(nml, label, out_dir, *args)

    # 1. the flagship order
    d1 = os.path.join(root, "flagship")
    nstep, nblk = 3, 2
    launches, log = run("flagship", d1, "--set", f"Nstep={nstep}",
                        "--blocks", str(nblk))
    steps = nstep * nblk
    sweeper = Sweeper(make_system(cfg, torch.device("cuda")))
    want = expected_launches(cfg, sweeper, steps, True, [])
    for k, (n, exact) in want.items():
        if (launches[k] != n) if exact else (launches[k] < n):
            raise AssertionError(f"cli flagship: {k} launched {launches[k]} "
                                 f"times over {steps} steps, expected "
                                 f"{'' if exact else 'at least '}{n}")
    if log.count("BLOCK NUMBER") != nblk:
        raise AssertionError("cli flagship: not one report per block")
    rates = _block_rates(d1, card, "flagship")

    # 2. the reference order: the fused dense gate
    d2 = os.path.join(root, "reference_order")
    nstep = 2
    launches, _ = run("reference order", d2, "--set", "bis_monoshot=F",
                      "--set", "bis_end_random_depth=T", "--set",
                      f"Nstep={nstep}", "--blocks", "1")
    gates = 2 * cfg.Nstag * cfg.Np * nstep
    visits = cfg.Nstag * cfg.Np * nstep
    if launches["pair_delta"] != gates or launches["pair_u"] != 0:
        raise AssertionError(f"cli reference order: pair_delta launched "
                             f"{launches['pair_delta']} times (expected "
                             f"{gates}: 2 Nstag Np per step), pair_u "
                             f"{launches['pair_u']} (expected 0)")
    if launches["pair_pot"] != 2 * nstep or launches["cascade"] != 0 \
            or launches["pair_rows"] < visits * (cfg.Nlev + 4):
        raise AssertionError(f"cli reference order: launches {launches}")
    rates += _block_rates(d2, card, "reference order")

    # 3. the resume probe, as a process of its own; -X importtime lists
    # every module it imports on stderr
    cmd = [sys.executable, "-X", "importtime", "-m",
           "pathintegralgroundstate_torch", nml, "-o", d1, "--set", "Nstep=3",
           "--set", "resume=T", "--blocks", "1"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=repo, env=env, capture_output=True,
                         text=True, timeout=600)
    with open(os.path.join(d1, "resume.log"), "w") as f:
        f.write(out.stdout + out.stderr)
    if out.returncode != 0:
        raise AssertionError(f"cli resume: exit {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    imported = [ln.rsplit("|", 1)[1].strip() for ln in out.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    bad = sorted({m for m in imported if m.split(".")[0] in (
        "jax", "jaxlib", "pathintegralgroundstate_tpu")})
    if bad or "pathintegralgroundstate_torch.driver" not in imported:
        raise AssertionError(f"cli resume: imported {bad[:5]} (or no "
                             f"import list)")
    e = np.loadtxt(os.path.join(d1, "e_vpi.out"), ndmin=2)
    if "BLOCK NUMBER : 3" not in out.stdout or e.shape != (3, 4) \
            or not np.isfinite(e).all() \
            or not np.array_equal(e[:, 0], [1, 2, 3]):
        raise AssertionError(f"cli resume: e_vpi.out {e.shape}, BLOCK "
                             f"NUMBER : 3 printed: "
                             f"{'BLOCK NUMBER : 3' in out.stdout}")
    print(f"[cli] resume probe (python3 -m pathintegralgroundstate_torch ... "
          f"--set resume=T --blocks 1): BLOCK NUMBER : 3, e_vpi.out 3 finite "
          f"rows, {len(imported)} modules imported, none of jax, jaxlib or "
          f"pathintegralgroundstate_tpu, {time.perf_counter() - t0:.1f} s")
    rates += _block_rates(d1, card, "flagship, resumed", first=3)
    return rates


# The [dims] phase's geometries: a 1-D chain at 0.5 sigma^-1 and a 2-D He-4
# film at 0.26 sigma^-2 (about 0.04 A^-2), both under PBC with aziz2
DIMS = ((1, 0.5), (2, 0.26))


def dims_case(cfg, D, density, dtype, N, W=256):
    """One case of the [dims] phase: every kernel at dimension D (PBC,
    aziz2, mcmillan_c1) with N particles at `density`, in dtype, against
    its plain form with the tolerances above: kernel A over windows of
    B=16 and 65 read in place, ip int, [W], [W, B] and [1, B], forward and
    reversed, rows and walker sums, then at each lane-group width
    (lanes_parity); kernel B on both ThermEnergy views; the dense kernel's
    raw and u modes (the gate's row, B=16 with ip [W] and [W, B]) and its
    action mode (the gate's row and whole chains); kernel 5 'ends' and
    'interior' (cascade_check).  Returns (cases, whether kernels A and B
    stage with 16-byte copies, whether kernel 5 takes its bulk copy,
    kernel 5's decision agreement per mode)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    c = cfg.replace(dim=D, Np=N, density=density)
    system = make_system(c, dev, dtype)
    sys64 = make_system(c, dev, torch.float64)
    paths = _flagship_paths(c, W, dtype, dev, seed=40 + N + D)
    g = torch.Generator(device=dev).manual_seed(41)
    M, n = c.M, 0
    for B in (16, 65):
        lo = (M - B) // 2
        R = paths[:, lo:lo + B]
        ib = torch.arange(lo, lo + B, device=dev)
        ips = (7 % N, torch.randint(0, N, (W,), generator=g, device=dev),
               torch.randint(0, N, (W, B), generator=g, device=dev),
               torch.randint(0, N, (1, B), generator=g, device=dev))
        for k, ip in enumerate(ips):
            xnew, xold = _window_ip(R, ip, g)
            for rev in (False, True):
                n += rows_parity(system, sys64, R, xnew, xold, ip, ib, rev,
                                 [(True, True), (False, False)],
                                 f"D={D} N={N} B={B}",
                                 reduce=bool((k + rev) % 2))[2]
    n += lanes_parity(c, dtype, seed=43)[2]
    for sl, view in ((slice(0, M - 1, 2), "even view"),
                     (slice(1, M - 1, 2), "odd view")):
        pot_check(system, sys64, paths[:, sl], f"D={D} N={N} {view}")
        n += 2
    lo = (M - 16) // 2
    Rw = paths[:, lo:lo + 16]
    for R, ip, label in (
            (paths[:, :1], 5, "gate bead 0"),
            (Rw, torch.randint(0, N, (W,), generator=g, device=dev),
             "B=16 ip[W]"),
            (Rw, torch.randint(0, N, (W, 16), generator=g, device=dev),
             "B=16 ip[W, B]")):
        n += dense_raw_check(system, sys64, R, ip, g,
                             f"D={D} N={N} {label}")[3]
    for R, ip, ib, label in (
            (paths[:, :1], 5, system.arange(0, 1), "gate"),
            (paths, torch.randint(0, N, (W,), generator=g, device=dev),
             system.arange(0, M), "whole chains")):
        xnew, xold = _window_ip(R, ip, g)
        for wf in (True, False):
            action_check(system, sys64, R, xnew, xold, ip, ib, wf,
                         f"D={D} N={N} {label}")
            n += 1
    shares = [cascade_check(c, W, dtype, mode, seed=45)[0]
              for mode in ("ends", "interior")]
    torch.cuda.synchronize()
    vec = K.slabs16(paths)
    return n + 2, vec, vec and paths.stride(1) == N * D, shares


def dims_parity(cfg):
    """The [dims] phase: dims_case at D = 1 (a chain) and D = 2 (a He-4
    film), float32 and float64, N = 30, 31 and 64.  At these N the 16-byte
    rule of kernels A and B (slabs16) and kernel 5's bulk copy flip with D
    and the dtype: each case prints the path it took.  Returns the number
    of cases."""
    total = 0
    for D, density in DIMS:
        for dtype in (torch.float32, torch.float64):
            for N in (30, 31, 64):
                n, vec, bulk, shares = dims_case(cfg, D, density, dtype, N)
                es = torch.tensor([], dtype=dtype).element_size()
                print(f"[dims] D={D} N={N} {str(dtype)[6:]}: {n} cases pass "
                      f"(a row of partners {N * D * es} bytes: kernels A "
                      f"and B "
                      f"{'16-byte copies' if vec else 'element by element'}"
                      f", kernel 5 "
                      f"{'bulk copy' if bulk else 'element by element'}; "
                      f"kernel 5 decisions agree on "
                      + ", ".join(f"{x:.6f}" for x in shares) + ")")
                total += n
    print(f"[dims] {total} parity cases of kernels A, B, 3/4 and 5 pass at "
          f"D = 1 and 2, float32 and float64, N = 30, 31, 64")
    return total


# The 1-D harmonic oscillator with its exact trial wavefunction (the verify
# recipe's input): E = 0.5 with variance 0 in every block
HO_IN = """&system
 dim = 1, Np = 1, trap = T /
&samp
 resume = F, dt = 0.05d0, Nb = 8, seed = 1982, delta_cm = 0.5d0, CMFreq = 1,
 sampling = 'sta', Lstag = 8, Nlev = 2, Nstag = 2, Nblock = 2, Nstep = 10,
 Nbin = 50, Nk = 10 /
&obdm
 swapping = F, CWorm = 0.d0, Nobdm = 0, Npw = 0 /
&wavefun
 Nmax = 1000, wf_table = F, v_table = F /
&jastrow
 Rm = 1.20d0 /
&extpot
 a_ho = 1.0d0 /
&tpu
 n_walkers = 16, dtype = 'float64', potential = 'none' /
"""


def trap_replays():
    """The trap's card-vs-CPU replays at W=16 float64 (replay_check): the
    trapped worm flagship (dim 2: staging, worm, swaps, the density map)
    and the 1-D oscillator with the bisection sampler (Nlev=2).  The
    reference routes the trap away from its kernels, and so does the port:
    every kernel's launch count must stay 0 across both."""
    from pathintegralgroundstate_torch.config import load_namelist_config
    from pathintegralgroundstate_torch.flagship import trap_worm_cfg

    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    replay_check(trap_worm_cfg(), "trap worm (dim 2)")
    replay_check(load_namelist_config(HO_IN, is_text=True).replace(
        sampling="bis", Nlev=2), "1-D oscillator, bisection")
    launches = {k: fn.launches for k, fn in kern.items()}
    if any(launches.values()):
        raise AssertionError(f"trap replays launched kernels: {launches}")
    print(f"[trap] the trap replays launched no kernel: {launches}")


def _finite_total(path, cols):
    """(rows, total of the columns cols) of a text output, which must be
    finite and non-empty."""
    x = np.loadtxt(path, ndmin=2)
    if x.size == 0 or not np.isfinite(x).all():
        raise AssertionError(f"{path}: empty or not finite")
    return x.shape[0], float(x[:, cols].sum())


def trap_cli_phase(card):
    """The trap as its users run it, cli.main on the card, every kernel's
    launch count set to 0 before each run and read after (each must stay
    0: the plain forms run the trap):
      1. the 1-D oscillator (HO_IN), 2 blocks of 10 steps: each block
         prints <E> = 0.5 +/- 0, and e_vpi.out's E within 1e-12 of 0.5;
         then the same with exact F^2 and MALA (smart_mc=0.05), which
         must print the same and a MALA line per block;
      2. the trapped worm flagship (flagship.trap_worm_cfg) at W=256
         float64, 3 blocks of Nstep=20 (the OBDM flushes its first
         super-block once a block's worth of diagonal walker-steps has
         gathered: after the third block at a diagonal share of about
         0.4): the mixed E/N of each block within 1e-12 of 1.0; nr_vpi.out
         and density_vpi.out finite, non-empty and with a nonzero total.
    For each, each block's ms/step and bead-updates/s, and the host syncs
    of one step under sync_debug_mode('warn'), printed as they are (the
    plain forms' syncs are recorded, not failed).  Outputs under
    build/chip_smoke_trap/."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import (load_namelist_config,
                                                      namelist_text)
    from pathintegralgroundstate_torch.flagship import trap_worm_cfg
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_trap")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    out = {}
    exact = ("--set", "exact_f2=T", "--set", "smart_mc=0.05")
    for name, text, E, nstep, nblk, args in (
            ("oscillator", HO_IN, 0.5, 10, 2, ()),
            ("oscillator exact F2 MALA", HO_IN, 0.5, 10, 2, exact),
            ("trap worm", namelist_text(trap_worm_cfg(3)), 1.0, 20, 3, ())):
        d = os.path.join(root, name.replace(" ", "_"))
        nml = d + ".in"
        with open(nml, "w") as f:
            f.write(text)
        launches, log = cli_run(nml, name, d, *args, tag="trap")
        if any(launches.values()):
            raise AssertionError(f"trap {name}: kernels launched {launches}")
        e = np.loadtxt(os.path.join(d, "e_vpi.out"), ndmin=2)
        err = float(np.abs(e[:, 1] - E).max())
        if e.shape[0] != nblk or not err <= 1e-12:
            raise AssertionError(f"trap {name}: E/N per block {e[:, 1]}, "
                                 f"expected {E}")
        if name.startswith("oscillator") \
                and log.count("<E>  =  0.5 +/- 0\n") != 2:
            raise AssertionError(f"trap {name}: a block did not print "
                                 "<E> = 0.5 +/- 0")
        if args and log.count("> MALA movements") != nblk:
            raise AssertionError(f"trap {name}: no MALA line per block")
        print(f"[trap] {name}: E/N = {E} in each block (max deviation "
              f"{err:.1e})")
        if name == "trap worm":
            for f, cols in (("nr_vpi.out", slice(1, None, 2)),
                            ("density_vpi.out", 2)):
                rows, tot = _finite_total(os.path.join(d, f), cols)
                if tot <= 0.0:
                    raise AssertionError(f"trap worm: {f} totals {tot}")
                print(f"[trap] trap worm {f}: {rows} finite rows, total "
                      f"{tot:.6g}")
        rates = _block_rates(d, card, name, nstep=nstep, tag="trap")
        cfg = load_namelist_config(nml)
        if args:
            cfg = cfg.replace(exact_f2=True, smart_mc=0.05)
        sweeper = Sweeper(make_system(cfg, torch.device("cuda")))
        state, _ = run_block(sweeper, init_state(sweeper.system), 1)
        syncs = step_syncs(sweeper, state, sweeper.draws(state),
                           f"trap {name}")
        out[name] = (rates, syncs)
    return out


# ---------------------------------------------------------------------------
# Exact F^2 (the odd-bead cache and the brute form) and MALA
# ---------------------------------------------------------------------------

def exact_parity(cfg, W=1024):
    """The kernels of the brute exact-F^2 path at its shapes: kernel B on
    end windows of 16 rows [W, 16, 64, 3] as they are and with the moved
    particle at its proposal (F^2(R) and F^2(R')), kernel 3's raw mode and
    kernel 4's u mode on the same rows (pot_check, dense_raw_check), in
    float32 and float64; then, in float64 at W=64, the composed exact forms
    on the card against the same forms on the CPU (plain forms): the dense
    delta_action (kernel 3 raw, kernel B twice, kernel 4) and the brute
    window rows forward and reversed, with their launch counts.  Returns
    {kernel: float64 max abs err}."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops import pairwise as P
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    ex = cfg.replace(exact_f2=True, f2_cache=False)
    errs = {"pair_pot": 0.0, "pair_delta": 0.0, "pair_u": 0.0}
    g = torch.Generator(device=dev).manual_seed(41)
    n = excused = 0
    for dtype in (torch.float32, torch.float64):
        system = make_system(ex, dev, dtype)
        sys64 = make_system(ex, dev, torch.float64)
        paths = _flagship_paths(ex, W, dtype, dev, seed=43)
        f64 = dtype == torch.float64
        for lo, label in ((0, "head rows"), (ex.M - 16, "tail rows")):
            R = paths[:, lo:lo + 16]
            xnew = R[:, :, 5] + 0.05 * torch.randn(
                R[:, :, 5].shape, generator=g, device=dev, dtype=dtype)
            for RR, what in ((R, "R"), (P._moved(R, xnew, 5), "R'")):
                e, x = pot_check(system, sys64, RR, f"[{W},16,64,3] {label} "
                                 f"{what}")
                excused += x
                errs["pair_pot"] = max(errs["pair_pot"], e) if f64 \
                    else errs["pair_pot"]
                n += 1
            e3, e4, x, c = dense_raw_check(system, sys64, R, 5, g,
                                           f"[{W},16,64,3] {label}")
            if f64:
                errs["pair_delta"] = max(errs["pair_delta"], e3)
                errs["pair_u"] = max(errs["pair_u"], e4)
            excused, n = excused + x, n + c
    kern = _kernel_fns()
    card = make_system(ex.replace(n_walkers=64), dev, torch.float64)
    cpu = make_system(ex.replace(n_walkers=64), "cpu", torch.float64)
    paths = _flagship_paths(ex, 64, torch.float64, dev, seed=47)
    ip = torch.randint(0, ex.Np, (64,), generator=g, device=dev)
    xold = paths[torch.arange(64, device=dev), :, ip]
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g, device=dev,
                                     dtype=torch.float64)
    ib = card.arange(ex.M)
    cases = (("dense delta_action", P.delta_action, {},
              dict(pair_delta=1, pair_pot=2, pair_u=1)),
             ("brute rows", P.delta_action_rows, {},
              dict(pair_pot=2)),
             ("brute rows reversed", P.delta_action_rows, dict(rev=True),
              dict(pair_pot=2)))
    for name, fn, kw, want in cases:
        for f in kern.values():
            f.launches = 0
        got = fn(card, paths, xnew, xold, ip, ib, **kw)
        counts = {k: f.launches for k, f in kern.items()}
        if counts != {k: want.get(k, 0) for k in kern}:
            raise AssertionError(f"exact {name}: launches {counts}")
        ref = fn(cpu, paths.cpu(), xnew.cpu(), xold.cpu(), ip.cpu(),
                 ib.cpu(), **kw)
        _close(f"exact {name} card vs CPU float64", got.cpu(), ref, 1e-9,
               1e-9)
        n += 1
    torch.cuda.synchronize()
    print(f"[exact_f2] {n} cases pass: kernel B on the brute path's windows "
          f"[{W},16,64,3] (R and R', head and tail rows), kernel 3 raw and "
          f"kernel 4 u on the same rows, float32 and float64 (float64 max "
          f"abs err pair_pot {errs['pair_pot']:.3e}, pair_delta "
          f"{errs['pair_delta']:.3e}, pair_u {errs['pair_u']:.3e}; float32 "
          f"values excused within 1e-5 of rcut^2: {excused}); the dense "
          f"exact delta_action (one launch of kernel 3 raw, two of B, one of "
          f"4) and the brute rows forward and reversed (two of B, none of A) "
          f"card == CPU at [64, 65, 64, 3] float64")
    return errs


def exact_cache_vs_brute(cfg, W=16, nstep=3):
    """The cached and the brute exact-F^2 flagship (its depth cut to
    Nstag=1, Nobdm=2) over nstep steps on the card from one start and one
    generator state, float64: paths within
    rtol 1e-8, atol 1e-10, counters equal (tests/test_exact_f2.py:100-165
    on the card)."""
    from pathintegralgroundstate_torch.state import init_state, \
        state_to_numpy
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    out = []
    for cache in (True, False):
        c = cfg.replace(exact_f2=True, f2_cache=cache, n_walkers=W,
                        dtype="float64", Nstag=1, Nobdm=2)
        system = make_system(c, torch.device("cuda"))
        state, stats = run_block(Sweeper(system), init_state(system), nstep)
        out.append((state_to_numpy(state), stats.counters.cpu().numpy()))
    (s_c, c_c), (s_b, c_b) = out
    for k in ("paths", "xend"):
        np.testing.assert_allclose(s_c[k], s_b[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_array_equal(c_c, c_b)
    print(f"[exact_f2] cached == brute over {nstep} steps on the card (W={W} "
          f"float64): paths within rtol 1e-8, counters equal {c_c.tolist()}")


def mala_phase(cfg, card, W=256, reps=5):
    """MALA on the card: the step size eps picked from a short scan as the
    one whose acceptance over two calls lies in [0.3, 0.8] nearest 0.55
    (after 2 warm-up steps of the cached exact flagship with MALA at W
    float32), then `reps` MALA phases (ops/smartmc.mala_move with the cache)
    timed, their acceptance, the peak memory, and one whole step's host
    syncs.  Returns eps."""
    from pathintegralgroundstate_torch.ops.pairwise import force_field
    from pathintegralgroundstate_torch.ops.smartmc import mala_move
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    c = cfg.replace(n_walkers=W, exact_f2=True, smart_mc=1e-6)
    system = make_system(c, torch.device("cuda"))
    sweeper = Sweeper(system)
    state, _ = run_block(sweeper, init_state(system), 2)
    src = sweeper.draws(state)
    active = torch.ones(W, dtype=torch.bool, device=system.device)

    def phase(eps, n):
        p = state.paths.clone()
        f = force_field(system, p[:, 1::2])
        accs = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            accs.append(mala_move(system, p, active, eps,
                                  *src.mala(p.shape), f)[1])
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) / n,
                float(torch.stack(accs).double().mean()))

    scan = {}
    for eps in (1e-7, 3e-7, 1e-6, 3e-6, 1e-5, 3e-5, 1e-4):
        scan[eps] = phase(eps, 2)[1]
    print("[mala] acceptance by eps (2 calls each, W=%d float32): %s" % (
        W, ", ".join(f"{e:g}: {a:.3f}" for e, a in scan.items())))
    ok = {e: a for e, a in scan.items() if 0.3 <= a <= 0.8}
    if not ok:
        raise AssertionError(f"mala: no eps of {list(scan)} accepts 30-80 %")
    eps = min(ok, key=lambda e: abs(ok[e] - 0.55))
    torch.cuda.reset_peak_memory_stats()
    dt, rate = phase(eps, reps)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"[mala] eps {eps:g}: {dt * 1e3:.1f} ms per MALA phase (W={W} "
          f"float32, whole-path move with the cache, {reps} calls), "
          f"acceptance {rate:.4f}, peak memory {peak:.3f} GiB ({card})")
    # a new System builds its device constants at its first step: warm up
    sweeper = Sweeper(make_system(c.replace(smart_mc=eps),
                                  torch.device("cuda")))
    state, _ = run_block(sweeper, state, 1)
    syncs = step_syncs(sweeper, state, sweeper.draws(state), "mala")
    if syncs:
        raise AssertionError(f"mala: {syncs} host syncs in one step")
    return eps


def exact_cli_phase(cfg, card, eps, W=256):
    """cli.main on a namelist of the flagship with exact_f2 = T and
    smart_mc = eps at W float32, 2 blocks of Nstep=2, the launch counts set
    to 0 before and read after: each block prints the MALA line; kernels
    A, 3, 4 and 5 never launch and kernel B twice per step (ThermEnergy).
    Outputs under build/chip_smoke_cli/exact_mala/."""
    import os

    from pathintegralgroundstate_torch.config import namelist_text

    repo = os.path.dirname(os.path.abspath(__file__))
    d = os.path.join(repo, "build", "chip_smoke_cli", "exact_mala")
    os.makedirs(d, exist_ok=True)
    nml = d + ".in"
    with open(nml, "w") as f:
        f.write(namelist_text(cfg.replace(n_walkers=W, exact_f2=True,
                                          smart_mc=eps)))
    nstep, nblk = 2, 2
    launches, log = cli_run(nml, "exact F^2 + MALA", d, "--set",
                            f"Nstep={nstep}", "--blocks", str(nblk))
    want = dict(pair_rows=0, pair_pot=2 * nstep * nblk, cascade=0,
                pair_delta=0, pair_u=0)
    if launches != want or log.count("> MALA movements") != nblk:
        raise AssertionError(f"cli exact F^2 + MALA: launches {launches}, "
                             f"MALA lines {log.count('> MALA movements')}")
    mala = [ln.strip() for ln in log.splitlines() if "MALA movements" in ln]
    print(f"[cli] exact F^2 + MALA (eps {eps:g}, W={W}): {'; '.join(mala)}")
    _block_rates(d, card, "exact F^2 + MALA", nstep=nstep)


# ---------------------------------------------------------------------------
# The pair-model variants, table mode and the 2-D dipolar gas
# ---------------------------------------------------------------------------

# (potential, Jastrow) of the [variants] phase: every potential on every
# kernel and every Jastrow on every kernel that carries u
VARIANTS = (("aziz2", "mcmillan_c1"), ("soft", "dipolar2d"),
            ("dipolar", "dipolar2d"), ("dipolar", "none"), ("none", "none"),
            ("none", "mcmillan_c1"))

# Operations per pair and Metropolis side of the dipolar pair model in 2-D,
# counted as _OPS: the minimum image and r^2 8, r and 1/r 2, V and dV/dr
# from 1/r 6 (V from r alone: 4), the force sum 5, the dipolar u from
# q = Rm/r with its C1 shift 6, one per masked accumulate.
_OPS_DIP = {"rows": 8 + 2 + 6 + 1 + 5 + 6 + 1,
            "delta_force": 8 + 2 + 6 + 1 + 5,
            "u": 8 + 2 + 6 + 1,
            "u_fused": 6 + 1,
            "pot_pair": 8 + 2 + 6 + 1 + 2 * 5,
            "pot_pair_plain": 8 + 1 + 4 + 1}
_PEAK_OPS64 = 34e12   # H100 SXM float64 outside the tensor cores (data sheet)


def _bound64(nbytes, ops):
    """_bound for float64 work: operations over the float64 rate."""
    tb, to = nbytes / _PEAK_BYTES * 1e3, ops / _PEAK_OPS64 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def variant_cfgs():
    """The [variants] phase's two shapes: the flagship's 3-D He-4 (N=64,
    M=65) and the dipolar gas's 2-D (N=256, M=17), both under PBC."""
    from pathintegralgroundstate_torch.flagship import (dipolar_cfg,
                                                        flagship_cfg)
    return (("flagship", flagship_cfg(256)), ("dipolar", dipolar_cfg(256)))


def _overflow_rows(R, xnew, ip, d=1e-4):
    """xnew with walker 5's row 1 at d from a partner: soft's r^-12
    overflows float32 there (and not float64)."""
    xn = xnew.clone()
    j = (int(ip[5, 1]) + 1) % R.shape[2]
    xn[5, 1] = R[5, 1, j]
    xn[5, 1, 0] += d
    return xn


def variant_case(cfg, dtype, W=256):
    """Every kernel against its plain form for one pair model and type, on
    liquid-like paths of cfg's shape: kernel A over a window of 8 rows with
    ip [W, B] and one coincident partner, forward (rows) and reversed
    (walker sums), f2 and u and neither; kernel B on both ThermEnergy
    views; kernel 3's raw and kernel 4's u mode at the gate's row and at
    16 rows; the action mode at the gate's row and over whole chains, with
    and without force; kernel 5 'ends' and 'interior' (every active slot
    accepted for the ideal gas).  Non-finite values, from a coincident
    partner of the soft or the dipolar core, must be exactly where the
    plain form has them (_close, action_check).  For soft in float32 also a
    row and a configuration with a pair 1e-4 apart, where r^-12 overflows.
    Returns (cases, {kernel: float64 max abs err})."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, dtype)
    sys64 = make_system(cfg, dev, torch.float64)
    paths = _flagship_paths(cfg, W, dtype, dev, seed=50)
    g = torch.Generator(device=dev).manual_seed(51)
    N, M, B = cfg.Np, cfg.M, 8
    label = f"{cfg.potential}/{cfg.jastrow} D={cfg.dim} N={N}"
    errs = dict.fromkeys(("pair_rows", "pair_pot", "pair_delta", "pair_u",
                          "cascade"), 0.0)
    f64 = dtype == torch.float64
    n = 0
    lo = (M - B) // 2
    R = paths[:, lo:lo + B]
    ib = torch.arange(lo, lo + B, device=dev)
    ip = torch.randint(0, N, (W, B), generator=g, device=dev)
    xnew, xold = _window_ip(R, ip, g)
    for rev in (False, True):
        e, _, c = rows_parity(system, sys64, R, xnew, xold, ip, ib, rev,
                              [(True, True), (False, False)], label,
                              reduce=rev)
        errs["pair_rows"] = max(errs["pair_rows"], e) if f64 else 0.0
        n += c
    for sl, view in ((slice(0, M - 1, 2), "even view"),
                     (slice(1, M - 1, 2), "odd view")):
        e, _ = pot_check(system, sys64, paths[:, sl], f"{label} {view}")
        errs["pair_pot"] = max(errs["pair_pot"], e) if f64 else 0.0
        n += 2
    w0 = (M - 16) // 2
    for Rr, ipr, lab in (
            (paths[:, :1], 5, "gate bead 0"),
            (paths[:, w0:w0 + 16],
             torch.randint(0, N, (W, 16), generator=g, device=dev),
             "16 rows ip[W, B]")):
        ed, eu, _, c = dense_raw_check(system, sys64, Rr, ipr, g,
                                       f"{label} {lab}")
        if f64:
            errs["pair_delta"] = max(errs["pair_delta"], ed)
            errs["pair_u"] = max(errs["pair_u"], eu)
        n += c
    for Rr, ipr, ibr, lab in (
            (paths[:, :1], 5, system.arange(0, 1), "gate"),
            (paths, torch.randint(0, N, (W,), generator=g, device=dev),
             system.arange(0, M), "whole chains")):
        xn, xo = _window_ip(Rr, ipr, g)
        for wf in (True, False):
            e, _, _ = action_check(system, sys64, Rr, xn, xo, ipr, ibr, wf,
                                   f"{label} {lab}")
            errs["pair_delta"] = max(errs["pair_delta"], e) if f64 else 0.0
            n += 1
    ideal = cfg.potential == "none" and cfg.jastrow == "none"
    for mode in ("ends", "interior"):
        _, e, _ = cascade_check(cfg, W, dtype, mode, seed=52,
                                outcomes="all" if ideal else "any")
        errs["cascade"] = max(errs["cascade"], e) if f64 else 0.0
        n += 1
    if cfg.potential == "soft" and not f64:
        xo_ = _overflow_rows(R, xnew, ip)
        plain = K.pair_rows_ref(system, R, xo_, xold, ip, chin_table(system),
                                ib, True, True)
        if not bool(torch.isinf(plain[5, 1]) | torch.isnan(plain[5, 1])):
            raise AssertionError(f"{label}: the plain float32 form did not "
                                 "overflow at r = 1e-4")
        rows_parity(system, sys64, R, xo_, xold, ip, ib, False,
                    [(True, True), (False, False)], f"{label} overflow")
        P = paths[:, 1:M - 1:2].clone()
        P[5, 2, 7] = P[5, 2, 8]
        P[5, 2, 7, 0] += 1e-4
        pot_check(system, sys64, P, f"{label} overflow pair")
        n += 3
    torch.cuda.synchronize()
    return n, errs


def variants_parity(card):
    """The [variants] phase: variant_case for every pair model of VARIANTS
    at both shapes of variant_cfgs, float32 and float64.  Returns {(shape,
    potential, Jastrow): {kernel: float64 max abs err}} (absolute: the
    soft core's values reach 1e15 where a proposal nears a partner, and
    its errors scale with them)."""
    kern = _kernel_fns()
    before = {k: fn.launches for k, fn in kern.items()}
    errs, total = {}, 0
    for shape, base in variant_cfgs():
        for pot, jas in VARIANTS:
            cfg = base.replace(potential=pot, jastrow=jas)
            for dtype in (torch.float32, torch.float64):
                t0 = time.perf_counter()
                n, e = variant_case(cfg, dtype)
                total += n
                if dtype == torch.float64:
                    errs[(shape, pot, jas)] = e
                    big = max(e, key=e.get)
                    what = f"; float64 max abs err {e[big]:.3e} ({big})"
                else:
                    what = ""
                print(f"[variants] {shape} {pot}/{jas} {str(dtype)[6:]}: "
                      f"{n} cases pass{what} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    ran = {k: fn.launches - before[k] for k, fn in kern.items()}
    if not all(ran.values()):
        raise AssertionError(f"[variants] a kernel never launched: {ran}")
    print(f"[variants] {total} cases of kernels A, B, 3, 4 and 5 pass "
          f"against their plain forms for {len(VARIANTS)} pair models "
          f"(every potential of aziz2, soft, dipolar, none and every Jastrow "
          f"of mcmillan_c1, dipolar2d, none) at the flagship's 3-D N=64 and "
          f"the dipolar gas's 2-D N=256 shapes, float32 and float64; "
          f"kernel launches {ran}")
    return errs


def dipolar_path_parity(W=1024):
    """Kernels A and B against their plain forms on the calls the dipolar
    path makes: one step of flagship.dipolar_cfg(W) (float64) during which
    the first call of each form of kernel A (window rows B, ip scalar or
    [1, B], reversed, walker sums, f2 and u) and of kernel B is checked on
    its own arguments before it runs, with rows_parity and pot_check, in
    float64 and on the same inputs cast to float32.  At W=1024 the lane
    rule (kernels.rows_lanes) gives the CM chains (B=17, walker sums) G=4,
    the end windows (B=4) G=16 and the fused interior span (B=11) G=8, each
    at its own layout (rows_layout): every G the path launches is held
    here.  Returns the printed lines' cases."""
    from pathintegralgroundstate_torch.flagship import dipolar_cfg
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    cfg = dipolar_cfg(W)
    dev = torch.device("cuda")
    sys64 = make_system(cfg, dev)
    sys32 = make_system(cfg, dev, torch.float32)
    N, D = cfg.Np, cfg.dim
    rows, pot = K.pair_rows, K.pair_pot
    seen, lanes, n = set(), set(), 0

    def f32(t):
        return t.float() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    def check_rows(system, R, xnew, xold, ip, tab, ib, need_wf=True,
                   need_f2=True, rev=False, row_weights=None, reduce=False):
        nonlocal n
        B = R.shape[1]
        form = (B, "scalar" if isinstance(ip, int) else tuple(ip.shape),
                need_wf, need_f2, rev, row_weights is not None, reduce)
        if form not in seen:
            seen.add(form)
            G = K.rows_lanes(R.shape[0], B, N)
            lanes.add(G)
            for s, args in ((sys64, (R, xnew, xold, ip, ib)),
                            (sys32, tuple(map(f32, (R, xnew, xold, ip,
                                                    ib))))):
                spw, wpb, _, smem = K.rows_layout(R.shape[0], B, N, D,
                                                  s.dtype.itemsize, G)
                e, x, c = rows_parity(s, sys64, *args, rev,
                                      [(need_wf, need_f2)],
                                      f"dipolar path {form}",
                                      f32(row_weights) if s is sys32
                                      else row_weights, reduce)
                n += c
                print(f"[variants] dipolar path kernel A [{R.shape[0]}, "
                      f"{B}, {N}, {D}] ip {form[1]} wf={need_wf} "
                      f"f2={need_f2} rev={rev} reduce={reduce} "
                      f"{str(s.dtype)[6:]}: G={G}, {spw} slots x {wpb} "
                      f"walkers a block, {smem} B shared; max abs err "
                      f"{e:.3e} ({x} excused at the cutoff)")
        return rows(system, R, xnew, xold, ip, tab, ib, need_wf, need_f2,
                    rev, row_weights, reduce)

    def check_pot(system, R, with_force=False):
        nonlocal n
        form = ("B",) + tuple(R.shape)
        if form not in seen:
            seen.add(form)
            for s, Rs in ((sys64, R), (sys32, R.float())):
                e, x = pot_check(s, sys64, Rs, f"dipolar path {form}",
                                 chunk=128)
                n += 2
                print(f"[variants] dipolar path kernel B "
                      f"{list(R.shape)} {str(s.dtype)[6:]}: both calls, "
                      f"max abs err {e:.3e} ({x} excused at the cutoff)")
        return pot(system, R, with_force)

    # each wrapper counts its launches on its own attributes, which it
    # reaches through the module's name: share them
    check_rows.__dict__, check_pot.__dict__ = rows.__dict__, pot.__dict__
    sweeper = Sweeper(sys64)
    state = init_state(sys64)
    K.pair_rows, K.pair_pot = check_rows, check_pot
    try:
        run_block(sweeper, state, 1)
    finally:
        K.pair_rows, K.pair_pot = rows, pot
    torch.cuda.synchronize()
    if lanes != {4, 8, 16}:
        raise AssertionError(f"[variants] the dipolar path ran kernel A at "
                             f"G = {sorted(lanes)}, not 4, 8 and 16")
    print(f"[variants] dipolar path W={W}: {len(seen)} call forms of "
          f"kernels A and B, {n} cases pass in float64 and float32 "
          f"(kernel A at G = {sorted(lanes)})")
    return n


def variants_timing(card, W=1024):
    """Every kernel at the dipolar gas's shapes, float64 (its type), W=1024,
    with CUDA events beside its plain form and its bound (_bound64,
    _OPS_DIP): kernel A over the CM move's whole chains [1024, 17, 256, 2]
    (walker sums, f2 and u), kernel B on both ThermEnergy views [256, 8,
    256, 2] (W=256: the plain form's pair tensors would take tens of GB at
    1024; dipolar_path_parity checks kernel B at the path's W), the dense
    kernel at the end gate's row [1024, 1, 256, 2] (action mode on the end
    row, raw mode, u mode), kernel 5 'ends' (S=2) and 'interior' (S=3).
    After each timing, check() holds the kernel's output on the timed
    inputs against the plain form's (rows_parity, pot_check, action_check,
    _close with _tol, cascade_check) and returns its max abs err.  Returns ({name: (ms, plain ms, (bound ms, by))},
    {name: max abs err})."""
    from pathintegralgroundstate_torch.flagship import dipolar_cfg
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref
    from pathintegralgroundstate_torch.ops.pairwise import chin_table
    from pathintegralgroundstate_torch.system import make_system

    cfg = dipolar_cfg(W)
    dev, dtype = torch.device("cuda"), torch.float64
    system = make_system(cfg, dev, dtype)
    paths = _flagship_paths(cfg, W, dtype, dev, seed=60)
    N, D, M = cfg.Np, cfg.dim, cfg.M
    es = 8
    tab = chin_table(system)
    times, errs = {}, {}

    def timed(name, fn, plain, bound, what, check):
        k, p = _events_ms(fn), _events_ms(plain, reps=3)
        times[name] = (k, p, bound)
        errs[name] = check()
        print(f"[time] dipolar {name} {what} float64: kernel {k:.4f} ms, "
              f"plain {p:.4f} ms, bound {bound[0]:.5f} ms ({bound[1]}; "
              f"{card}); max abs err against the plain form "
              f"{errs[name]:.3e}")

    def close(name, got, ref, terms):
        return max(_close(f"{name} dipolar timed", g, r,
                          *_tol(dtype, t))[0]
                   for g, r, t in zip(got, ref, terms))

    xold = paths[:, :, 5]
    xnew = (xold + 0.05).contiguous()
    ib = system.arange(0, M)
    timed("pair_rows", lambda: K.pair_rows(system, paths, xnew, xold, 5, tab,
                                           ib, True, True, reduce=True),
          lambda: K.pair_rows_ref(system, paths, xnew, xold, 5, tab, ib,
                                  True, True, reduce=True),
          _bound64(_nbytes(paths, xnew, xold, ib, tab) + W * es,
                   2 * W * M * N * _OPS_DIP["rows"]),
          f"CM whole chains [{W}, {M}, {N}, {D}] walker sums",
          lambda: rows_parity(system, system, paths, xnew, xold, 5, ib,
                              False, [(True, True)], "dipolar timed",
                              reduce=True)[0])
    for name, wf, sl in (("pair_pot", True, slice(1, M - 1, 2)),
                         ("pair_pot plain V", False, slice(0, M - 1, 2))):
        R = paths[:256, sl]
        Wb = R.shape[0] * R.shape[1]
        pairs = Wb * N * (N - 1) // 2
        timed(name, lambda: K.pair_pot(system, R, wf),
              lambda: K.pair_pot_ref(system, R, wf),
              _bound64(_nbytes(R) + 2 * Wb * es,
                       pairs * _OPS_DIP["pot_pair" if wf
                                        else "pot_pair_plain"]),
              f"force={wf} [{R.shape[0]}, {R.shape[1]}, {N}, {D}]",
              lambda: pot_check(system, system, R,
                                f"dipolar timed {name}")[0])
    R = paths[:, :1]
    xo = R[:, :, 5]
    xn = (xo + 0.05).contiguous()
    wf = dense_wf(system, True)
    ib0 = system.arange(0, 1)
    pairs = 2 * W * (N - 1)
    xb = 2 * W * D * es
    timed("pair_delta", lambda: K.pair_delta(system, R, xn, xo, 5, True, tab,
                                             ib0, wf),
          lambda: K.pair_delta_ref(system, R, xn, xo, 5, True, tab, ib0, wf),
          _bound64(_nbytes(R, ib0, tab) + xb + W * es,
                   pairs * (_OPS_DIP["delta_force"] + _OPS_DIP["u_fused"])),
          f"action end row [{W}, 1, {N}, {D}]",
          lambda: action_check(system, system, R, xn, xo, 5, ib0, True,
                               "dipolar timed")[0])
    timed("pair_delta raw", lambda: K.pair_delta(system, R, xn, xo, 5),
          lambda: K.pair_delta_ref(system, R, xn, xo, 5),
          _bound64(_nbytes(R) + xb + 2 * W * es,
                   pairs * _OPS_DIP["delta_force"]),
          f"raw (dpot, df2) [{W}, 1, {N}, {D}]",
          lambda: close("pair_delta raw", K.pair_delta(system, R, xn, xo, 5),
                        K.pair_delta_ref(system, R, xn, xo, 5),
                        ("dpot", "df2")))
    timed("pair_u", lambda: K.pair_u(system, R, xn, xo, 5),
          lambda: K.pair_u_ref(system, R, xn, xo, 5),
          _bound64(_nbytes(R) + xb + W * es, pairs * _OPS_DIP["u"]),
          f"u mode [{W}, 1, {N}, {D}]",
          lambda: close("pair_u", (K.pair_u(system, R, xn, xo, 5),),
                        (K.pair_u_ref(system, R, xn, xo, 5),), ("du",)))
    for mode in ("ends", "interior"):
        sysc, p, slots, rg, ru, act = _cascade_inputs(cfg, W, dtype, mode,
                                                      seed=61)
        acc = K.cascade(sysc, mode, p.clone(), slots, rg, ru, act, cfg.Nlev)
        L = 2 ** cfg.Nlev
        n_acc = int(acc.sum())
        nrows = (n_acc * (L if mode == "ends" else L - 1)
                 + int((act & ~acc).sum()))
        timed(f"cascade {mode}",
              lambda: K.cascade(sysc, mode, p, slots, rg, ru, act, cfg.Nlev),
              lambda: cascade_ref(sysc, mode, p, slots, rg, ru, act,
                                  cfg.Nlev, K.pair_rows_ref),
              _bound64(nrows * N * D * es + _nbytes(rg, ru, act)
                       + W * len(slots) * (L + 1) * D * es
                       + n_acc * L * D * es,
                       2 * nrows * N * _OPS_DIP["delta_force"]),
              f"S={len(slots)} [{W}, {len(slots)}, {L + 1}, {N}, {D}]",
              lambda: cascade_check(cfg, W, dtype, mode, seed=61,
                                    outcomes="any")[1])
    return times, errs


def tables_phase(card):
    """The [tables] phase, table mode on the card:
      1. the three RefRNG goldens (tests/golden/refrng_replay*.json)
         replayed through utils/replay on the card in float64, every
         Delta-S the port's delta_action with both tables, at atol 1e-12
         (tests/test_refrng.py's), with no kernel launch (the tables route
         every kernel away);
      2. BASELINE configuration #2, the flagship's He-4 at Np=16 with
         v_table = wf_table = T, W=1024 float32, through cli.main, Nstep=2,
         2 blocks: every kernel's launch count 0, finite e_vpi.out, each
         block's bead-updates/s;
      3. v_table alone in the reference order (bis_monoshot=F,
         bis_end_random_depth=T), Np=16, Nstep=2, 1 block: only kernel 4
         launches, once per end gate (2 Nstag Np per step), the dense
         action's u half, while its potential half runs the plain form.
    Outputs under build/chip_smoke_tables/."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import namelist_text
    from pathintegralgroundstate_torch.flagship import flagship_cfg
    from pathintegralgroundstate_torch.utils import replay

    repo = os.path.dirname(os.path.abspath(__file__))
    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    gdir = os.path.join(repo, "tests", "golden")
    t0 = time.perf_counter()
    for name, fn, keys in (
            ("refrng_replay.json", replay.replay_trajectory,
             ("nsteps", "Np", "Nb", "dim", "Lstag", "density", "dt", "Rm",
              "Nmax")),
            ("refrng_replay_bisection.json",
             replay.replay_bisection_trajectory,
             ("nsteps", "Np", "Nb", "dim", "Nlev", "density", "dt", "Rm")),
            ("refrng_replay_worm.json", replay.replay_worm_trajectory,
             ("nsteps", "Np", "Nb", "dim", "Lstag", "density", "dt", "Rm",
              "CWorm", "nequil"))):
        with open(os.path.join(gdir, name)) as f:
            gold = json.load(f)
        want = np.array([[[float.fromhex(v) for v in row] for row in sl]
                         for sl in gold["paths_hex"]])
        out = fn(seed=gold["seed"], device="cuda",
                 **{k: gold[k] for k in keys})
        got = out[0] if isinstance(out, tuple) else out
        err = float(np.abs(got - want).max())
        if not err <= 1e-12:
            raise AssertionError(f"[tables] {name}: max abs err {err}")
        if isinstance(out, tuple) and [list(e) for e in out[2]] != [
                list(e) for e in gold["events"]]:
            raise AssertionError(f"[tables] {name}: the worm events differ")
        print(f"[tables] golden {name} replayed on the card (float64, both "
              f"tables): max abs err {err:.1e} (atol 1e-12)")
    launches = {k: fn.launches for k, fn in kern.items()}
    if any(launches.values()):
        raise AssertionError(f"[tables] the goldens launched kernels: "
                             f"{launches}")
    print(f"[tables] the three goldens in {time.perf_counter() - t0:.1f} s, "
          f"no kernel launched: {launches}")

    root = os.path.join(repo, "build", "chip_smoke_tables")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    he16 = flagship_cfg(1024).replace(Np=16, v_table=True, wf_table=True)
    nml = os.path.join(root, "he4_n16_tables.in")
    with open(nml, "w") as f:
        f.write(namelist_text(he16))
    d = os.path.join(root, "he4_n16_tables")
    launches, _ = cli_run(nml, "BASELINE #2 He-4 N=16 v_table=wf_table=T "
                          "W=1024 float32", d, "--set", "Nstep=2",
                          "--blocks", "2", tag="tables")
    if any(launches.values()):
        raise AssertionError(f"[tables] table mode launched kernels: "
                             f"{launches}")
    rows, _ = _finite_total(os.path.join(d, "e_vpi.out"), 1)
    if rows != 2:
        raise AssertionError(f"[tables] e_vpi.out has {rows} rows")
    for f in ("jastrow.out", "potential.out"):
        if not os.path.getsize(os.path.join(d, f)):
            raise AssertionError(f"[tables] {f} is empty")
    _block_rates(d, card, "He-4 N=16 tables", nstep=2, tag="tables")

    vt = he16.replace(wf_table=False)
    nml = os.path.join(root, "he4_n16_vtable.in")
    with open(nml, "w") as f:
        f.write(namelist_text(vt))
    d = os.path.join(root, "he4_n16_vtable_reforder")
    nstep = 2
    launches, _ = cli_run(nml, "He-4 N=16 v_table=T reference order", d,
                          "--set", "bis_monoshot=F", "--set",
                          "bis_end_random_depth=T", "--set",
                          f"Nstep={nstep}", "--blocks", "1", tag="tables")
    gates = 2 * vt.Nstag * vt.Np * nstep
    want = {"pair_rows": 0, "pair_pot": 0, "cascade": 0, "pair_delta": 0,
            "pair_u": gates}
    if launches != want:
        raise AssertionError(f"[tables] v_table reference order: launches "
                             f"{launches}, expected {want}")
    _block_rates(d, card, "He-4 N=16 v_table reference order", nstep=nstep,
                 tag="tables")


def dipolar_phase(card):
    """The [dipolar] phase, BASELINE configuration #5 (flagship.dipolar_cfg:
    the 2-D dipolar Bose gas, N=256, float64) on the card:
      1. W=16 float64 replays, card (kernels) == CPU (plain forms), of the
         dipolar step and of the same with cascade=True;
      2. the dipolar path at W=1024 (main_path: warm-up, 3 timed steps,
         exact launch counts of kernels A, B and 5, bead-updates/s, peak
         memory, 0 host syncs), and the same with cascade=True;
      3. cli.main on its namelist at W=1024: Nstep=5, --burnin 2, --blocks
         2 (tools/dipolar2d.py's checks): E/N > 0 in each block, Et/N > 0,
         and the correlation hole of g(r), g[0] < 0.05 and g[1] < 0.5;
      4. the ideal Bose gas under PBC: the flagship's box and order with
         potential = jastrow = 'none', W=1024 float32, Nstep=3, 2 blocks,
         through cli.main: the mixed energy exactly 0 with zero variance in
         every block, and the kernels launched as on the Aziz flagship
         (the reference keeps this configuration on its kernels, which sum
         zero pair terms).
    Returns (the dipolar path's launches, the cascade path's, ms/step,
    bead-updates/s).  Outputs under build/chip_smoke_dipolar/."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import namelist_text
    from pathintegralgroundstate_torch.flagship import (dipolar_cfg,
                                                        flagship_cfg)
    from pathintegralgroundstate_torch.sweep import Sweeper
    from pathintegralgroundstate_torch.system import make_system

    dip = dipolar_cfg(1024)
    replay_check(dip, "dipolar N=256")
    replay_check(dip.replace(cascade=True), "dipolar N=256 + cascade")
    launches, dt, bups = main_path(dip, card, "dipolar")
    cas_launches, cas_dt, cas_bups = main_path(dip.replace(cascade=True),
                                               card, "dipolar+cascade")

    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_dipolar")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    nml = os.path.join(root, "dipolar.in")
    with open(nml, "w") as f:
        f.write(namelist_text(dip))
    d = os.path.join(root, "dipolar")
    nstep, nblk, burn = 5, 2, 2
    cl, _ = cli_run(nml, "dipolar N=256 W=1024 float64", d, "--set",
                    f"Nstep={nstep}", "--burnin", str(burn), "--blocks",
                    str(nblk), tag="dipolar")
    steps = nstep * (nblk + burn)
    want = expected_launches(dip, Sweeper(make_system(
        dip, torch.device("cuda"))), steps, True, [])
    for k, (n, exact) in want.items():
        if (cl[k] != n) if exact else (cl[k] < n):
            raise AssertionError(f"[dipolar] cli: {k} launched {cl[k]} "
                                 f"times over {steps} steps, expected {n}")
    e = np.loadtxt(os.path.join(d, "e_vpi.out"), ndmin=2)
    et = np.loadtxt(os.path.join(d, "et_vpi.out"), ndmin=2)
    gr = np.loadtxt(os.path.join(d, "gr_vpi.out"), ndmin=2)[:, 1]
    if e.shape[0] != nblk or not (e[:, 1] > 0).all() \
            or not (et[:, 1] > 0).all():
        raise AssertionError(f"[dipolar] cli: E/N {e[:, 1]}, Et/N "
                             f"{et[:, 1]}: a repulsive gas has E > 0")
    if not (gr[0] < 0.05 and gr[1] < 0.5):
        raise AssertionError(f"[dipolar] cli: no correlation hole, g(r) "
                             f"{gr[:5]}")
    print(f"[dipolar] cli: E/N per block {e[:, 1].tolist()}, Et/N "
          f"{et[:, 1].tolist()}; g(r) first bins {np.round(gr[:5], 4)}, "
          f"last 10 mean {float(np.mean(gr[-10:])):.4f}")
    _block_rates(d, card, "dipolar", first=1, nstep=nstep, tag="dipolar")

    ideal = flagship_cfg(1024).replace(potential="none", jastrow="none")
    nml = os.path.join(root, "ideal_pbc.in")
    with open(nml, "w") as f:
        f.write(namelist_text(ideal))
    d = os.path.join(root, "ideal_pbc")
    nstep, nblk = 3, 2
    il, log = cli_run(nml, "ideal Bose gas under PBC (flagship box and "
                      "order) W=1024 float32", d, "--set", f"Nstep={nstep}",
                      "--blocks", str(nblk), tag="dipolar")
    want = expected_launches(ideal, Sweeper(make_system(
        ideal, torch.device("cuda"))), nstep * nblk, True, [])
    for k, (n, exact) in want.items():
        if (il[k] != n) if exact else (il[k] < n):
            raise AssertionError(f"[dipolar] ideal gas: {k} launched "
                                 f"{il[k]} times, expected {n}")
    e = np.loadtxt(os.path.join(d, "e_vpi.out"), ndmin=2)
    if e.shape[0] != nblk or bool(np.any(e[:, 1:] != 0.0)) \
            or log.count("<E>  =  0 +/- 0\n") != nblk:
        raise AssertionError(f"[dipolar] ideal gas: E, K, V per block "
                             f"{e[:, 1:].tolist()}, expected exactly 0")
    print(f"[dipolar] ideal gas under PBC: <E> = 0 +/- 0 exactly in each of "
          f"{nblk} blocks; launches {il}")
    return launches, cas_launches, dt, bups, cas_dt, cas_bups


# ---------------------------------------------------------------------------
# [windows]: per-walker windows (shared_windows=False)
# ---------------------------------------------------------------------------

def windows_phase(cfg, card, shared):
    """Per-walker windows on the card: kernel A on a gathered per-walker
    window (ib [W, B]) against its float64 plain form, float32 and float64;
    the gather and the scatter of a window timed with CUDA events; a W=16
    float64 step card == CPU on recorded draws; the flagship with
    shared_windows=False at W=1024 float32 as a main path (exact launch
    counts, peak memory, 0 host syncs), read beside the shared-window
    flagship of [main] (`shared`: its (launches, s/step, bead-updates/s))
    in this call.  Returns the per-walker path's launches."""
    from pathintegralgroundstate_torch.ops import moves as mv
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    W, L, M = cfg.n_walkers, 2 ** cfg.Nlev, cfg.M
    n_opts = (M - 1 - L) // 2 + 1
    sys64 = make_system(cfg, dev, torch.float64)
    err, ncase = 0.0, 0
    for dtype in (torch.float32, torch.float64):
        system = make_system(cfg, dev, dtype)
        paths = _flagship_paths(cfg, W, dtype, dev, seed=41)
        g = torch.Generator(device=dev).manual_seed(42)
        ii = 2 * torch.randint(0, n_opts, (W,), generator=g, device=dev)
        R_seg = mv._slice_beads(paths, ii, L + 1)        # [W, L+1, N, D]
        want = torch.stack([paths[w, int(ii[w]):int(ii[w]) + L + 1]
                            for w in range(0, W, 97)])
        if not torch.equal(R_seg[::97], want):
            raise AssertionError("windows: the gathered window is not the "
                                 "walkers' own beads")
        for lo, hi, flags in ((1, L, [(False, True)]),      # bisection rows
                              (0, L, [(True, True), (False, False)])):
            R = R_seg[:, lo:hi]
            ib = mv.bead_index(system, ii, lo, hi)
            for k, ip in enumerate((7, torch.randint(
                    0, cfg.Np, (W,), generator=g, device=dev))):
                xnew, xold = _window_ip(R, ip, g)
                e, _, c = rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                      False, flags, f"per-walker window "
                                      f"rows {lo}..{hi - 1}",
                                      reduce=bool(k))
                ncase += c
                if dtype == torch.float64:
                    err = max(err, e)
    paths = _flagship_paths(cfg, W, torch.float32, dev, seed=43)
    seg = mv._slice_beads(paths, ii, L + 1)[:, :, 7].clone()
    gather_ms = _events_ms(lambda: mv._slice_beads(paths, ii, L + 1))
    scatter_ms = _events_ms(lambda: mv._win_write(paths, ii, 7, seg))
    gbytes = 2 * W * (L + 1) * cfg.Np * cfg.dim * 4
    print(f"[windows] kernel A on gathered per-walker windows (ib [W, B]): "
          f"{ncase} cases pass, float64 max abs err {err:.3e}; the gather "
          f"of a [{W},{L + 1},{cfg.Np},{cfg.dim}] float32 window "
          f"{gather_ms:.4f} ms (bound {gbytes / _PEAK_BYTES * 1e3:.4f} ms, "
          f"bytes), the scatter of the moved particle's beads "
          f"{scatter_ms:.4f} ms ({card})")
    per = cfg.replace(shared_windows=False)
    replay_check(per, "per-walker windows")
    launches, dt, bups = main_path(per, card, "windows")
    l0, dt0, bups0 = shared
    print(f"[windows] per-walker {dt * 1e3:.1f} ms/step, {bups:.4e} "
          f"bead-updates/s, launches {launches}; shared windows ([main], "
          f"this call) {dt0 * 1e3:.1f} ms/step, {bups0:.4e} bead-updates/s, "
          f"launches {l0} ({card})")
    if launches != l0:
        raise AssertionError("windows: the per-walker flagship's launches "
                             "differ from the shared-window flagship's")
    turns = _paired_steps((cfg, per))
    print(f"[windows] in turns shared, per-walker, per-walker, shared, 2 "
          f"steps each after a warm-up step: shared "
          f"{', '.join(f'{t:.1f}' for t in turns[0])} ms/step, per-walker "
          f"{', '.join(f'{t:.1f}' for t in turns[1])} ms/step ({card})")
    return launches, dict(gather_ms=gather_ms, scatter_ms=scatter_ms,
                          ms_step=dt * 1e3, shared_ms_step=dt0 * 1e3,
                          turns=turns)


def _paired_steps(cfgs, nstep=2):
    """ms/step of the two configurations' steps, each warmed up by one step,
    then timed in the turns a, b, b, a of nstep steps: [[a, a], [b, b]]."""
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    runs = []
    for c in cfgs:
        sweeper = Sweeper(make_system(c, torch.device("cuda")))
        runs.append([sweeper, run_block(sweeper, init_state(sweeper.system),
                                        1)[0]])
    times = [[], []]
    for i in (0, 1, 1, 0):
        sweeper, state = runs[i]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[i][1], _ = run_block(sweeper, state, nstep)
        torch.cuda.synchronize()
        times[i].append((time.perf_counter() - t0) * 1e3 / nstep)
    return times


# ---------------------------------------------------------------------------
# [mesh] and [dipolar mesh]: dp and tp sharding over ranks on the one card
# ---------------------------------------------------------------------------

def _repo():
    import os
    return os.path.dirname(os.path.abspath(__file__))


def _ranks(n, argv, timeout, label):
    """`torchrun --standalone --nproc-per-node n argv...` from the repo's
    root, each rank's output redirected into torchrun's log directory
    under build/; fails unless torchrun exits 0 within `timeout` seconds
    (at the timeout torchrun gets SIGTERM, on which it stops its ranks).
    Returns the ranks' stdout."""
    import glob
    import os
    import shutil
    import subprocess
    logs = os.path.join(_repo(), "build", "chip_smoke_torchrun",
                        label.replace(" ", "_"))
    shutil.rmtree(logs, ignore_errors=True)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "--redirects=3", f"--log-dir={logs}"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd + list(argv), cwd=_repo(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
        raise

    def read(rank, stream):
        paths = glob.glob(os.path.join(logs, "*", "attempt_0", str(rank),
                                       f"{stream}.log"))
        if len(paths) != 1:
            return ""
        with open(paths[0]) as fh:
            return fh.read()

    so = [read(r, "stdout") for r in range(n)]
    if proc.returncode != 0:
        raise AssertionError(
            f"{label}: torchrun exit {proc.returncode}: {err[-2500:]}\n"
            + "\n".join(f"rank {r}: {so[r][-600:]}\n"
                        f"{read(r, 'stderr')[-2500:]}" for r in range(n)))
    print(f"[mesh] {label}: {n} ranks under torchrun in "
          f"{time.perf_counter() - t0:.1f} s")
    return so


def _cfg_dict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def _cfg_of(d):
    from pathintegralgroundstate_torch.config import SimConfig
    return SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


def _timed_block(drv):
    """One warm-up step, then one Driver block timed: (state gathered over
    dp, block statistics as numpy, ms/step, collectives per step, their
    host ms per step)."""
    from pathintegralgroundstate_torch.parallel.mesh import gather_state
    from pathintegralgroundstate_torch.sweep import run_block, stats_to_numpy
    drv.state, _ = run_block(drv.sweeper, drv.state, 1)
    torch.cuda.synchronize()
    mesh = drv.mesh
    c0, s0 = (mesh.collectives, mesh.coll_s) if mesh else (0, 0.0)
    t0 = time.perf_counter()
    drv.state, stats = drv._block()
    torch.cuda.synchronize()
    n = drv.cfg.Nstep
    dt = (time.perf_counter() - t0) * 1e3 / n
    c1, s1 = (mesh.collectives, mesh.coll_s) if mesh else (0, 0.0)
    st = gather_state(drv.system, drv.state)
    return st, stats_to_numpy(stats), dt, (c1 - c0) / n, (s1 - s0) * 1e3 / n


def mesh_rank(spec_path, res_dir):
    """One rank of the [mesh] phase (`python3 chip_smoke.py --mesh-rank
    SPEC RES` under torchrun): each run of SPEC as one
    timed Driver block with distributed=True; the rank saves its results
    to RES/<run>_rank<R>.npz."""
    import os

    from pathintegralgroundstate_torch.driver import Driver
    rank = int(os.environ["RANK"])
    with open(spec_path) as f:
        spec = json.load(f)
    for name, d in spec.items():
        cfg = _cfg_of(d).replace(distributed=True)
        drv = Driver(cfg, out_dir=os.path.join(res_dir, name),
                     verbose=False)
        st, stats, ms, coll, coll_ms = _timed_block(drv)
        np.savez(os.path.join(res_dir, f"{name}_rank{rank}.npz"),
                 paths=st.paths.cpu().numpy(), ms=ms, coll=coll,
                 coll_ms=coll_ms, backend=drv.backend,
                 device=str(drv.system.device),
                 **{f"s_{k}": v for k, v in stats.items()})
    import torch.distributed as dist
    dist.barrier()
    dist.destroy_process_group()


def _hold(label, got, want, rtol, atol):
    """Counters and perm_hist equal; the other statistics within rtol/atol;
    returns the largest relative difference of the energy sums."""
    for k in ("counters", "perm_hist"):
        if not np.array_equal(got[f"s_{k}"], want[k]):
            raise AssertionError(f"{label}: {k} differ: "
                                 f"{got[f's_{k}']} vs {want[k]}")
    rel = 0.0
    for k, v in want.items():
        if k in ("counters", "perm_hist"):
            continue
        np.testing.assert_allclose(got[f"s_{k}"], v, rtol=rtol, atol=atol,
                                   err_msg=f"{label}: {k}")
        if k.startswith("sum"):
            rel = max(rel, float(abs(got[f"s_{k}"] - v) / max(abs(v),
                                                              1e-300)))
    return rel


def mesh_phase(cfg, card):
    """dp walker sharding on the card: 2 ranks (gloo: they share the one
    card) each run one Driver block of the flagship at global W=1024
    float32 with mesh_walkers=2 (3 steps after a warm-up step), and of the
    flagship at W=64 float64 (2 steps); this process runs the same blocks
    unsharded.  float32: kernel A's lane width is pinned from the global W
    (kernels.pair_rows), so each walker's sums are the unsharded run's;
    the counters and perm_hist must be equal, the statistics within rtol
    1e-5 (sums over walkers in another order and g(r)'s atomics), the
    paths within 1e-4.  float64: rtol 1e-10, paths 1e-10.  Then the dry
    run (parallel/dryrun.py) at dp 2 x tp 2 over 4 ranks.  Prints each
    rank's ms/step, its collectives per step and their share."""
    import os
    import shutil

    from pathintegralgroundstate_torch.driver import Driver

    root = os.path.join(_repo(), "build", "chip_smoke_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    runs = {"f32": cfg.replace(mesh_walkers=2, Nstep=3),
            "f64": cfg.replace(mesh_walkers=2, Nstep=2, n_walkers=64,
                               dtype="float64")}
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({k: _cfg_dict(c) for k, c in runs.items()}, f)
    _ranks(2, [os.path.abspath(__file__), "--mesh-rank", spec, root], 420,
           "flagship dp=2")
    report = {}
    for name, c in runs.items():
        drv = Driver(c.replace(mesh_walkers=1),
                     out_dir=os.path.join(root, name + "_one"),
                     verbose=False)
        st1, stats1, ms1, _, _ = _timed_block(drv)
        z = [np.load(os.path.join(root, f"{name}_rank{r}.npz"))
             for r in range(2)]
        f32 = c.dtype == "float32"
        rtol, atol, ptol = (1e-5, 1e-6, 1e-4) if f32 else (1e-10, 1e-12,
                                                          1e-10)
        rel = max(_hold(f"mesh {name} rank {r}", z[r], stats1, rtol, atol)
                  for r in range(2))
        dpath = float(np.abs(z[0]["paths"] - st1.paths.cpu().numpy()).max())
        if not dpath <= ptol:
            raise AssertionError(f"mesh {name}: paths differ by {dpath}")
        for r in range(2):
            print(f"[mesh] flagship W={c.n_walkers} {c.dtype} dp=2 rank {r} "
                  f"({z[r]['device']}, {z[r]['backend']}): "
                  f"{float(z[r]['ms']):.1f} ms/step, "
                  f"{float(z[r]['coll']):.2f} collectives/step, "
                  f"{float(z[r]['coll_ms']):.2f} ms/step in them "
                  f"({100 * float(z[r]['coll_ms']) / float(z[r]['ms']):.2f} "
                  f"%) ({card})")
        print(f"[mesh] flagship W={c.n_walkers} {c.dtype}: sharded == "
              f"unsharded ({ms1:.1f} ms/step unsharded): counters, "
              f"perm_hist equal, sums max rel diff {rel:.3e} (rtol {rtol}), "
              f"paths max abs diff {dpath:.3e} (tol {ptol})")
        report[name] = dict(ms=[float(x["ms"]) for x in z], unsharded_ms=ms1,
                            coll=float(z[0]["coll"]), rel=rel, dpath=dpath)
    so = _ranks(4, ["-m", "pathintegralgroundstate_torch.parallel.dryrun"],
                300, "dry run dp 2 x tp 2")
    rep = json.loads(so[0].strip().splitlines()[-1])
    if rep["world"] != 4 or any(v["mesh"] != [2, 2]
                                for v in rep["dryrun"].values()):
        raise AssertionError(f"mesh dry run: {rep}")
    if any(so[1:]):
        raise AssertionError("mesh dry run: a rank other than 0 printed")
    for tag, v in rep["dryrun"].items():
        print(f"[mesh] dry run {tag} dp x tp = 2 x 2 ({rep['backend']}): "
              f"sharded == unsharded, max rel diff {v['max_rel']:.3e}; "
              f"{v['ms']:.1f} ms per 2-step block, {v['collectives']} "
              f"collectives on rank 0 ({card})")
    report["dryrun"] = rep["dryrun"]
    return report


def dipolar_mesh_phase(card):
    """BASELINE #5 (flagship.dipolar_cfg, N=256 float64, W=1024) on the
    mesh the reference ran it on: dp 2 x tp 2 over 4 ranks (gloo, one
    card), through the CLI as torchrun starts it (2 blocks of 2 steps),
    against the unsharded CLI run of the same seed in this process.  Under
    tp every pair sum takes the plain forms, the unsharded run the
    kernels, so the two differ by rounding only: E/N, Et/N and the other
    block averages within rtol 1e-9, g(r) within 1e-9, the counters equal.
    Rank 0 alone prints and writes (the directory holds exactly the
    Driver's files, e_vpi.out two rows)."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import namelist_text
    from pathintegralgroundstate_torch.flagship import dipolar_cfg
    from pathintegralgroundstate_torch.sweep import COUNTER_NAMES

    root = os.path.join(_repo(), "build", "chip_smoke_dipolar_mesh")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    cfg = dipolar_cfg(1024, 2).replace(Nstep=2)
    nml = os.path.join(root, "dipolar.in")
    with open(nml, "w") as f:
        f.write(namelist_text(cfg))
    sh, one = os.path.join(root, "dp2tp2"), os.path.join(root, "one")
    so = _ranks(4, ["-m", "pathintegralgroundstate_torch", nml, "-o", sh,
                    "--set", "mesh_walkers=2", "--set", "mesh_pairs=2"], 900,
                "dipolar dp 2 x tp 2 CLI")
    if "BLOCK NUMBER : 2" not in so[0] or any(so[1:]):
        raise AssertionError("dipolar mesh: rank 0 must print both blocks "
                             "and no other rank anything")
    launches, _ = cli_run(nml, "dipolar unsharded", one, tag="mesh")
    want = sorted(os.listdir(one))
    if sorted(f for f in os.listdir(sh)) != sorted(
            f for f in want if f != "console.log"):
        raise AssertionError(f"dipolar mesh: files {os.listdir(sh)} vs "
                             f"{want}")
    for fn in ("e_vpi.out", "et_vpi.out", "gr_vpi.out", "sk_vpi.out"):
        a = np.loadtxt(os.path.join(sh, fn))
        b = np.loadtxt(os.path.join(one, fn))
        if fn in ("e_vpi.out", "et_vpi.out") and a.shape[0] != 2:
            raise AssertionError(f"dipolar mesh: {fn} has {a.shape[0]} rows")
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12,
                                   err_msg=f"dipolar mesh {fn}")

    def recs(d):
        with open(os.path.join(d, "metrics.jsonl")) as f:
            return [json.loads(x) for x in f]

    rs, r1 = recs(sh), recs(one)
    for a, b in zip(rs, r1):
        if [a[n] for n in COUNTER_NAMES] != [b[n] for n in COUNTER_NAMES]:
            raise AssertionError("dipolar mesh: counters differ")
        if a["backend"] != "gloo" or a["mesh"] != [2, 2]:
            raise AssertionError(f"dipolar mesh: {a['backend']} {a['mesh']}")
    e = np.loadtxt(os.path.join(sh, "e_vpi.out"))
    e1 = np.loadtxt(os.path.join(one, "e_vpi.out"))
    coll = (rs[1]["collectives"] - rs[0]["collectives"]) / cfg.Nstep
    coll_ms = (rs[1]["collective_s"] - rs[0]["collective_s"]) * 1e3 \
        / cfg.Nstep
    ms = rs[1]["time_s"] * 1e3 / cfg.Nstep
    print(f"[dipolar mesh] dp 2 x tp 2 CLI == unsharded CLI: E/N "
          f"{e[:, 1].tolist()} vs {e1[:, 1].tolist()} (max rel diff "
          f"{float(np.max(np.abs(e - e1) / np.abs(e1).clip(1e-300))):.3e}, "
          f"rtol 1e-9); rank 0, block 2: {ms:.1f} ms/step, {coll:.1f} "
          f"collectives/step, {coll_ms:.1f} ms/step in them "
          f"({100 * coll_ms / ms:.1f} %); unsharded block 2 "
          f"{r1[1]['time_s'] * 1e3 / cfg.Nstep:.1f} ms/step, launches "
          f"{launches} ({card})")
    return dict(e=e[:, 1].tolist(), e1=e1[:, 1].tolist(), ms=ms, coll=coll,
                coll_ms=coll_ms)


# ---------------------------------------------------------------------------
# [routes]: use_pallas=False and a plug-in potential run no kernel
# ---------------------------------------------------------------------------

def _card_step(system, start, src):
    """One step of `system` on the card from the numpy state `start` on
    the draw source src, the kernels' launch counts set to 0 before and
    read after: (state, stats as numpy, launches)."""
    from pathintegralgroundstate_torch.state import (state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import (Sweeper, stats_to_numpy,
                                                     zero_stats)
    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    state, stats = Sweeper(system).step(state_from_numpy(system, start),
                                        zero_stats(system), src)
    torch.cuda.synchronize()
    return (state_to_numpy(state), stats_to_numpy(stats),
            {k: fn.launches for k, fn in kern.items()})


def route_check(cfg_kernel, cfg_plain, label):
    """One W=16 float64 step of cfg_kernel on the card (the kernels), and
    the same step of cfg_plain on the card from the same state on the same
    draws (replayed): cfg_plain must launch no kernel and give the kernel
    step within the replay tolerances (states rtol 1e-9, atol 1e-11;
    statistics rtol 1e-9, atol 1e-9; counters equal)."""
    from pathintegralgroundstate_torch.state import init_state, state_to_numpy
    from pathintegralgroundstate_torch.sweep import Sweeper
    from pathintegralgroundstate_torch.system import make_system

    cuda = torch.device("cuda")
    ksys = make_system(cfg_kernel.replace(n_walkers=16, dtype="float64"),
                       cuda)
    state = init_state(ksys)
    start = state_to_numpy(state)
    rec = _Recorder(Sweeper(ksys).draws(state))
    s_k, t_k, l_k = _card_step(ksys, start, rec)
    psys = make_system(cfg_plain.replace(n_walkers=16, dtype="float64"),
                       cuda)
    s_p, t_p, l_p = _card_step(psys, start, _Replayer(rec.log, cuda))
    if any(l_p.values()) or not l_k["pair_rows"]:
        raise AssertionError(f"routes {label}: launches {l_p} (plain), "
                             f"{l_k} (kernels)")
    for k in s_k:
        if s_k[k].dtype.kind == "f":
            np.testing.assert_allclose(s_p[k], s_k[k], rtol=1e-9, atol=1e-11,
                                       err_msg=f"routes {label}: {k}")
        else:
            np.testing.assert_array_equal(s_p[k], s_k[k],
                                          err_msg=f"routes {label}: {k}")
    np.testing.assert_array_equal(t_p["counters"], t_k["counters"])
    rel = 0.0
    for k in t_k:
        if k != "counters":
            np.testing.assert_allclose(t_p[k], t_k[k], rtol=1e-9, atol=1e-9,
                                       err_msg=f"routes {label}: {k}")
    for k in ("sumE", "sumEt"):
        rel = max(rel, float(abs(t_p[k] - t_k[k]) / abs(t_k[k])))
    print(f"[routes] {label}: W=16 float64 step on the card launches "
          f"{sum(l_p.values())} kernels (the kernel step {l_k}) and equals "
          f"the kernel step on its draws (sums max rel diff {rel:.3e}, "
          f"rtol 1e-9)")
    return l_p


def routes_phase(cfg, card, W=1024):
    """use_pallas=False (every route off, as the reference's pallas_ok,
    pallas_ok_wf and use_cascade_kernel) on the flagship and the fused
    sweep with cascade, and a plug-in potential (a registered copy of the
    soft core, models/potentials.register) against the built-in soft:
    each step on the card launches 0 kernels and equals the kernel step.
    Then one flagship step at W=1024 float32 with use_pallas=False, timed,
    launching 0 kernels."""
    from pathintegralgroundstate_torch.models import potentials as P
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    route_check(cfg, cfg.replace(use_pallas=False), "flagship use_pallas=F")
    fc = cfg.replace(fused_sweep=True, cascade=True, Nstag=1, Nobdm=2)
    route_check(fc, fc.replace(use_pallas=False),
                "fused+cascade use_pallas=F (Nstag=1, Nobdm=2)")
    soft = P.get_potential("soft")
    P.register("soft_plugin", soft.v, soft.dvdr)
    sc = cfg.replace(potential="soft", Nstag=1, Nobdm=2)
    route_check(sc, sc.replace(potential="soft_plugin"),
                "registered soft copy vs built-in soft (Nstag=1, Nobdm=2)")
    system = make_system(cfg.replace(use_pallas=False, n_walkers=W),
                         torch.device("cuda"))
    sweeper = Sweeper(system)
    state = init_state(system)
    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = run_block(sweeper, state, 1)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = sum(fn.launches for fn in kern.values())
    if n or not math.isfinite(float(stats.sumE)):
        raise AssertionError(f"routes: use_pallas=F W={W} step launched {n}")
    print(f"[routes] flagship W={W} float32 use_pallas=F, the plain forms on "
          f"the card: first step {ms:.1f} ms, 0 kernel launches ({card})")


# ---------------------------------------------------------------------------
# [sp]: the SP bead sharding over 4 ranks on the one card
# ---------------------------------------------------------------------------

SP = 4


def sp_cfg(W=1024):
    """The reference's long-M SP case (docs/VALIDATION.md:238-244): He-4
    Aziz-II / McMillan C1, Np=64 at 0.365, Nb=128 (M=257), the staging
    sampler (Lstag=32, Nstag=5), no worm, float32, mesh_beads=4 (Mloc=64)."""
    from pathintegralgroundstate_torch.config import SimConfig
    return SimConfig(dim=3, Np=64, density=0.365, dt=5e-3, Nb=128,
                     sampling="sta", Lstag=32, Nstag=5, CMFreq=1,
                     delta_cm=0.12, Rm=1.2, swapping=False, CWorm=0.0,
                     Nobdm=0, n_walkers=W, dtype="float32",
                     potential="aziz2", jastrow="mcmillan_c1",
                     mesh_beads=SP, seed=1982)


def _sp_draws(system, seed):
    from pathintegralgroundstate_torch.utils.draws import DeviceDraws
    gen = torch.Generator(device=system.device)
    gen.manual_seed(seed)
    host = torch.Generator()
    host.manual_seed(seed + 1)
    return DeviceDraws(system, gen, host)


def _quiet_exchanges(mesh):
    """Patch the mesh's exchanges to run outside sync_debug_mode('warn'),
    so that step_syncs counts the host syncs outside them; returns the
    undo."""
    def quiet(fn):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("warn")
        return call
    mesh.ring_next = quiet(mesh.ring_next)
    mesh.all_reduce = quiet(mesh.all_reduce)

    def undo():
        del mesh.ring_next, mesh.all_reduce
    return undo


def sp_parity(system, paths, k):
    """Kernels A and B at the SP path's shapes, float32 against their
    float64 plain forms on the same inputs (rows_parity, pot_check: _tol's
    tolerances): shard k's two kinds of window as
    beadshard.shard_window builds them, the view of the shard at local
    start 0 and the last start's copy joined with the halo (the next
    shard's first bead; bead M-1 on the last shard), each with its global
    bead indices and segment_regrow's flags (need_wf=False, need_f2=True),
    per row and summed; and for k < 2 ThermEnergy's view k of the paths
    (paths[:, k:M-1:2]) without and with force.  Returns (kernel A's max
    abs err, kernel B's (None for k >= 2), values excused by the cutoff,
    slabs16 of each window, the largest finite |value| of kernel A's rows
    and of kernel B's outputs, which set the scale of the errors)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table
    from pathintegralgroundstate_torch.parallel.beadshard import shard_window
    from pathintegralgroundstate_torch.system import make_system

    cfg = system.cfg
    sys64 = make_system(cfg, paths.device, torch.float64)
    M, L, N = paths.shape[1], cfg.Lstag, cfg.Np
    Mloc = (M - 1) // cfg.mesh_beads
    lo = k * Mloc
    paths_l, halo = paths[:, lo:lo + Mloc], paths[:, lo + Mloc]
    g = torch.Generator(device=paths.device).manual_seed(40 + k)
    ip = (7 * k + 3) % N
    def amax(*ts):
        return max(float(t[torch.isfinite(t)].abs().max()) for t in ts)

    err_a, excused, slabs, max_a = 0.0, 0, [], 0.0
    for ii in (0, Mloc - L):
        R = shard_window(paths_l, halo, ii, L)[:, :L]
        if (R.data_ptr() == paths_l[:, ii:].data_ptr()) != (ii + L < Mloc):
            raise AssertionError(f"sp shard {k} ii={ii}: the window is not "
                                 "the kind expected")
        ib = torch.arange(lo + ii, lo + ii + L, device=paths.device)
        xnew, xold = _window_ip(R, ip, g)
        for reduce in (False, True):
            e, x, _ = rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                  False, [(False, True)],
                                  f"sp shard {k} ii={ii} ib {lo + ii}.."
                                  f"{lo + ii + L - 1}", reduce=reduce)
            err_a, excused = max(err_a, e), excused + x
        slabs.append(K.slabs16(R))
        max_a = max(max_a, amax(K.pair_rows(system, R, xnew, xold, ip,
                                            chin_table(system), ib, False,
                                            True)))
    err_b = max_b = None
    if k < 2:
        R = paths[:, k:M - 1:2]
        err_b, x = pot_check(system, sys64, R, f"sp ThermEnergy view {k}")
        excused += x
        max_b = amax(*K.pair_pot(system, R, True))
    torch.cuda.synchronize()
    return err_a, err_b, excused, slabs, max_a, max_b


def sp_rank(spec_path, res_dir):
    """One rank of the [sp] phase (`python3 chip_smoke.py --sp-rank SPEC
    RES` under torchrun, 4 ranks on the one card over gloo): (1) at W=16
    float64, M=129, 3 sharded SP sweeps against sp_staging_sweep_ref on
    this process (bitwise), kernel A's launches in both, and on rank 0 the
    same sweeps on the CPU's plain forms (the float64 replay tolerance);
    (2) the full-width path (sp_cfg) as a main path: 1 warm-up step, 3
    timed steps, launches, collectives and their ms by CUDA events, one
    step's host syncs outside the exchanges.  Saves RES/rank<R>.json."""
    import contextlib
    import os

    from pathintegralgroundstate_torch.parallel import beadshard as bs
    from pathintegralgroundstate_torch.parallel.mesh import (init_from_env,
                                                             make_mesh)
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import (COUNTER_NAMES, Sweeper,
                                                     run_block)
    from pathintegralgroundstate_torch.system import make_system

    rank = int(os.environ["RANK"])
    with open(spec_path) as f:
        spec = json.load(f)
    backend = init_from_env()
    mesh = make_mesh(1, 1, SP)
    cuda = torch.device("cuda")
    kern = _kernel_fns()
    out = dict(rank=rank, backend=backend)

    # (1) bitwise: sharded == unsharded, kernel A in both
    cfg = _cfg_of(spec["small"])
    ssys = make_system(cfg, cuda, mesh=mesh)
    rsys = make_system(cfg, cuda)
    paths = init_state(ssys).paths
    start = paths.clone()
    ref = paths.clone()
    W, M = paths.shape[:2]
    Mloc, L = (M - 1) // SP, cfg.Lstag
    src_s, src_r = _sp_draws(ssys, 5), _sp_draws(rsys, 5)
    halo = mesh.ring_next(paths[:, mesh.sp_rank * Mloc])
    if not torch.equal(halo, paths[:, (mesh.sp_rank + 1) % SP * Mloc]):
        raise AssertionError("sp: the ring's halo differs from the local "
                             "copy")
    n_a, logged, accs = [0, 0], [], []
    for it in range(3):
        ip = (7 * it + 3) % cfg.Np
        ds = src_s.sp_staging(it, W, SP, bs.n_starts(Mloc, L), L)
        dr = src_r.sp_staging(it, W, SP, bs.n_starts(Mloc, L), L)
        logged.append((ip, dr))
        a0 = kern["pair_rows"].launches
        acc_s = bs.sp_staging_sweep(ssys, paths, ip, L, ds)
        a1 = kern["pair_rows"].launches
        acc_r = bs.sp_staging_sweep_ref(rsys, ref, ip, SP, L, dr)
        n_a[0] += a1 - a0
        n_a[1] += kern["pair_rows"].launches - a1
        if not torch.equal(acc_s, acc_r):
            raise AssertionError(f"sp: accepts differ in call {it}")
        accs.append(int(acc_s.sum()))
    if not torch.equal(paths, ref):
        raise AssertionError("sp: sharded paths differ from "
                             "sp_staging_sweep_ref's")
    if n_a != [3, 3 * SP] or not sum(accs):
        raise AssertionError(f"sp: kernel A launches {n_a}, accepts {accs}")
    out.update(small_launches=n_a, small_accepted=accs)
    if rank == 0:
        csys = make_system(cfg, "cpu")
        cpaths = start.cpu()
        for ip, dr in logged:
            bs.sp_staging_sweep_ref(csys, cpaths, ip, SP, L, [
                (ii, g.cpu(), u.cpu()) for ii, g, u in dr])
        diff = float((cpaths - paths.cpu()).abs().max())
        np.testing.assert_allclose(paths.cpu().numpy(), cpaths.numpy(),
                                   rtol=1e-9, atol=1e-11,
                                   err_msg="sp: card vs CPU plain forms")
        out["cpu_max_abs_diff"] = diff
    torch.distributed.barrier()

    # (2) the full-width path
    cfg = _cfg_of(spec["full"])
    system = make_system(cfg, cuda, mesh=mesh)
    sweeper = Sweeper(system)
    state = init_state(system)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, warm = run_block(sweeper, state, 1)
    torch.cuda.synchronize()
    out["warm_s"] = time.perf_counter() - t0
    nstep = 3
    for fn in kern.values():
        fn.launches = 0
    c0, s0 = mesh.collectives, mesh.coll_s
    torch.distributed.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, stats = run_block(sweeper, state, nstep)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / nstep
    out.update(ms=dt * 1e3, coll=(mesh.collectives - c0) / nstep,
               coll_ms=(mesh.coll_s - s0) * 1e3 / nstep,
               launches={k: fn.launches for k, fn in kern.items()},
               counters=dict(zip(COUNTER_NAMES,
                                 (stats.counters + warm.counters).tolist())),
               E=float(stats.sumE / stats.n_diag) / cfg.Np,
               Et=float(stats.sumEt / stats.n_diag) / cfg.Np,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    want = expected_launches(cfg, sweeper, nstep, False, [])
    for k, (n, _) in want.items():
        if out["launches"][k] != n:
            raise AssertionError(f"sp rank {rank}: {k} launched "
                                 f"{out['launches'][k]}, expected {n}")
    undo = _quiet_exchanges(mesh)
    try:
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            syncs = step_syncs(sweeper, state, None, f"sp rank {rank}")
    finally:
        undo()
    out["syncs"] = syncs
    out["parity"] = sp_parity(system, state.paths, mesh.sp_rank)
    with open(os.path.join(res_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def sp_phase(card):
    """The SP bead sharding on the card: 4 ranks under torchrun (gloo, one
    card) run sp_rank; this process runs the same full-width path
    unsharded (sp_staging_sweep_ref, main_path) and then, as the users run
    it, the CLI with mesh_beads=4 under torchrun (2 blocks of 2 steps),
    whose block energies must equal the unsharded blocks of this process
    within float32 rtol 1e-5.  Returns (rank 0's launches over the 3 timed
    steps, the report)."""
    import os
    import shutil

    from pathintegralgroundstate_torch.config import namelist_text
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system

    root = os.path.join(_repo(), "build", "chip_smoke_sp")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    full = sp_cfg()
    small = full.replace(Nb=64, Lstag=16, n_walkers=16, dtype="float64")
    spec = os.path.join(root, "spec.json")
    with open(spec, "w") as f:
        json.dump({"small": _cfg_dict(small), "full": _cfg_dict(full)}, f)
    _ranks(SP, [os.path.abspath(__file__), "--sp-rank", spec, root], 420,
           "sp 4 ranks")
    z = []
    for r in range(SP):
        with open(os.path.join(root, f"rank{r}.json")) as f:
            z.append(json.load(f))
    print(f"[sp] W=16 float64 M=129 Lstag=16, 3 calls: sharded == "
          f"sp_staging_sweep_ref bitwise on every rank (kernel A "
          f"{z[0]['small_launches'][0]} launches sharded per rank, "
          f"{z[0]['small_launches'][1]} unsharded; accepted "
          f"{z[0]['small_accepted']}); the ring's halo == the local copy; "
          f"card == CPU plain forms, max abs diff "
          f"{z[0]['cpu_max_abs_diff']:.3e} (rtol 1e-9, atol 1e-11)")
    for r in range(1, SP):
        if z[r]["counters"] != z[0]["counters"] or z[r]["E"] != z[0]["E"]:
            raise AssertionError(f"sp: rank {r} differs from rank 0")
    for zr in z:
        if zr["syncs"]:
            raise AssertionError(f"sp rank {zr['rank']}: {zr['syncs']} host "
                                 "syncs outside the exchanges")
        print(f"[sp] {full.n_walkers} walkers M={full.M} Np={full.Np} "
              f"float32 mesh_beads={SP} rank {zr['rank']} ({zr['backend']}):"
              f" {zr['ms']:.1f} ms/step, {zr['coll']:.1f} collectives/step,"
              f" {zr['coll_ms']:.1f} ms/step in them ("
              f"{100 * zr['coll_ms'] / zr['ms']:.1f} %), launches "
              f"{zr['launches']}, 0 host syncs outside the exchanges, peak "
              f"{zr['peak_gib']:.3f} GiB ({card})")
    pa = [zr["parity"] for zr in z]
    print(f"[sp] kernels A and B at the path's shapes, float32 against the "
          f"float64 plain forms (_tol, weighted as the terms): kernel A on "
          f"each shard's view window (ii=0) and halo copy window "
          f"(ii=Mloc-L), [{full.n_walkers}, {full.Lstag}, {full.Np}, 3], "
          f"global ib up to {full.M - 2}, per row and summed, max abs err "
          f"{max(p[0] for p in pa):.3e} (per rank "
          f"{', '.join(f'{p[0]:.3e}' for p in pa)}; largest |row| "
          f"{max(p[4] for p in pa):.3e}), slabs16 {[p[3] for p in pa]}; "
          f"kernel B on both ThermEnergy views [{full.n_walkers}, "
          f"{full.Nb}, {full.Np}, 3] without and with force, max abs err "
          f"{max(pa[0][1], pa[1][1]):.3e} (largest |value| "
          f"{max(pa[0][5], pa[1][5]):.3e}); values "
          f"beyond tolerance, each at a pair within 1e-5 of rcut^2: "
          f"{sum(p[2] for p in pa)}")
    print(f"[sp] counters over 4 steps {z[0]['counters']}; <E>/N "
          f"{z[0]['E']:.4f} <Et>/N {z[0]['Et']:.4f}")
    one_launches, one_dt, _ = main_path(full, card, "sp unsharded")

    # the CLI under torchrun against the unsharded blocks of this process
    cli_cfg = full.replace(Nstep=2, Nblock=2)
    nml = os.path.join(root, "sp.in")
    with open(nml, "w") as f:
        f.write(namelist_text(cli_cfg.replace(mesh_beads=1)))
    out = os.path.join(root, "cli")
    so = _ranks(SP, ["-m", "pathintegralgroundstate_torch", nml, "-o", out,
                     "--set", f"mesh_beads={SP}"], 420, "sp CLI")
    if "BLOCK NUMBER : 2" not in so[0] or any(so[1:]):
        raise AssertionError("sp CLI: rank 0 must print both blocks and no "
                             "other rank anything")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        recs = [json.loads(x) for x in f]
    system = make_system(cli_cfg, torch.device("cuda"))
    sweeper = Sweeper(system)
    state = init_state(system)
    rel = 0.0
    for rec in recs:
        state, st = run_block(sweeper, state, cli_cfg.Nstep)
        for k in ("E", "Et"):
            want = float(getattr(st, f"sum{k}") / st.n_diag) / cli_cfg.Np
            d = abs(rec[f"Av{k}"] - want) / abs(want)
            if not d <= 1e-5:
                raise AssertionError(f"sp CLI block {rec['block']}: {k}/N "
                                     f"{rec[f'Av{k}']} vs {want}")
            rel = max(rel, d)
        if rec.get("sp") != SP or rec["backend"] != "gloo":
            raise AssertionError(f"sp CLI: {rec.get('sp')} {rec['backend']}")
    e = [r["AvE"] for r in recs]
    coll = (recs[1]["collectives"] - recs[0]["collectives"]) / 2
    print(f"[sp] CLI mesh_beads={SP} under torchrun, 2 blocks of 2 steps: "
          f"E/N {e} == unsharded blocks (max rel diff {rel:.3e}, rtol "
          f"1e-5); rank 0 block 2 {recs[1]['time_s'] * 1e3 / 2:.1f} "
          f"ms/step, {coll:.1f} collectives/step ({card})")
    return z[0]["launches"], dict(ranks=z, unsharded_ms=one_dt * 1e3,
                                  unsharded_launches=one_launches, cli_e=e,
                                  cli_rel=rel)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(*sys.argv[2:4])
    if sys.argv[1:2] == ["--sp-rank"]:
        return sp_rank(*sys.argv[2:4])
    from pathintegralgroundstate_torch.flagship import flagship_cfg
    from pathintegralgroundstate_torch.utils import build

    t_start = time.perf_counter()

    def clock(phase):
        print(f"[clock] {phase} at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    card = _card()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {name} | {card} | torch {torch.__version__} "
          f"CUDA {torch.version.cuda} | {torch.cuda.device_count()} device(s)")

    _, seconds, log = build.build()
    build.kernels()
    print(f"[build] nvcc {seconds:.1f} s -> {build.BUILD_ROOT}")
    for line in build.ptxas_summary(log):
        print(f"[build]   {line}")

    cfg = flagship_cfg(1024)
    clock("kernels")
    errs, shapes, bounds = kernel_parity(cfg, card)
    clock("cascade")
    cas_err, cas_times = cascade_parity(cfg, card)
    layout_parity(cfg)
    clock("pot")
    errs["pair_pot"] = max(errs["pair_pot"], pot_parity(cfg))
    clock("dense")
    dense_err, dense_times = dense_parity(cfg, card)
    clock("dims")
    dims_parity(cfg)
    clock("variants")
    var_errs = variants_parity(card)
    dipolar_path_parity()
    var_times, timed_errs = variants_timing(card)
    clock("replay")
    fused = cfg.replace(fused_sweep=True)
    ref_order = cfg.replace(bis_monoshot=False, bis_end_random_depth=True)
    replay_check(cfg)
    replay_check(fused, "fused", cut=True)
    replay_check(fused.replace(cascade=True), "fused+cascade", cut=True)
    replay_check(ref_order, "reference order")
    replay_check(cfg.replace(sampling="sta", regrow="scan"),
                 "staging + scan", cut=True)
    replay_check(fused.replace(bis_monoshot=False), "fused per level",
                 cut=True)
    replay_check(cfg.replace(dim=2, density=0.26), "2-D film", cut=True)
    trap_replays()
    clock("exact_f2")

    # exact F^2: the kernels at the brute path's shapes, the replays of its
    # forms (kernels A and 5 never launch on them), cached == brute
    exact = cfg.replace(exact_f2=True)
    exact_errs = exact_parity(cfg)
    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    replay_check(exact, "exact F^2 flagship, cached", cut=True)
    replay_check(exact.replace(bis_monoshot=False, bis_end_random_depth=True),
                 "exact F^2 reference order, cached", cut=True)
    replay_check(exact.replace(fused_sweep=True), "exact F^2 fused, cached",
                 cut=True)
    replay_check(exact.replace(sampling="sta"),
                 "exact F^2 worm + staging, cached", cut=True)
    replay_check(exact.replace(f2_cache=False), "exact F^2 flagship, brute",
                 cut=True)
    replay_check(exact.replace(smart_mc=1e-6), "exact F^2 + MALA, cached",
                 cut=True)
    counts = {k: fn.launches for k, fn in kern.items()}
    if counts["pair_rows"] or counts["cascade"]:
        raise AssertionError(f"exact F^2 replays launched kernel A or 5: "
                             f"{counts}")
    print(f"[exact_f2] launches over the exact replays: {counts}")
    exact_cache_vs_brute(cfg)
    clock("main")

    flagship = main_path(cfg, card)
    launches = flagship[0]
    main_path(fused, card, "fused")
    cas_launches, _, _ = main_path(fused.replace(cascade=True), card,
                                   "fused+cascade")
    ref_launches, _, _ = main_path(ref_order, card, "reference order")
    ex_launches, _, _ = main_path(exact, card, "exact_f2")
    br_launches, _, _ = main_path(exact.replace(f2_cache=False), card,
                                  "exact_f2 brute")
    clock("windows")
    win_launches, _ = windows_phase(cfg, card, flagship)
    clock("mala")
    eps = mala_phase(cfg, card)
    clock("cli")
    cli_phase(cfg, card)
    exact_cli_phase(cfg, card, eps)
    clock("trap")
    trap_cli_phase(card)
    clock("tables")
    tables_phase(card)
    clock("dipolar")
    dip_launches, dcas_launches, *_ = dipolar_phase(card)
    clock("mesh")
    mesh_phase(cfg, card)
    clock("dipolar mesh")
    dipolar_mesh_phase(card)
    clock("routes")
    routes_phase(cfg, card)
    clock("sp")
    sp_launches, _ = sp_phase(card)
    clock("end")

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
        "jax", "jaxlib", "pathintegralgroundstate_tpu"))
    if loaded:
        raise AssertionError(f"JAX or reference modules were loaded: "
                             f"{loaded[:5]}")
    print("[imports] no module of jax, jaxlib or pathintegralgroundstate_tpu "
          "was loaded")

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound,
              key=None):
        key = key or name
        return {"name": name, "route": "cuda",
                "source": f"pathintegralgroundstate_torch/csrc/{source}",
                "replaces": f"pathintegralgroundstate_tpu/ops/{replaces}",
                "launches": launches,
                "max_abs_err": max(err, exact_errs.get(name, 0.0)),
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                "exact_f2_launches": ex_launches[key],
                "exact_f2_brute_launches": br_launches[key],
                "windows_launches": win_launches[key],
                "sp_launches": sp_launches[key]}

    rows_ms, rows_plain = shapes["pair_rows B=16 end move"]
    pot_ms, pot_plain = shapes["pair_pot [1024,32,64,3] force=True"]
    ends = cas_times["ends"]
    print(card)
    print(json.dumps({"kernels": [
        entry("pair_rows", "pair_rows.cu", "pallas_kernels.py:300",
              launches["pair_rows"], errs["pair_rows"], rows_ms, rows_plain,
              bounds["pair_rows"]),
        entry("pair_pot", "pair_pot.cu", "pallas_kernels.py:437",
              launches["pair_pot"], errs["pair_pot"], pot_ms, pot_plain,
              bounds["pair_pot force=True"]),
        entry("pair_delta", "pair_delta.cu", "pallas_kernels.py:392",
              ref_launches["pair_delta"], dense_err["pair_delta"],
              *dense_times["pair_delta"]),
        dict(entry("pair_u", "pair_delta.cu", "pallas_kernels.py:413",
                   ref_launches["pair_delta"], dense_err["pair_u"],
                   *dense_times["pair_u"]),
             shares_launch_with="pair_delta",
             ms_is="u's marginal time in pair_delta's launch",
             separate_launches=ref_launches["pair_u"],
             **dense_times["pair_u_extra"]),
        entry("cascade", "cascade.cu", "cascade_kernels.py:322",
              cas_launches["cascade"], cas_err, *ends)] + [
        dict(entry(f"{name} [dipolar N=256 float64]", src, rep, n,
                   max(var_errs[("dipolar", "dipolar", "dipolar2d")][kname],
                       timed_errs[tname]),
                   *var_times[tname], key=kname),
             main_path="dipolar" + (" + cascade" if kname == "cascade"
                                    else ""),
             max_abs_err_is="float64, dipolar/dipolar2d at N=256 "
                            "([variants] and the timed inputs)",
             exact_f2_launches=None, exact_f2_brute_launches=None,
             windows_launches=None, sp_launches=None)
        for name, kname, tname, src, rep, n in (
            ("pair_rows", "pair_rows", "pair_rows", "pair_rows.cu",
             "pallas_kernels.py:300", dip_launches["pair_rows"]),
            ("pair_pot", "pair_pot", "pair_pot", "pair_pot.cu",
             "pallas_kernels.py:437", dip_launches["pair_pot"]),
            ("pair_delta", "pair_delta", "pair_delta", "pair_delta.cu",
             "pallas_kernels.py:392", dip_launches["pair_delta"]),
            ("pair_u", "pair_u", "pair_u", "pair_delta.cu",
             "pallas_kernels.py:413", dip_launches["pair_u"]),
            ("cascade ends", "cascade", "cascade ends", "cascade.cu",
             "cascade_kernels.py:322", dcas_launches["cascade"]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
