"""Whole steps, blocks and runs of the port on a CUDA device, as its users
run them:

  * each step form as a main path: every kernel's launches exact from the
    move sites it visits, the counters and acceptance ratios sane, the
    statistics finite, and no host sync in a step;
  * steps on the card against the CPU from the same draws (the exact-F^2
    forms, where kernels A and 5 never launch, the dipolar gas, per-walker
    windows), the exact-F^2 cache against the brute form, the routes that
    take every kernel off, MALA;
  * cli.main on the card: the flagship and reference orders, the resume
    probe as a process, exact F^2 with MALA, the trap, table mode, the
    RefRNG goldens, the dipolar gas and the ideal Bose gas;
  * ranks on the one card under torchrun (tests/torch_mesh_worker.py): dp
    walker sharding and the dry run, the dipolar gas at dp 2 x tp 2, the
    SP bead ring.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_runs.py
"""

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch_card
from torch_mesh_worker import REPO, step_syncs, torchrun

from pathintegralgroundstate_torch.config import SimConfig, namelist_text
from pathintegralgroundstate_torch.flagship import (dipolar_cfg, flagship_cfg,
                                                    trap_worm_cfg)
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.state import init_state
from pathintegralgroundstate_torch.sweep import (COUNTER_NAMES, Sweeper,
                                                 run_block)
from pathintegralgroundstate_torch.system import make_system

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)

WORKER = os.path.join(REPO, "tests", "torch_mesh_worker.py")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# Launches from the move sites a step visits
# ---------------------------------------------------------------------------

def _glue_launches(cfg, sweeper, visits, cache=False):
    """Launches of each glue kernel over `visits` particle visits of the
    unfused monoshot sweep: the head and the tail unless paired (paired
    ends defer their write; with the exact-F^2 cache the ends are never
    paired), the interior with a shared window start; none off bis_route,
    and with the cache none off fold_route."""
    system = sweeper.system
    if not kernels.bis_route(system) or (cache
                                         and not kernels.fold_route(system)):
        return 0
    paired = sweeper.paired_ends and not cache
    return visits * ((0 if paired else 2) + (1 if cfg.shared_windows else 0))


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
    {kernel: count}.  Kernel A: one pass per CM move; with the worm two
    for each of open and close (both worm halves) and per worm round eight
    (the half translations, heads, tails and stagings of both halves) and
    the swap's one; one per window of the diagonal sweep, in the per-level
    form from the end moves' drawn depths: one pass per level, plus the
    gate's own pass with batched randoms (without them the gate is the
    dense delta_action, one launch of kernel 3 that also runs kernel 4's
    pass, and no separate kernel-4 launch).  Per-walker windows
    (shared_windows=False) launch as shared ones: the gathered window is
    one kernel-A pass like the view.  The glue kernels: one launch each per
    move of the unfused monoshot sweep that bis_route and the move's window
    let them run (_glue_launches)."""
    Np, Ns = cfg.Np, cfg.Nstag
    rows = (Np * (cfg.CMFreq > 0)
            + ((4 + cfg.Nobdm * (8 + cfg.swapping)) if cfg.CWorm > 0 else 0))
    rows, casc, dense, glue = nstep * rows, 0, 0, 0
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
        glue = _glue_launches(cfg, sweeper, visits)
    else:
        nlev = cfg.Nlev
        rows += visits * nlev
        if use_rand:
            rows += 2 * visits * (max(nlev, 2) + 1)
        else:
            assert len(depths) == 2 * visits, (
                f"{len(depths)} end-move depths drawn, expected "
                f"{2 * visits}")
            rows += sum(depths)
            dense = 2 * visits
    return {"pair_rows": rows, "pair_pot": 2 * nstep, "cascade": casc,
            "pair_delta": dense, "pair_u": 0, "bis_propose": glue,
            "bis_accept": glue, "pair_fold": 0}


def _fold_calls(cfg, nstep):
    """Window calls over nstep steps of the unfused monoshot sweep with
    the exact-F^2 cache, each one fold: per step one per CM move, with the
    worm four for open and close and per worm round eight and the swap's
    one, and a head, a tail and an interior window per particle visit."""
    worm = (4 + cfg.Nobdm * (8 + cfg.swapping)) if cfg.CWorm > 0 else 0
    return nstep * (cfg.Np * (cfg.CMFreq > 0) + worm
                    + 3 * cfg.Nstag * cfg.Np)


def exact_launches(cfg, sweeper, nstep, use_rand, calls, visits):
    """Exact launches of the unfused monoshot sweep with exact F^2 over
    nstep steps (calls: its CM and worm window calls): kernels A and 5
    never (the reference's routing), kernel B twice per step for
    ThermEnergy and, without the cache, twice per F^2-carrying window call
    (every call of the monoshot sweep; the field difference of R' and R),
    kernels 3 and 4 never (batched randoms: no dense gate); the glue
    kernels as without exact F^2, with the cache only on fold_route
    (_glue_launches); the fold kernel once per window call with the cache
    (the calls that carry F^2 without it) on fold_route, else never."""
    if sweeper.fused_diag or cfg.sampling != "bis" or not cfg.bis_monoshot \
            or not use_rand:
        raise ValueError("exact_launches models the unfused monoshot sweep "
                         "with batched randoms only")
    brute = 0 if cfg.f2_cache else 2 * (calls + 3 * visits)
    glue = _glue_launches(cfg, sweeper, visits, cfg.f2_cache)
    fold = (_fold_calls(cfg, nstep) if cfg.f2_cache
            and kernels.fold_route(sweeper.system) else 0)
    return {"pair_rows": 0, "pair_pot": 2 * nstep + brute, "cascade": 0,
            "pair_delta": 0, "pair_u": 0, "bis_propose": glue,
            "bis_accept": glue, "pair_fold": fold}


def _zeroed():
    """The kernels' wrappers with their launch counts set to 0."""
    kern = torch_card._kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    return kern


def _counts(kern):
    return {k: fn.launches for k, fn in kern.items()}


# ---------------------------------------------------------------------------
# Main paths
# ---------------------------------------------------------------------------

SP = 4


def sp_cfg(W):
    """The reference's long-M SP case (docs/VALIDATION.md:238-244): He-4
    Aziz-II / McMillan C1, Np=64 at 0.365, Nb=128 (M=257), the staging
    sampler (Lstag=32, Nstag=5), no worm, float32, mesh_beads=4 (Mloc=64)."""
    return SimConfig(dim=3, Np=64, density=0.365, dt=5e-3, Nb=128,
                     sampling="sta", Lstag=32, Nstag=5, CMFreq=1,
                     delta_cm=0.12, Rm=1.2, swapping=False, CWorm=0.0,
                     Nobdm=0, n_walkers=W, dtype="float32",
                     potential="aziz2", jastrow="mcmillan_c1",
                     mesh_beads=SP, seed=1982)


FUSED = dict(fused_sweep=True)
CASCADE = dict(fused_sweep=True, cascade=True)
REF_ORDER = dict(bis_monoshot=False, bis_end_random_depth=True)
EXACT = dict(exact_f2=True)
MAIN_PATHS = {
    "flagship": (flagship_cfg, {}),
    "fused": (flagship_cfg, FUSED),
    "fused+cascade": (flagship_cfg, CASCADE),
    "reference order": (flagship_cfg, REF_ORDER),
    "exact F^2 cached": (flagship_cfg, EXACT),
    "exact F^2 brute": (flagship_cfg, dict(EXACT, f2_cache=False)),
    "per-walker windows": (flagship_cfg, dict(shared_windows=False)),
    "dipolar": (dipolar_cfg, {}),
    "dipolar+cascade": (dipolar_cfg, dict(cascade=True)),
    "bfloat16 flagship": (flagship_cfg, dict(dtype="bfloat16")),
    "bfloat16 fused+cascade": (flagship_cfg, dict(CASCADE, dtype="bfloat16")),
    "bfloat16 reference order": (flagship_cfg,
                                 dict(REF_ORDER, dtype="bfloat16")),
    "D=4 flagship": (flagship_cfg, dict(dim=4)),
    "D=4 fused+cascade": (flagship_cfg, dict(CASCADE, dim=4)),
    "D=4 reference order": (flagship_cfg, dict(REF_ORDER, dim=4)),
    "SP one process": (sp_cfg, {}),
}


@pytest.mark.parametrize("form", list(MAIN_PATHS))
def test_main_path_launches_and_syncs(cuda, form, W=256, nstep=3):
    """One warm-up step, then nstep steps with every kernel's launches
    exact (expected_launches; kernel A's per-level passes from the end
    moves' drawn depths); every tried move kind tried, every acceptance
    ratio in (0, 1], the energies, g(r) and S(k) finite; then one step
    under torch.cuda.set_sync_debug_mode('warn') with no host sync."""
    from pathintegralgroundstate_torch.sweep import BATCH_RAND_MAX_W

    make, over = MAIN_PATHS[form]
    cfg = make(W).replace(**over)
    sweeper = Sweeper(make_system(cfg, cuda))
    state, warm = run_block(sweeper, init_state(sweeper.system), 1)
    src = _Depths(sweeper.draws(state))
    kern = _zeroed()
    state, stats = run_block(sweeper, state, nstep, src)
    torch.cuda.synchronize()
    use_rand = sweeper.batch_rand and cfg.n_walkers <= BATCH_RAND_MAX_W
    assert _counts(kern) == expected_launches(cfg, sweeper, nstep, use_rand,
                                              src.depths)

    c = dict(zip(COUNTER_NAMES, (stats.counters + warm.counters).tolist()))
    tries = ("try_cm", "try_stag") + (
        ("try_open",) if cfg.CWorm > 0 else ()) + (
        ("try_int",) if sweeper.fused_diag else ())
    for k in tries:
        assert c[k] > 0, (k, c[k])
    if c["acc_open"] > 0:
        for k in ("try_close", "try_cm_half", "try_stag_half"):
            assert c[k] > 0, f"{k} = {c[k]} with open walkers"
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
            assert 0.0 < c[a] / c[t] <= 1.0, f"{a}/{t} = {c[a]}/{c[t]}"
    for k in ("sumE", "sumEt"):
        assert math.isfinite(float(getattr(stats, k))), k
    for k in ("gr", "sk"):
        assert bool(torch.isfinite(getattr(stats, k)).all()), k
    syncs = step_syncs(sweeper, state, src)
    assert not syncs, syncs[:3]


def test_mala_on_card_accepts_and_syncs_nothing(cuda, W=256):
    """MALA on the card (the cached exact flagship with smart_mc, W=256
    float32, after 2 warm-up steps): some step size of a scan accepts 30-80
    % of the whole-path moves over two calls, and a whole step at the one
    nearest 55 % makes no host sync."""
    from pathintegralgroundstate_torch.ops.pairwise import force_field
    from pathintegralgroundstate_torch.ops.smartmc import mala_move

    c = flagship_cfg(W).replace(exact_f2=True, smart_mc=1e-6)
    system = make_system(c, cuda)
    sweeper = Sweeper(system)
    state, _ = run_block(sweeper, init_state(system), 2)
    src = sweeper.draws(state)
    active = torch.ones(W, dtype=torch.bool, device=cuda)
    scan = {}
    for eps in (1e-7, 3e-7, 1e-6, 3e-6, 1e-5, 3e-5, 1e-4):
        p = state.paths.clone()
        f = force_field(system, p[:, 1::2])
        accs = [mala_move(system, p, active, eps, *src.mala(p.shape), f)[1]
                for _ in range(2)]
        scan[eps] = float(torch.stack(accs).double().mean())
    ok = {e: a for e, a in scan.items() if 0.3 <= a <= 0.8}
    assert ok, f"no eps accepts 30-80 %: {scan}"
    eps = min(ok, key=lambda e: abs(ok[e] - 0.55))
    # a new System builds its device constants at its first step: warm up
    sweeper = Sweeper(make_system(c.replace(smart_mc=eps), cuda))
    state, _ = run_block(sweeper, state, 1)
    syncs = step_syncs(sweeper, state, sweeper.draws(state))
    assert not syncs, syncs[:3]


# ---------------------------------------------------------------------------
# Steps on the card against the CPU, and the routes
# ---------------------------------------------------------------------------

EXACT_REPLAYS = {
    "exact F^2 flagship, cached": {},
    "exact F^2 reference order, cached": REF_ORDER,
    "exact F^2 fused, cached": FUSED,
    "exact F^2 worm + staging, cached": dict(sampling="sta"),
    # the brute form's plain forms on the CPU grow as Np^3 (every window
    # call's pair tensors over all particles); the route is the same at
    # every Np
    "exact F^2 flagship, brute": dict(f2_cache=False, Np=16),
    "exact F^2 + MALA, cached": dict(smart_mc=1e-6),
}


@pytest.mark.parametrize("label", list(EXACT_REPLAYS))
def test_exact_f2_step_on_card_matches_cpu(cuda, label):
    """One W=16 float64 step of each exact-F^2 form (the depth cut to
    Nstag=1 and at most 2 worm rounds) on the card equals the CPU's plain
    forms on the same draws (torch_card.replay_check), and kernels A and 5
    never launch: the reference routes exact F^2 away from them."""
    cfg = flagship_cfg(16).replace(exact_f2=True, **EXACT_REPLAYS[label])
    kern = _zeroed()
    torch_card.replay_check(cfg, label, cut=True)
    assert kern["pair_rows"].launches == kern["cascade"].launches == 0


@pytest.mark.parametrize("label,cfg", [
    ("dipolar N=256", dipolar_cfg(16)),
    ("dipolar N=256 + cascade", dipolar_cfg(16).replace(cascade=True)),
    ("per-walker windows", flagship_cfg(16).replace(shared_windows=False)),
])
def test_other_steps_on_card_match_cpu(cuda, label, cfg):
    """One W=16 float64 step at full depth of the 2-D dipolar gas (N=256)
    without and with cascade, and of the flagship with per-walker windows,
    on the card equals the CPU's plain forms on the same draws
    (torch_card.replay_check)."""
    torch_card.replay_check(cfg, label)


def test_exact_f2_cache_equals_brute_on_card(cuda, W=16, nstep=3):
    """The cached and the brute exact-F^2 flagship (its depth cut to
    Nstag=1, Nobdm=2) over nstep steps on the card from one start and one
    generator state, float64: paths within rtol 1e-8, atol 1e-10, counters
    equal (tests/test_exact_f2.py:100-165 on the card)."""
    from pathintegralgroundstate_torch.state import state_to_numpy

    out = []
    for cache in (True, False):
        c = flagship_cfg(W).replace(exact_f2=True, f2_cache=cache,
                                    dtype="float64", Nstag=1, Nobdm=2)
        system = make_system(c, cuda)
        state, stats = run_block(Sweeper(system), init_state(system), nstep)
        out.append((state_to_numpy(state), stats.counters.cpu().numpy()))
    (s_c, c_c), (s_b, c_b) = out
    for k in ("paths", "xend"):
        np.testing.assert_allclose(s_c[k], s_b[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_array_equal(c_c, c_b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_rows_on_gathered_windows_match_plain(cuda, dtype, W=64):
    """Per-walker windows (shared_windows=False): the gathered window is
    each walker's own beads, and kernel A on it (ib [W, B]: the bisection
    rows and the whole window, ip scalar and [W], rows and walker sums)
    matches its float64 plain form (torch_card.rows_parity)."""
    from pathintegralgroundstate_torch.ops import moves as mv

    cfg = flagship_cfg(W)
    L, M = 2 ** cfg.Nlev, cfg.M
    n_opts = (M - 1 - L) // 2 + 1
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    paths = torch_card._flagship_paths(cfg, W, dtype, cuda, seed=41)
    g = torch.Generator(device=cuda).manual_seed(42)
    ii = 2 * torch.randint(0, n_opts, (W,), generator=g, device=cuda)
    R_seg = mv._slice_beads(paths, ii, L + 1)            # [W, L+1, N, D]
    want = torch.stack([paths[w, int(ii[w]):int(ii[w]) + L + 1]
                        for w in range(W)])
    assert torch.equal(R_seg, want)
    for lo, hi, flags in ((1, L, [(False, True)]),      # bisection rows
                          (0, L, [(True, True), (False, False)])):
        R = R_seg[:, lo:hi]
        ib = mv.bead_index(system, ii, lo, hi)
        for k, ip in enumerate((7, torch.randint(
                0, cfg.Np, (W,), generator=g, device=cuda))):
            xnew, xold = torch_card._window_ip(R, ip, g)
            torch_card.rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                   False, flags, f"per-walker window rows "
                                   f"{lo}..{hi - 1}", reduce=bool(k))


def _card_step(system, start, src):
    """One step of `system` on the card from the numpy state `start` on
    the draw source src: (state, stats as numpy, launches)."""
    from pathintegralgroundstate_torch.state import (state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import stats_to_numpy, zero_stats
    kern = _zeroed()
    state, stats = Sweeper(system).step(state_from_numpy(system, start),
                                        zero_stats(system), src)
    torch.cuda.synchronize()
    return state_to_numpy(state), stats_to_numpy(stats), _counts(kern)


@pytest.mark.parametrize("case", ["flagship use_pallas=F",
                                  "fused+cascade use_pallas=F",
                                  "registered soft copy"])
def test_routes_off_launch_nothing_and_equal_the_kernels(cuda, case):
    """use_pallas=False (every route off, as the reference's pallas_ok,
    pallas_ok_wf and use_cascade_kernel) on the flagship and on the fused
    sweep with cascade, and a plug-in potential (a registered copy of the
    soft core, models/potentials.register) against the built-in soft: one
    W=16 float64 step on the card from the kernel step's state and draws
    launches no kernel and equals the kernel step (states rtol 1e-9, atol
    1e-11; statistics rtol 1e-9, atol 1e-9; counters equal)."""
    from pathintegralgroundstate_torch.models import potentials as P
    from pathintegralgroundstate_torch.state import state_to_numpy

    cfg = flagship_cfg(16).replace(dtype="float64")
    if case == "flagship use_pallas=F":
        kcfg, pcfg = cfg, cfg.replace(use_pallas=False)
    elif case == "fused+cascade use_pallas=F":
        kcfg = cfg.replace(Nstag=1, Nobdm=2, **CASCADE)
        pcfg = kcfg.replace(use_pallas=False)
    else:
        soft = P.get_potential("soft")
        P.register("soft_plugin", soft.v, soft.dvdr)
        kcfg = cfg.replace(potential="soft", Nstag=1, Nobdm=2)
        pcfg = kcfg.replace(potential="soft_plugin")
    ksys = make_system(kcfg, cuda)
    state = init_state(ksys)
    start = state_to_numpy(state)
    rec = torch_card._Recorder(Sweeper(ksys).draws(state))
    s_k, t_k, l_k = _card_step(ksys, start, rec)
    s_p, t_p, l_p = _card_step(make_system(pcfg, cuda), start,
                               torch_card._Replayer(rec.log, cuda))
    assert not any(l_p.values()) and l_k["pair_rows"], (l_p, l_k)
    for k in s_k:
        if s_k[k].dtype.kind == "f":
            np.testing.assert_allclose(s_p[k], s_k[k], rtol=1e-9, atol=1e-11,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(s_p[k], s_k[k], err_msg=k)
    np.testing.assert_array_equal(t_p["counters"], t_k["counters"])
    for k in t_k:
        if k != "counters":
            np.testing.assert_allclose(t_p[k], t_k[k], rtol=1e-9, atol=1e-9,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# cli.main on the card
# ---------------------------------------------------------------------------

def cli_run(nml, out_dir, *args):
    """cli.main on the namelist nml into out_dir, on the card (without
    PIGS_PLATFORM), in this process, with every kernel's launch count set
    to 0 just before and read just after.  Returns (launches, console)."""
    from pathintegralgroundstate_torch import cli

    kern = _zeroed()
    log = io.StringIO()
    saved = os.environ.pop("PIGS_PLATFORM", None)
    try:
        with contextlib.redirect_stdout(log):
            rc = cli.main([str(nml), "-o", str(out_dir), *args])
    finally:
        if saved is not None:
            os.environ["PIGS_PLATFORM"] = saved
    torch.cuda.synchronize()
    assert rc == 0, log.getvalue()[-2000:]
    return _counts(kern), log.getvalue()


def _namelist(tmp_path, name, cfg_or_text):
    path = tmp_path / f"{name}.in"
    path.write_text(cfg_or_text if isinstance(cfg_or_text, str)
                    else namelist_text(cfg_or_text))
    return path


def _finite_total(path, cols):
    """(rows, total of the columns cols) of a text output, which must be
    finite and non-empty."""
    x = np.loadtxt(path, ndmin=2)
    assert x.size and np.isfinite(x).all(), f"{path}: empty or not finite"
    return x.shape[0], float(x[:, cols].sum())


def test_cli_flagship_order_and_resume(cuda, tmp_path, W=64):
    """cli.main on the flagship's namelist, Nstep=3, 2 blocks: every
    kernel's launches exact and one report per block; then the resume
    probe as a process of its own (`python3 -m
    pathintegralgroundstate_torch ... --set resume=T --blocks 1`): BLOCK
    NUMBER : 3, e_vpi.out three finite rows of blocks 1, 2, 3, and no
    module of jax, jaxlib or pathintegralgroundstate_tpu imported."""
    cfg = flagship_cfg(W)
    nml, out = _namelist(tmp_path, "flagship", cfg), tmp_path / "flagship"
    nstep, nblk = 3, 2
    launches, log = cli_run(nml, out, "--set", f"Nstep={nstep}", "--blocks",
                            str(nblk))
    sweeper = Sweeper(make_system(cfg, cuda))
    assert launches == expected_launches(cfg, sweeper, nstep * nblk, True,
                                         [])
    assert log.count("BLOCK NUMBER") == nblk
    env = {k: v for k, v in os.environ.items() if k != "PIGS_PLATFORM"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "pathintegralgroundstate_torch", str(nml), "-o", str(out), "--set",
         f"Nstep={nstep}", "--set", "resume=T", "--blocks", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = [ln.rsplit("|", 1)[1].strip()
                for ln in proc.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln]
    assert "pathintegralgroundstate_torch.driver" in imported
    assert not [m for m in imported if m.split(".")[0] in (
        "jax", "jaxlib", "pathintegralgroundstate_tpu")]
    assert "BLOCK NUMBER : 3" in proc.stdout
    e = np.loadtxt(out / "e_vpi.out", ndmin=2)
    assert e.shape == (3, 4) and np.isfinite(e).all()
    assert np.array_equal(e[:, 0], [1, 2, 3])


def test_cli_reference_order_runs_the_dense_gate(cuda, tmp_path, W=64):
    """cli.main in the reference order (bis_monoshot=F,
    bis_end_random_depth=T), Nstep=2, 1 block: the dense delta_action
    (kernels 3 and 4 in one launch) at every end gate, 2 Nstag Np per
    step, no separate kernel-4 launch, kernel B twice per step, no kernel
    5, and kernel A at least Nlev + 4 passes per particle visit."""
    cfg = flagship_cfg(W)
    nstep = 2
    launches, _ = cli_run(_namelist(tmp_path, "ref", cfg), tmp_path / "ref",
                          "--set", "bis_monoshot=F", "--set",
                          "bis_end_random_depth=T", "--set", f"Nstep={nstep}",
                          "--blocks", "1")
    visits = cfg.Nstag * cfg.Np * nstep
    assert launches["pair_delta"] == 2 * visits and not launches["pair_u"]
    assert launches["pair_pot"] == 2 * nstep and not launches["cascade"]
    assert launches["pair_rows"] >= visits * (cfg.Nlev + 4), launches


def test_cli_exact_f2_with_mala(cuda, tmp_path, W=64):
    """cli.main on the flagship with exact_f2 = T and smart_mc > 0, 2
    blocks of Nstep=2: a MALA line per block; kernels A, 3, 4 and 5 never
    launch, kernel B twice per step (ThermEnergy), the fold kernel once per
    window call of the cache (_fold_calls; the MALA move folds nothing) and
    each glue kernel once per monoshot move (a head, a tail and an interior
    move per particle visit)."""
    cfg = flagship_cfg(W).replace(exact_f2=True, smart_mc=1e-6)
    nstep, nblk = 2, 2
    launches, log = cli_run(_namelist(tmp_path, "exact", cfg),
                            tmp_path / "exact", "--set", f"Nstep={nstep}",
                            "--blocks", str(nblk))
    glue = 3 * cfg.Nstag * cfg.Np * nstep * nblk
    assert launches == dict(pair_rows=0, pair_pot=2 * nstep * nblk,
                            cascade=0, pair_delta=0, pair_u=0,
                            bis_propose=glue, bis_accept=glue,
                            pair_fold=_fold_calls(cfg, nstep * nblk))
    assert log.count("> MALA movements") == nblk


@pytest.mark.parametrize("name", ["oscillator", "oscillator exact F2 MALA",
                                  "trap worm"])
def test_cli_trap_runs_launch_nothing(cuda, tmp_path, name):
    """The trap through cli.main on the card, on the plain forms (every
    kernel's launch count stays 0, as the reference routes the trap): the
    1-D oscillator with its exact trial wavefunction (torch_card.HO_IN, 2
    blocks of 10 steps) prints <E> = 0.5 +/- 0 in each block with E within
    1e-12 of 0.5, also with exact F^2 and MALA (smart_mc=0.05, a MALA line
    per block); the trapped worm flagship (flagship.trap_worm_cfg, W=256
    float64, 3 blocks of 20 steps: the OBDM flushes its first super-block
    after the third) has E/N within 1e-12 of 1.0 in each block and finite,
    non-empty nr_vpi.out and density_vpi.out with a positive total."""
    text, E, nblk, args = {
        "oscillator": (torch_card.HO_IN, 0.5, 2, ()),
        "oscillator exact F2 MALA": (torch_card.HO_IN, 0.5, 2, (
            "--set", "exact_f2=T", "--set", "smart_mc=0.05")),
        "trap worm": (namelist_text(trap_worm_cfg(3)), 1.0, 3, ())}[name]
    out = tmp_path / "out"
    launches, log = cli_run(_namelist(tmp_path, "trap", text), out, *args)
    assert not any(launches.values()), launches
    e = np.loadtxt(out / "e_vpi.out", ndmin=2)
    assert e.shape[0] == nblk and float(np.abs(e[:, 1] - E).max()) <= 1e-12
    if name.startswith("oscillator"):
        assert log.count("<E>  =  0.5 +/- 0\n") == 2
    if args:
        assert log.count("> MALA movements") == nblk
    if name == "trap worm":
        for f, cols in (("nr_vpi.out", slice(1, None, 2)),
                        ("density_vpi.out", 2)):
            assert _finite_total(out / f, cols)[1] > 0.0, f


def test_refrng_goldens_on_card(cuda):
    """The three RefRNG goldens (tests/golden/refrng_replay*.json) replayed
    through utils/replay on the card in float64, every Delta-S the port's
    delta_action with both tables: paths within atol 1e-12
    (tests/test_refrng.py's), the worm events equal, and no pair kernel
    launched (the tables route every pair kernel away)."""
    from pathintegralgroundstate_torch.utils import replay

    kern = _zeroed()
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
        with open(os.path.join(REPO, "tests", "golden", name)) as f:
            gold = json.load(f)
        want = np.array([[[float.fromhex(v) for v in row] for row in sl]
                         for sl in gold["paths_hex"]])
        out = fn(seed=gold["seed"], device="cuda",
                 **{k: gold[k] for k in keys})
        got = out[0] if isinstance(out, tuple) else out
        assert float(np.abs(got - want).max()) <= 1e-12, name
        if isinstance(out, tuple):
            assert [list(e) for e in out[2]] == [list(e)
                                                 for e in gold["events"]]
    launches = _counts(kern)
    assert not any(launches[k] for k in torch_card.PAIR_KERNELS), launches


def test_cli_table_modes(cuda, tmp_path, W=64):
    """Table mode through cli.main on the card: the flagship's He-4 at
    Np=16 with v_table = wf_table = T (BASELINE #2), Nstep=2, 2 blocks:
    every pair kernel's launch count 0, the glue kernels one launch each
    per monoshot move, e_vpi.out two finite rows, jastrow.out and
    potential.out written; v_table alone in the reference order
    (bis_monoshot=F, bis_end_random_depth=T), Nstep=2, 1 block: only
    kernel 4 launches, once per end gate (2 Nstag Np per step), the dense
    action's u half, while its potential half runs the plain form."""
    he16 = flagship_cfg(W).replace(Np=16, v_table=True, wf_table=True)
    out = tmp_path / "tables"
    launches, _ = cli_run(_namelist(tmp_path, "tables", he16), out, "--set",
                          "Nstep=2", "--blocks", "2")
    assert not any(launches[k] for k in torch_card.PAIR_KERNELS), launches
    assert launches["bis_propose"] == launches["bis_accept"] > 0, launches
    assert _finite_total(out / "e_vpi.out", 1)[0] == 2
    for f in ("jastrow.out", "potential.out"):
        assert os.path.getsize(out / f), f
    vt = he16.replace(wf_table=False)
    nstep = 2
    launches, _ = cli_run(_namelist(tmp_path, "vtable", vt),
                          tmp_path / "vtable", "--set", "bis_monoshot=F",
                          "--set", "bis_end_random_depth=T", "--set",
                          f"Nstep={nstep}", "--blocks", "1")
    gates = 2 * vt.Nstag * vt.Np * nstep
    assert launches == {"pair_rows": 0, "pair_pot": 0, "cascade": 0,
                        "pair_delta": 0, "pair_u": gates, "bis_propose": 0,
                        "bis_accept": 0, "pair_fold": 0}


def test_cli_dipolar_gas_has_its_correlation_hole(cuda, tmp_path, W=256):
    """BASELINE #5 (flagship.dipolar_cfg, the 2-D dipolar Bose gas, N=256
    float64) through cli.main: Nstep=5, --burnin 2, 2 blocks
    (tools/dipolar2d.py's checks): every kernel's launches exact, E/N > 0
    and Et/N > 0 in each block, and the correlation hole of g(r), g[0] <
    0.05 and g[1] < 0.5."""
    dip = dipolar_cfg(W)
    out = tmp_path / "dipolar"
    nstep, nblk, burn = 5, 2, 2
    launches, _ = cli_run(_namelist(tmp_path, "dipolar", dip), out, "--set",
                          f"Nstep={nstep}", "--burnin", str(burn),
                          "--blocks", str(nblk))
    assert launches == expected_launches(
        dip, Sweeper(make_system(dip, cuda)), nstep * (nblk + burn), True, [])
    e = np.loadtxt(out / "e_vpi.out", ndmin=2)
    et = np.loadtxt(out / "et_vpi.out", ndmin=2)
    gr = np.loadtxt(out / "gr_vpi.out", ndmin=2)[:, 1]
    assert e.shape[0] == nblk and (e[:, 1] > 0).all() and (et[:, 1] > 0).all()
    assert gr[0] < 0.05 and gr[1] < 0.5, gr[:5]


def test_cli_ideal_bose_gas_has_zero_energy(cuda, tmp_path, W=64):
    """The ideal Bose gas under PBC (the flagship's box and order with
    potential = jastrow = 'none', float32) through cli.main, Nstep=3, 2
    blocks: <E> = 0 +/- 0 exactly in every block (E, K and V exactly 0),
    and the kernels launched as on the Aziz flagship (the reference keeps
    this configuration on its kernels, which sum zero pair terms)."""
    ideal = flagship_cfg(W).replace(potential="none", jastrow="none")
    out = tmp_path / "ideal"
    nstep, nblk = 3, 2
    launches, log = cli_run(_namelist(tmp_path, "ideal", ideal), out,
                            "--set", f"Nstep={nstep}", "--blocks", str(nblk))
    assert launches == expected_launches(
        ideal, Sweeper(make_system(ideal, cuda)), nstep * nblk, True, [])
    e = np.loadtxt(out / "e_vpi.out", ndmin=2)
    assert e.shape[0] == nblk and not np.any(e[:, 1:] != 0.0)
    assert log.count("<E>  =  0 +/- 0\n") == nblk


# ---------------------------------------------------------------------------
# Ranks on the one card under torchrun
# ---------------------------------------------------------------------------

def _ranks(tmp_path, n, argv, label, timeout=600):
    """torchrun of n ranks on the card; fails with every rank's output
    unless torchrun exits 0.  Returns the ranks' stdout."""
    rc, so, se, err = torchrun(n, argv, tmp_path / f"logs_{label}",
                               timeout=timeout)
    assert rc == 0, "\n".join([err[-2000:]] + [
        f"rank {r}: {so[r][-1500:]}\n{se[r][-3000:]}" for r in range(n)])
    return so


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.mark.parametrize("dtype,W,nstep", [("float32", 256, 3),
                                           ("float64", 64, 2)])
def test_dp_ranks_on_one_card_match_unsharded(cuda, tmp_path, dtype, W,
                                              nstep):
    """dp walker sharding on the card: 2 ranks (gloo: they share the one
    card) each run one Driver block of the flagship with mesh_walkers=2;
    this process runs the same block unsharded.  Each block's counters and
    perm_hist equal; the block averages within rtol 1e-5 in float32 (sums
    over walkers in another order and g(r)'s atomics; kernel A's lane
    width is pinned from the global W, so each walker's sums are the
    unsharded run's) and 1e-10 in float64; the gathered paths within 1e-4
    and 1e-10."""
    from pathintegralgroundstate_torch.driver import Driver

    cfg = flagship_cfg(W).replace(mesh_walkers=2, Nstep=nstep, dtype=dtype)
    res = tmp_path / "res"
    res.mkdir()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(
        cfg=dataclasses.asdict(cfg), out=str(tmp_path / "mesh"), blocks=1,
        device=None)))
    _ranks(tmp_path, 2, [WORKER, "run", str(spec), str(res)], "dp")
    drv = Driver(cfg.replace(mesh_walkers=1), out_dir=str(tmp_path / "one"),
                 verbose=False)
    acc = drv.run(1)
    f32 = dtype == "float32"
    rtol, atol, ptol = (1e-5, 1e-6, 1e-4) if f32 else (1e-10, 1e-12, 1e-10)
    assert ([[m[n] for n in COUNTER_NAMES] for m in _metrics(tmp_path
                                                             / "mesh")]
            == [[m[n] for n in COUNTER_NAMES]
                for m in _metrics(tmp_path / "one")])
    for r in range(2):
        z = np.load(res / f"rank{r}.npz")
        np.testing.assert_array_equal(z["acc_perm_hist"], acc["perm_hist"])
        for k in ("AvE", "AvEt", "AvK", "AvV", "diag_bl", "AvGr", "AvSk",
                  "AvNr"):
            np.testing.assert_allclose(z[f"acc_{k}"], np.asarray(acc[k]),
                                       rtol=rtol, atol=atol, err_msg=k)
        d = float(np.abs(z["paths"] - drv.state.paths.cpu().numpy()).max())
        assert d <= ptol, d


def test_dry_run_dp2_tp2_on_card(cuda, tmp_path):
    """The dry run (parallel/dryrun.py) at dp 2 x tp 2 over 4 ranks on the
    card: world 4, every form's mesh [2, 2], and rank 0 alone prints."""
    so = _ranks(tmp_path, 4, ["-m", "pathintegralgroundstate_torch.parallel"
                              ".dryrun"], "dryrun", timeout=300)
    rep = json.loads(so[0].strip().splitlines()[-1])
    assert rep["world"] == 4
    assert all(v["mesh"] == [2, 2] for v in rep["dryrun"].values()), rep
    assert not any(so[1:])


def test_cli_dipolar_dp2_tp2_matches_unsharded(cuda, tmp_path, W=64):
    """BASELINE #5 (flagship.dipolar_cfg, N=256 float64) on the mesh the
    reference ran it on: dp 2 x tp 2 over 4 ranks (gloo, one card) through
    the CLI as torchrun starts it (2 blocks of 2 steps), against the
    unsharded CLI run of the same seed in this process.  Under tp every
    pair sum takes the plain forms, the unsharded run the kernels, so the
    two differ by rounding only: E/N, Et/N, g(r) and S(k) within rtol
    1e-9, the counters equal, gloo over a [2, 2] mesh; rank 0 alone prints
    and writes (the directory holds exactly the Driver's files, e_vpi.out
    two rows)."""
    cfg = dipolar_cfg(W, 2).replace(Nstep=2)
    nml = _namelist(tmp_path, "dipolar", cfg)
    sh, one = tmp_path / "dp2tp2", tmp_path / "one"
    so = _ranks(tmp_path, 4, ["-m", "pathintegralgroundstate_torch",
                              str(nml), "-o", str(sh), "--set",
                              "mesh_walkers=2", "--set", "mesh_pairs=2"],
                "dipolar", timeout=900)
    assert "BLOCK NUMBER : 2" in so[0] and not any(so[1:])
    cli_run(nml, one)
    assert sorted(os.listdir(sh)) == sorted(os.listdir(one))
    for fn in ("e_vpi.out", "et_vpi.out", "gr_vpi.out", "sk_vpi.out"):
        a, b = np.loadtxt(sh / fn), np.loadtxt(one / fn)
        assert fn not in ("e_vpi.out", "et_vpi.out") or a.shape[0] == 2
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12, err_msg=fn)
    for a, b in zip(_metrics(sh), _metrics(one)):
        assert [a[n] for n in COUNTER_NAMES] == [b[n] for n in COUNTER_NAMES]
        assert a["backend"] == "gloo" and a["mesh"] == [2, 2]


def test_sp_ranks_on_one_card(cuda, tmp_path, W=64, nstep=3):
    """The SP bead sharding (mesh_beads=4) over 4 ranks on the one card
    (gloo; torch_mesh_worker.card_sp): at W=16 float64, M=129, 3 sharded
    sweeps equal sp_staging_sweep_ref on one process bit for bit (kernel A
    in both: one launch per call sharded, four unsharded), the ring's halo
    equals the local copy, and the card equals the CPU's plain forms; the
    He-4 long-M path (sp_cfg, M=257, float32) on every rank: launches
    exact, counters and E/N equal across ranks, no host sync outside the
    exchanges, kernels A and B at its shapes within their plain forms'
    tolerances."""
    full = sp_cfg(W)
    small = full.replace(Nb=64, Lstag=16, n_walkers=16, dtype="float64")
    res = tmp_path / "res"
    res.mkdir()
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps(dict(small=dataclasses.asdict(small),
                                    full=dataclasses.asdict(full), calls=3,
                                    nstep=nstep)))
    _ranks(tmp_path, SP, [WORKER, "card_sp", str(spec), str(res)], "sp")
    z = [json.loads((res / f"rank{r}.json").read_text()) for r in range(SP)]
    # a rank's sweep: the staging sampler on its own shard's window
    rank_sweep = types.SimpleNamespace(fused_diag=False, sp_sharded=True,
                                       sp=SP)
    want = expected_launches(full, rank_sweep, nstep, False, [])
    for zr in z:
        assert zr["halo_equal"] and zr["accepts_equal"] and zr["paths_equal"]
        assert zr["small_launches"] == [3, 3 * SP] and sum(
            zr["small_accepted"])
        assert zr["launches"] == want, zr["launches"]
        assert not zr["syncs"], zr["syncs"][:3]
        assert zr["counters"] == z[0]["counters"] and zr["E"] == z[0]["E"]


def test_cli_sp_ranks_match_one_process(cuda, tmp_path, W=64):
    """The CLI with --set mesh_beads=4 under torchrun (4 ranks on the one
    card, 2 blocks of 2 steps): rank 0 alone prints both blocks, each
    block's E/N and Et/N equal the same blocks on one process within
    float32 rtol 1e-5, over the sp ring of gloo."""
    cfg = sp_cfg(W).replace(Nstep=2, Nblock=2)
    nml = _namelist(tmp_path, "sp", cfg.replace(mesh_beads=1))
    out = tmp_path / "cli"
    so = _ranks(tmp_path, SP, ["-m", "pathintegralgroundstate_torch",
                               str(nml), "-o", str(out), "--set",
                               f"mesh_beads={SP}"], "spcli")
    assert "BLOCK NUMBER : 2" in so[0] and not any(so[1:])
    sweeper = Sweeper(make_system(cfg, cuda))
    state = init_state(sweeper.system)
    for rec in _metrics(out):
        state, st = run_block(sweeper, state, cfg.Nstep)
        for k in ("E", "Et"):
            want = float(getattr(st, f"sum{k}") / st.n_diag) / cfg.Np
            assert abs(rec[f"Av{k}"] - want) <= 1e-5 * abs(want), (rec, k)
        assert rec.get("sp") == SP and rec["backend"] == "gloo"
