"""One rank of a sharded run of the port, for the multi-process tests
(tests/test_torch_parallel.py, tests/test_torch_multihost.py on the CPU,
tests/test_torch_cuda_runs.py on the card), and torchrun(), which starts
the ranks.

    python tests/torch_mesh_worker.py MODE SPEC.json RESULT_DIR

started by torchrun, one process per rank.  SPEC
holds the port's SimConfig fields ("cfg"), the output directory ("out"),
and the blocks to run ("blocks").  Modes:

  run     Driver(distributed=True).run(blocks) on SPEC["device"] (the
          CPU by default; null: the rank's card); each rank saves its
          accumulators and its gathered final state to
          RESULT_DIR/rank<R>.npz;
  seam    the tp partner seam: with a tp=world System, every plain pair
          form against the same form without a mesh, on seeded inputs;
          asserts rtol 1e-11 and saves the largest relative difference;
  errors  the mesh's ValueErrors (n_walkers, Np not divisible), each
          rank saving the messages;
  replay  run_block of "blocks" steps under the cfg's dp x tp mesh from
          the global state in SPEC["start"] (an npz), on the draws logged
          for all walkers in SPEC["draws"] (a torch.save'd list of (site,
          result)), each rank keeping its rows as DeviceDraws._keep does;
          each rank saves the gathered state and the block statistics;
  sp      the SP bead sharding over an sp ring of world ranks (the
          counterparts of tests/test_beadshard.py): the ring's halo
          against the rank's own copy; SPEC["calls"] sharded sweeps of
          particle SPEC["ip"] from the paths in SPEC["start"] (an npz) on
          DeviceDraws seeded with SPEC["draw_seed"]; SPEC["bridge"] sweeps
          of the free particle (SPEC["free_cfg"]); then a Driver run of
          SPEC["cfg_run"] over "blocks" blocks.  Each rank saves all of it.
  card_sp the same ring on one card (card_sp below).
"""

import glob
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import torch

torch.set_num_threads(1)

from pathintegralgroundstate_torch.config import SimConfig  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.parallel.mesh import (  # noqa: E402
    gather_state, init_from_env, make_mesh)
from pathintegralgroundstate_torch.utils.draws import DeviceDraws  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")


def torchrun(n, argv, logs, env=ENV, timeout=TIMEOUT):
    """`torchrun --standalone --nproc-per-node n argv...` (argv: a script
    and its arguments, or -m and a module), each rank's stdout and stderr
    redirected into the log directory `logs`.  Returns (torchrun's exit
    code, [stdout by rank], [stderr by rank], torchrun's own stderr).  At
    the timeout torchrun is sent SIGTERM, on which it stops its ranks."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", "--redirects=3", f"--log-dir={logs}"]
    proc = subprocess.Popen(cmd + list(argv), cwd=REPO, env=env, text=True,
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
        (path,) = glob.glob(os.path.join(str(logs), "*", "attempt_0",
                                         str(rank), f"{stream}.log"))
        with open(path) as fh:
            return fh.read()

    return (proc.returncode, [read(r, "stdout") for r in range(n)],
            [read(r, "stderr") for r in range(n)], err)


def _cfg(d) -> SimConfig:
    return SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


def run(spec, res, rank):
    drv = Driver(_cfg(spec["cfg"]).replace(distributed=True),
                 out_dir=spec["out"].replace("{rank}", str(rank)),
                 device=spec.get("device", "cpu"), verbose=False)
    acc = drv.run(spec["blocks"])
    st = gather_state(drv.system, drv.state)
    np.savez(os.path.join(res, f"rank{rank}.npz"),
             paths=st.paths.cpu().numpy(), iworm=st.iworm.cpu().numpy(),
             isopen=st.isopen.cpu().numpy(), backend=drv.backend,
             collectives=drv.mesh.collectives if drv.mesh else 0,
             **{f"acc_{k}": np.asarray(v) for k, v in acc.items()})


def seam(spec, res, rank):
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops import pairwise as P
    from pathintegralgroundstate_torch.system import make_system
    init_from_env("cpu")
    world = torch.distributed.get_world_size()
    cfg = _cfg(spec["cfg"])
    mesh = make_mesh(1, world)
    tp, plain = (make_system(cfg, "cpu", mesh=mesh),
                 make_system(cfg, "cpu"))
    assert tp.tp is mesh and plain.tp is None
    g = np.random.default_rng(7)
    W, B, N, D = 4, 5, cfg.Np, cfg.dim
    scale = float(plain.L[0]) if plain.pbc else 2.0
    R = torch.from_numpy(scale * (g.random((W, B, N, D)) - 0.5))
    tab = P.chin_table(plain)
    ib = torch.arange(1, B + 1)
    worst = 0.0
    for ip in (3, torch.from_numpy(g.integers(0, N, W)),
               torch.from_numpy(g.integers(0, N, (W, B)))):
        if isinstance(ip, int):
            xold = R[:, :, ip]
        elif ip.dim() == 1:
            xold = R[torch.arange(W), :, ip]
        else:
            xold = torch.gather(R, 2, ip[:, :, None, None].expand(
                W, B, 1, D))[:, :, 0]
        xnew = xold + torch.from_numpy(0.1 * g.normal(size=xold.shape))
        fold = P.force_field(plain, R)
        calls = [
            lambda s: K.pair_terms_ref(s, R, xnew, xold, ip),
            lambda s: K.pair_terms_ref(s, R, xnew, xold, ip, rev=True),
            lambda s: K.pair_rows_ref(s, R, xnew, xold, ip, tab, ib),
            lambda s: K.pair_delta_ref(s, R, xnew, xold, ip),
            lambda s: K.pair_delta_ref(s, R, xnew, xold, ip, True, tab, ib,
                                       1e-3),
            lambda s: K.pair_u_ref(s, R, xnew, xold, ip),
            lambda s: P.delta_pot_cached(s, R, xnew, xold, ip, fold),
            lambda s: P._fold_rows(s, R, xnew, xold, ip, ib, fold[:, 1::2],
                                   (1, 2), True),
            lambda s: K.pair_pot_ref(s, R, True),
            lambda s: (P.force_field(s, R),),
        ]
        for i, f in enumerate(calls):
            for a, b in zip(f(tp), f(plain)):
                if a is None:
                    assert b is None
                    continue
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-11,
                                           atol=1e-11, err_msg=f"call {i}")
                d = (a - b).abs().max() / b.abs().max().clamp(min=1e-300)
                worst = max(worst, float(d))
    np.savez(os.path.join(res, f"rank{rank}.npz"), worst=worst,
             collectives=mesh.collectives)


def errors(spec, res, rank):
    init_from_env("cpu")
    msgs = []
    for kw in ({"n_walkers": 7, "mesh_walkers": 2},
               {"Np": 9, "mesh_pairs": 2}):
        try:
            Driver(_cfg(spec["cfg"]).replace(**kw), out_dir=spec["out"],
                   device="cpu", verbose=False)
        except ValueError as e:
            msgs.append(str(e))
    with open(os.path.join(res, f"rank{rank}.json"), "w") as fh:
        json.dump(msgs, fh)


# the draw sites' results whose walker axis is not the first:
# (site, position in the result)
AXIS1 = {("worm", 3), ("swap", 3), ("regrow_half", 2), ("end_stagings", 2),
         ("staging_half", 1)}


class KeptDraws:
    """A draw source replaying a log of draws taken for all dp * W walkers,
    each call returning this rank's rows of the logged result (DeviceDraws'
    own _keep: end_stagings' head and tail walkers are two blocks)."""

    def __init__(self, log, mesh):
        self.log, self.dp, self.dp_rank = list(log), mesh.dp, mesh.dp_rank

    def _kept(self, site, x, i=0):
        if isinstance(x, torch.Tensor):
            return DeviceDraws._keep(self, x, int((site, i) in AXIS1),
                                     2 if site == "end_stagings" else 1)
        if isinstance(x, tuple):
            inner = "bisect" if site == "end_bisect" else site
            items = [self._kept(inner, y, j) for j, y in enumerate(x)]
            return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
        return x                    # a host int shared by every walker, None

    def __getattr__(self, site):
        def call(*args, **kw):
            name, out = self.log.pop(0)
            assert name == site, (name, site)
            return self._kept(site, out)
        return call


def replay(spec, res, rank):
    from pathintegralgroundstate_torch.state import (state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import (Sweeper, run_block,
                                                     stats_to_numpy)
    from pathintegralgroundstate_torch.system import make_system
    init_from_env("cpu")
    cfg = _cfg(spec["cfg"])
    mesh = make_mesh(cfg.mesh_walkers, cfg.mesh_pairs)
    system = make_system(cfg, "cpu", mesh=mesh)
    state = state_from_numpy(system, dict(np.load(spec["start"])))
    src = KeptDraws(torch.load(spec["draws"], weights_only=False), mesh)
    state, stats = run_block(Sweeper(system), state, spec["blocks"], src)
    assert not src.log, f"{len(src.log)} logged draws left over"
    st = state_to_numpy(gather_state(system, state))
    np.savez(os.path.join(res, f"rank{rank}.npz"),
             collectives=mesh.collectives,
             **{f"state_{k}": v for k, v in st.items()},
             **{f"stats_{k}": v for k, v in stats_to_numpy(stats).items()})


def _draw_source(system, seed):
    gen = torch.Generator(device=system.device)
    gen.manual_seed(seed)
    host = torch.Generator()
    host.manual_seed(seed + 1)
    return DeviceDraws(system, gen, host)


def sp(spec, res, rank):
    from pathintegralgroundstate_torch.parallel import beadshard as bs
    from pathintegralgroundstate_torch.system import make_system
    init_from_env("cpu")
    S = torch.distributed.get_world_size()
    mesh = make_mesh(1, 1, S)
    out = {}
    # the sharded sweep from the given paths
    cfg = _cfg(spec["cfg"])
    system = make_system(cfg, "cpu", mesh=mesh)
    paths = torch.from_numpy(np.load(spec["start"])["paths"])
    W, M = paths.shape[:2]
    Mloc, L = (M - 1) // S, cfg.Lstag
    k = mesh.sp_rank
    halo = mesh.ring_next(paths[:, k * Mloc])
    out["halo_equal"] = bool(torch.equal(halo,
                                         paths[:, (k + 1) % S * Mloc]))
    src = _draw_source(system, spec["draw_seed"])
    accs = []
    for it in range(spec["calls"]):
        accs.append(bs.sp_staging_sweep(
            system, paths, spec["ip"], L,
            src.sp_staging(it, W, S, bs.n_starts(Mloc, L), L)).numpy())
    out.update(paths=paths.numpy(), acc=np.stack(accs),
               sweep_collectives=mesh.collectives)
    # the free particle's bridge statistics through the halo windows
    free = make_system(_cfg(spec["free_cfg"]), "cpu", mesh=mesh)
    fpaths = torch.from_numpy(np.load(spec["start"])["free"])
    src = _draw_source(free, spec["draw_seed"] + 7)
    all_acc = True
    for it in range(spec["bridge"]):
        acc = bs.sp_staging_sweep(free, fpaths, 0, L, src.sp_staging(
            it, W, S, bs.n_starts(Mloc, L), L))
        all_acc = all_acc and bool(acc.all())
    out.update(free=fpaths.numpy(), free_all_accepted=all_acc)
    # the production Driver over the sp ring
    drv = Driver(_cfg(spec["cfg_run"]).replace(distributed=True),
                 out_dir=spec["out"], device="cpu", verbose=False)
    acc = drv.run(spec["blocks"])
    out.update(run_paths=drv.state.paths.numpy(),
               run_collectives=drv.mesh.collectives,
               **{f"acc_{k}": np.asarray(v) for k, v in acc.items()})
    np.savez(os.path.join(res, f"rank{rank}.npz"), **out)


def step_syncs(sweeper, state, src):
    """The host syncs of one step (run_block) on the card, as the messages
    of torch.cuda.set_sync_debug_mode('warn')."""
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
    return [str(w.message) for w in caught
            if "synchroniz" in str(w.message)]


def _sp_kernels_match_plain(system, paths, k):
    """Kernels A and B at the SP path's shapes, float32 against their
    float64 plain forms on the same inputs (torch_card.rows_parity,
    pot_check): shard k's two kinds of window as beadshard.shard_window
    builds them, the view of the shard at local start 0 and the last
    start's copy joined with the halo (the next shard's first bead; bead
    M-1 on the last shard), each with its global bead indices and
    segment_regrow's flags (need_wf=False, need_f2=True), per row and
    summed; and for k < 2 ThermEnergy's view k of the paths
    (paths[:, k:M-1:2]) without and with force."""
    import torch_card
    from pathintegralgroundstate_torch.parallel.beadshard import \
        shard_window
    from pathintegralgroundstate_torch.system import make_system

    cfg = system.cfg
    sys64 = make_system(cfg, paths.device, torch.float64)
    M, L, N = paths.shape[1], cfg.Lstag, cfg.Np
    Mloc = (M - 1) // cfg.mesh_beads
    lo = k * Mloc
    paths_l, halo = paths[:, lo:lo + Mloc], paths[:, lo + Mloc]
    g = torch.Generator(device=paths.device).manual_seed(40 + k)
    ip = (7 * k + 3) % N
    for ii in (0, Mloc - L):
        R = shard_window(paths_l, halo, ii, L)[:, :L]
        assert (R.data_ptr() == paths_l[:, ii:].data_ptr()) == (
            ii + L < Mloc), f"shard {k} ii={ii}: not the window expected"
        ib = torch.arange(lo + ii, lo + ii + L, device=paths.device)
        xnew, xold = torch_card._window_ip(R, ip, g)
        for reduce in (False, True):
            torch_card.rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                   False, [(False, True)],
                                   f"sp shard {k} ii={ii}", reduce=reduce)
    if k < 2:
        torch_card.pot_check(system, sys64, paths[:, k:M - 1:2],
                             f"sp ThermEnergy view {k}")


def card_sp(spec, res, rank):
    """The SP bead sharding over the ranks' sp ring on one card (gloo):
    (1) SPEC["calls"] sharded sweeps of SPEC["small"] against
    sp_staging_sweep_ref on this process, kernel A in both; on rank 0 the
    same sweeps on the CPU's plain forms, within the replay tolerance; (2)
    the path SPEC["full"]: one warm-up step, then SPEC["nstep"] steps'
    launches and counters, one step's host syncs outside the mesh's
    exchanges, and kernels A and B at its shapes against their plain
    forms.  Each rank saves RESULT_DIR/rank<R>.json."""
    import torch_card
    from pathintegralgroundstate_torch.parallel import beadshard as bs
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    from pathintegralgroundstate_torch.system import make_system
    backend = init_from_env()
    S = torch.distributed.get_world_size()
    mesh = make_mesh(1, 1, S)
    cuda = torch.device("cuda")
    kern = torch_card._kernel_fns()
    out = dict(backend=backend)

    cfg = _cfg(spec["small"])
    ssys, rsys = make_system(cfg, cuda, mesh=mesh), make_system(cfg, cuda)
    paths = init_state(ssys).paths
    start, ref = paths.clone(), paths.clone()
    W, M = paths.shape[:2]
    Mloc, L = (M - 1) // S, cfg.Lstag
    src_s, src_r = _draw_source(ssys, 5), _draw_source(rsys, 5)
    halo = mesh.ring_next(paths[:, mesh.sp_rank * Mloc])
    out["halo_equal"] = bool(torch.equal(
        halo, paths[:, (mesh.sp_rank + 1) % S * Mloc]))
    n_a, logged, accs, same = [0, 0], [], [], True
    for it in range(spec["calls"]):
        ip = (7 * it + 3) % cfg.Np
        ds = src_s.sp_staging(it, W, S, bs.n_starts(Mloc, L), L)
        dr = src_r.sp_staging(it, W, S, bs.n_starts(Mloc, L), L)
        logged.append((ip, dr))
        a0 = kern["pair_rows"].launches
        acc_s = bs.sp_staging_sweep(ssys, paths, ip, L, ds)
        a1 = kern["pair_rows"].launches
        acc_r = bs.sp_staging_sweep_ref(rsys, ref, ip, S, L, dr)
        n_a[0] += a1 - a0
        n_a[1] += kern["pair_rows"].launches - a1
        same = same and bool(torch.equal(acc_s, acc_r))
        accs.append(int(acc_s.sum()))
    out.update(accepts_equal=same, paths_equal=bool(torch.equal(paths, ref)),
               small_launches=n_a, small_accepted=accs)
    if rank == 0:
        csys, cpaths = make_system(cfg, "cpu"), start.cpu()
        for ip, dr in logged:
            bs.sp_staging_sweep_ref(csys, cpaths, ip, S, L, [
                (ii, g.cpu(), u.cpu()) for ii, g, u in dr])
        np.testing.assert_allclose(paths.cpu().numpy(), cpaths.numpy(),
                                   rtol=1e-9, atol=1e-11,
                                   err_msg="sp: card vs CPU plain forms")
    torch.distributed.barrier()

    cfg = _cfg(spec["full"])
    system = make_system(cfg, cuda, mesh=mesh)
    sweeper = Sweeper(system)
    state, warm = run_block(sweeper, init_state(system), 1)
    for fn in kern.values():
        fn.launches = 0
    state, stats = run_block(sweeper, state, spec["nstep"])
    torch.cuda.synchronize()
    out.update(launches={k: fn.launches for k, fn in kern.items()},
               counters=(stats.counters + warm.counters).tolist(),
               E=float(stats.sumE / stats.n_diag) / cfg.Np)

    # the exchanges run outside the sync check: a host sync there is the
    # exchange's own
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
    try:
        out["syncs"] = step_syncs(sweeper, state, None)
    finally:
        del mesh.ring_next, mesh.all_reduce
    _sp_kernels_match_plain(system, state.paths, mesh.sp_rank)
    with open(os.path.join(res, f"rank{rank}.json"), "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    mode, spec_path, res = sys.argv[1:4]
    with open(spec_path) as fh:
        spec = json.load(fh)
    {"run": run, "seam": seam, "errors": errors, "replay": replay,
     "sp": sp, "card_sp": card_sp}[mode](
        spec, res, int(os.environ["RANK"]))
    # leave the group together: a rank that exits while a peer still
    # holds the connection can abort in gloo's teardown
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
