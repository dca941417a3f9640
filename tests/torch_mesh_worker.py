"""One rank of a sharded run of the port, for the multi-process CPU tests
(tests/test_torch_parallel.py, tests/test_torch_multihost.py).

    python tests/torch_mesh_worker.py MODE SPEC.json RESULT_DIR

started by torchrun, one process per rank.  SPEC
holds the port's SimConfig fields ("cfg"), the output directory ("out"),
and the blocks to run ("blocks").  Modes:

  run     Driver(distributed=True).run(blocks) on the CPU; each rank saves
          its accumulators and its gathered final state to
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
"""

import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)

from pathintegralgroundstate_torch.config import SimConfig  # noqa: E402
from pathintegralgroundstate_torch.driver import Driver  # noqa: E402
from pathintegralgroundstate_torch.parallel.mesh import (  # noqa: E402
    gather_state, init_from_env, make_mesh)
from pathintegralgroundstate_torch.utils.draws import DeviceDraws  # noqa: E402


def _cfg(d) -> SimConfig:
    return SimConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in d.items()})


def run(spec, res, rank):
    drv = Driver(_cfg(spec["cfg"]).replace(distributed=True),
                 out_dir=spec["out"].replace("{rank}", str(rank)),
                 device="cpu", verbose=False)
    acc = drv.run(spec["blocks"])
    st = gather_state(drv.system, drv.state)
    np.savez(os.path.join(res, f"rank{rank}.npz"),
             paths=st.paths.numpy(), iworm=st.iworm.numpy(),
             isopen=st.isopen.numpy(), backend=drv.backend,
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
    gen = torch.Generator()
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


if __name__ == "__main__":
    mode, spec_path, res = sys.argv[1:4]
    with open(spec_path) as fh:
        spec = json.load(fh)
    {"run": run, "seam": seam, "errors": errors, "replay": replay,
     "sp": sp}[mode](
        spec, res, int(os.environ["RANK"]))
    # leave the group together: a rank that exits while a peer still
    # holds the connection can abort in gloo's teardown
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
