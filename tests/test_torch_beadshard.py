"""The SP bead sharding of the port (parallel/beadshard.py, cfg.mesh_beads):
the counterparts of tests/test_beadshard.py's four checks over four gloo
ranks on the CPU, and the port held against the JAX package.

Over an sp ring of 4 ranks (one torchrun launch, tests/torch_mesh_worker.py
mode `sp`, shared by the first four tests):
  * the received halo equals the rank's own copy of the next shard's first
    bead, and 3 sharded sweeps equal sp_staging_sweep_ref on one process
    bit for bit, on every rank (test_beadshard.py:37-55);
  * only the owned interiors of particle ip move (:57-73);
  * 200 sweeps of the free particle accept everything, and the one-link
    variance inside the shards is dt within 15 % (:76-117);
  * a Driver block at M = 129, S = 4 equals the unsharded block: paths
    within rtol 1e-12, every counter of metrics.jsonl exactly, the
    energies within rtol 1e-12 (:120-172).
Against the JAX package on the reference's draws (tests/torch_bridge.py):
the port's sp_staging_sweep_ref equals the JAX one in float64 to 1e-12,
and a whole mesh_beads = 4 block of the Sweeper equals the JAX block.  The
geometry and envelope errors are the reference's.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel import run_worker
from torch_bridge import JaxDraws, other_cfg, sp_draws

from pathintegralgroundstate_torch.config import SimConfig
from pathintegralgroundstate_torch.parallel import beadshard as bs
from pathintegralgroundstate_torch.state import init_state, state_from_numpy
from pathintegralgroundstate_torch.sweep import COUNTER_NAMES, Sweeper, \
    run_block, stats_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.draws import DeviceDraws
from pathintegralgroundstate_tpu.parallel import beadshard as jbs
from pathintegralgroundstate_tpu.system import make_system as jmake
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

S = 4


def sweep_cfg(**kw):
    """test_beadshard.py's _setup: dim 1, Np 4, Nb 64 (M = 129: 4 shards of
    32 links), staging L = 8, W = 16, float64, the soft potential."""
    base = dict(dim=1, Np=4, density=0.3, dt=5e-3, Nb=64, sampling="sta",
                Lstag=8, Nstag=1, n_walkers=16, dtype="float64",
                potential="soft", Rm=1.2, seed=5, use_pallas=False)
    base.update(kw)
    return SimConfig(**base)


def start_paths(cfg, seed=7, noise=0.0):
    """Uniform positions in the box, one configuration along all beads (a
    classical start), with gaussian noise of width `noise` per bead, numpy
    float64 [W, M, N, D]."""
    g = np.random.default_rng(seed)
    L = make_system(cfg, "cpu").geo.Lbox[0]
    shape = (cfg.n_walkers, cfg.M, cfg.Np, cfg.dim)
    x = (g.random((cfg.n_walkers, 1, cfg.Np, cfg.dim)) - 0.5) * L
    return np.ascontiguousarray(np.broadcast_to(x, shape)
                                + noise * g.normal(size=shape))


def run_cfg():
    """test_beadshard.py:131-135's production configuration (M = 129,
    S = 4) for 1 block of 2 steps."""
    return SimConfig(dim=3, Np=4, density=0.3, dt=5e-3, Nb=64,
                     sampling="sta", Lstag=8, Nstag=1, CMFreq=1,
                     delta_cm=0.1, Rm=1.2, n_walkers=8, dtype="float64",
                     potential="aziz2", seed=3, Nstep=2, Nblock=1,
                     mesh_beads=S)


SPEC = dict(ip=2, calls=3, draw_seed=11, bridge=200, blocks=1)


def draws_of(system, seed):
    gen, host = torch.Generator(), torch.Generator()
    gen.manual_seed(seed)
    host.manual_seed(seed + 1)
    return DeviceDraws(system, gen, host)


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    """One torchrun launch of the worker's `sp` mode; (the start paths, the
    per-rank results, the run's output directory)."""
    tmp = tmp_path_factory.mktemp("sp")
    cfg = sweep_cfg()
    free = sweep_cfg(Np=1, potential="none", jastrow="none")
    start = tmp / "start.npz"
    np.savez(start, paths=start_paths(cfg, noise=0.02),
             free=start_paths(free, 3))
    res = run_worker(
        tmp, S, "sp", cfg, out=tmp / "run", start=str(start),
        free_cfg=dataclasses.asdict(free),
        cfg_run=dataclasses.asdict(run_cfg()), **SPEC)
    z = [dict(np.load(res / f"rank{r}.npz")) for r in range(S)]
    return dict(np.load(start)), z, tmp / "run"


def test_sp_sweep_matches_unsharded_bitwise(ring):
    start, z, _ = ring
    cfg = sweep_cfg()
    system = make_system(cfg, "cpu")
    paths = torch.from_numpy(start["paths"].copy())
    src = draws_of(system, SPEC["draw_seed"])
    Mloc, L = (cfg.M - 1) // S, cfg.Lstag
    accs = [bs.sp_staging_sweep_ref(
        system, paths, SPEC["ip"], S, L,
        src.sp_staging(it, cfg.n_walkers, S, bs.n_starts(Mloc, L),
                       L)).numpy() for it in range(SPEC["calls"])]
    for zr in z:
        assert zr["halo_equal"]
        np.testing.assert_array_equal(zr["paths"], paths.numpy())
        np.testing.assert_array_equal(zr["acc"], np.stack(accs))
        # two exchanges per call, and one for the ring check
        assert zr["sweep_collectives"] == 1 + 2 * SPEC["calls"]
    assert np.stack(accs).any()
    assert not np.array_equal(paths.numpy(), start["paths"])


def test_sp_sweep_only_moves_owned_interiors(ring):
    start, z, _ = ring
    before, after = start["paths"], z[0]["paths"]
    Mloc = (before.shape[1] - 1) // S
    for k in range(S + 1):
        np.testing.assert_array_equal(after[:, k * Mloc], before[:, k * Mloc])
    other = [i for i in range(before.shape[2]) if i != SPEC["ip"]]
    np.testing.assert_array_equal(after[:, :, other], before[:, :, other])
    assert not np.array_equal(after[:, :, SPEC["ip"]],
                              before[:, :, SPEC["ip"]])


def test_sp_free_particle_bridge_statistics(ring):
    """With V = 0 every window is an exact Brownian bridge, so every move
    accepts; the one-link increments inside the shards (away from the
    boundary beads, which this kernel never moves) have variance dt."""
    _, z, _ = ring
    cfg = sweep_cfg(Np=1, potential="none", jastrow="none")
    for zr in z:
        assert zr["free_all_accepted"]
        np.testing.assert_array_equal(zr["free"], z[0]["free"])
    prev = z[0]["free"][:, :-1]
    L = make_system(cfg, "cpu").geo.Lbox[0]
    diffs = prev[:, 1:] - prev[:, :-1]
    diffs = diffs - L * np.round(diffs / L)
    Mloc = prev.shape[1] // S
    inner = np.concatenate([diffs[:, k * Mloc + 2:(k + 1) * Mloc - 2]
                            for k in range(S)], axis=1)
    assert abs(inner.var() / cfg.dt - 1.0) < 0.15, inner.var()


def test_mesh_beads_production_sweep(ring):
    """The Driver over the 4-rank ring equals the unsharded block
    (sp_staging_sweep_ref, run_block on one process from the same start):
    paths within rtol 1e-12, counters exactly, energies within 1e-12."""
    _, z, out = ring
    cfg = run_cfg()
    system = make_system(cfg, "cpu")
    sweeper = Sweeper(system)
    assert not sweeper.sp_sharded
    state, stats = run_block(sweeper, init_state(system), cfg.Nstep)
    st = stats_to_numpy(stats)
    (row,) = [json.loads(x) for x in open(out / "metrics.jsonl")]
    assert [row[n] for n in COUNTER_NAMES] == st["counters"].tolist()
    assert row["acc_bd"] > 0 and row["sp"] == S
    for nm in ("E", "Et"):
        np.testing.assert_allclose(row[f"Av{nm}"],
                                   st[f"sum{nm}"] / st["n_diag"] / cfg.Np,
                                   rtol=1e-12)
    for zr in z:
        np.testing.assert_allclose(zr["run_paths"], state.paths.numpy(),
                                   rtol=1e-12, atol=1e-13)
        assert zr["acc_diag_bl"] == 1
        # per step: 2 exchanges per particle visit, Nstag * Np visits
        assert zr["run_collectives"] == cfg.Nstep * 2 * cfg.Nstag * cfg.Np


def test_sp_ref_matches_jax_ref():
    """The port's sp_staging_sweep_ref equals the JAX package's on the
    reference's draws, in float64 to 1e-12, over 6 calls, among which a
    window of every shard ends on its halo bead."""
    jcfg = other_cfg(sweep_cfg())
    jsys = jmake(jcfg)
    jsweep = jax.jit(jbs.sp_staging_sweep_ref(jsys, make_tables(jsys), S,
                                              jcfg.Lstag), static_argnums=3)
    tsys = make_system(sweep_cfg(), "cpu")
    # beads apart, so that every halo bead (M-1 included) is its own
    paths = start_paths(sweep_cfg(), noise=0.02)
    body, last = jnp.asarray(paths[:, :-1]), jnp.asarray(paths[:, -1])
    tpaths = torch.from_numpy(paths.copy())
    Mloc, L = (jcfg.M - 1) // S, jcfg.Lstag
    # a key whose 6 calls end a window of every shard on its halo bead
    key = jax.random.key(10)
    halo_used = [False] * S
    for ip in (1, 2, 1, 3, 0, 2):
        key, k = jax.random.split(key)
        body, jacc = jsweep(k, body, last, ip)
        draws = sp_draws(k, jcfg.n_walkers, S, bs.n_starts(Mloc, L), L, 1,
                         jnp.float64)
        halo_used = [h or d[0] + L == Mloc for h, d in zip(halo_used, draws)]
        tacc = bs.sp_staging_sweep_ref(tsys, tpaths, ip, S, L, draws)
        np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
        np.testing.assert_allclose(tpaths[:, :-1].numpy(), np.asarray(body),
                                   rtol=1e-12, atol=1e-12)
    assert np.asarray(jacc).any()
    # every shard's window reached its halo bead, the last shard's (the
    # replicated bead M-1) too
    assert all(halo_used), halo_used


def test_sp_block_matches_jax_block():
    """A whole mesh_beads = 4 block (head, tail and the SP sweep per
    visit, CM moves, estimators) of the port's Sweeper equals the JAX
    Sweeper's (its shard_map over 4 of the CPU's devices) on the JAX
    block's draws; M = 33, Mloc = 8."""
    from pathintegralgroundstate_tpu import sweep as jsweep
    from pathintegralgroundstate_tpu.state import init_state as jinit

    cfg = SimConfig(dim=3, Np=4, density=0.3, dt=5e-3, Nb=16,
                    sampling="sta", Lstag=8, Nstag=1, CMFreq=1,
                    delta_cm=0.1, Rm=1.2, n_walkers=8, dtype="float64",
                    potential="aziz2", seed=3, mesh_beads=S)
    jsys = jmake(other_cfg(cfg))
    jsw = jsweep.Sweeper(jsys, make_tables(jsys))
    st0 = jinit(jsys)
    st, jstats = jax.jit(lambda s: jsweep.run_block(
        jsys, make_tables(jsys), jsw, s, 2))(st0)
    tsys = make_system(cfg, "cpu")
    state = state_from_numpy(tsys, {k: getattr(st0, k) for k in (
        "paths", "xend", "isopen", "iworm", "in_cycle", "iperm", "step")})
    state, stats = run_block(Sweeper(tsys), state, 2,
                             JaxDraws(st0.key, cfg.dim, jnp.float64))
    np.testing.assert_allclose(state.paths.numpy(), np.asarray(st.paths),
                               rtol=1e-11, atol=1e-12)
    got = stats_to_numpy(stats)
    np.testing.assert_array_equal(got["counters"],
                                  np.asarray(jstats.counters))
    for k in ("sumE", "sumEt", "sumV", "gr"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jstats, k)),
                                   rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("M,S_,L", [(130, 4, 8), (133, 4, 8), (129, 4, 9),
                                    (129, 4, 34)],
                         ids=["links", "odd-Mloc", "odd-L", "L>Mloc"])
def test_sp_geometry_errors_are_the_reference(M, S_, L):
    with pytest.raises(ValueError) as want:
        jbs._check_sp_geometry(M - 1, S_, L)
    with pytest.raises(ValueError) as got:
        bs.check_sp_geometry(M - 1, S_, L)
    assert str(got.value) == str(want.value)
