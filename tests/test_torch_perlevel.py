"""The per-level bisection and the staging sampler against the reference.

The per-level construction helpers; the interior bisection and the fused
composites (fused_end_bisections, bisection_multi) in per-level form, with
batched randoms and with per-level key draws; the staging sampler's moves
(staging_move, move_head, move_tail) with the bridge and with the sequential
staging recursion (cfg.regrow='scan'), which also stands against the port's
own bridge; then whole steps of sampling='sta' with regrow='scan' and of the
fused sweep in per-level form against the reference's step on its own draws.
Float64 on the CPU: positions rtol 1e-12, accept masks, counters and
integer state exactly equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import assert_step_pair, bisect_draws, \
    bisect_keyed_draws, bisect_multi_draws, bisect_multi_keyed_draws, \
    fused_ends_draws, fused_ends_keyed_draws, half_draws, lattice_paths, \
    other_cfg, regrow_draws, small_cfg, staging_half_draws, step_pair

from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import moves as mv
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.pbc import wrap
from pathintegralgroundstate_tpu.ops import bisection as jbis
from pathintegralgroundstate_tpu.ops import moves as jmv
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])


@functools.lru_cache(maxsize=None)
def _systems(**kw):
    cfg = small_cfg(**kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, want, gacc, wacc):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))


@pytest.mark.parametrize("level", [2, 3])
def test_construct_levels_loop_matches_reference(level):
    """The literal level loop (one _level_proposal per level) against the
    reference's, and against the port's one-matmul construction up to the
    box image."""
    cfg, jsys, _, tsys = _systems(Nlev=level)
    L = 2 ** level
    paths = lattice_paths(cfg, seed=level)
    seg = paths[:, 3:3 + L + 1, 5]
    g = np.random.default_rng(level).normal(size=(cfg.n_walkers, L, 3))
    want = jbis._construct_levels_loop(jsys, jnp.asarray(seg), level, L,
                                       jnp.asarray(g))
    got = bis._construct_levels_loop(tsys, _t(seg), level, _t(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    mat = bis._construct_levels(tsys, _t(seg), level, L, _t(g))
    np.testing.assert_allclose(wrap(got - mat, tsys.L, tsys.half).numpy(),
                               0.0, atol=1e-12)
    for ilev in range(1, level + 1):
        delta, m, d2 = jbis._level_geometry(ilev, level)
        assert bis._level_geometry(ilev, level) == (delta, m, d2)


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_per_level_bisection(level, keyed):
    """Interior bisection level by level, with batched randoms and with the
    key form (window start from keys[0], level ilev from keys[ilev])."""
    cfg, jsys, tables, tsys = _systems(bis_monoshot=False, Nlev=level)
    paths = lattice_paths(cfg, seed=60 + level)
    key = jax.random.key(61 + level + 2 * keyed)
    W, D = cfg.n_walkers, cfg.dim
    n_opts = (cfg.M - 1 - 2 ** level) // 2 + 1
    if keyed:
        jr, tr = None, bisect_keyed_draws(key, W, level, D, F64, n_opts, True)
    else:
        jr, tr = bisect_draws(key, W, level, D, F64, n_opts)
    want, wacc = jbis.bisection(jsys, tables, key, jnp.asarray(paths), 6,
                                jnp.asarray(ACTIVE), level, rand=jr)
    got, gacc = bis.bisection(tsys, _t(paths), 6, _t(ACTIVE), level, tr)
    _check(got, want, gacc, wacc)
    assert 0 < int(gacc.sum())


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("ip", [0, 7])
def test_fused_end_bisections_per_level(ip, keyed):
    cfg, jsys, tables, tsys = _systems(fused_sweep=True, bis_monoshot=False)
    paths = lattice_paths(cfg, seed=70 + ip)
    key = jax.random.key(71 + ip + keyed)
    W, D, nlev = cfg.n_walkers, cfg.dim, cfg.Nlev
    if keyed:
        jr, tr = None, fused_ends_keyed_draws(key, W, nlev, D, F64, True)
    else:
        jr, tr = fused_ends_draws(key, W, nlev, D, F64)
    want, wh, wt = jbis.fused_end_bisections(
        jsys, tables, key, jnp.asarray(paths), ip, jnp.asarray(ACTIVE), nlev,
        rand=jr)
    got, gh, gt = bis.fused_end_bisections(tsys, _t(paths), ip, _t(ACTIVE),
                                           nlev, tr)
    _check(got, want, gh, wh)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("keyed", [False, True])
@pytest.mark.parametrize("ips", [(1, 4, 6), (7, 0)])
def test_bisection_multi_per_level(ips, keyed):
    """K slots: one kernel-A pass per level over the span's strided
    midpoints, per-row particle index [1, K m]."""
    cfg, jsys, tables, tsys = _systems(fused_sweep=True, bis_monoshot=False)
    paths = lattice_paths(cfg, seed=80 + len(ips))
    K, W, D, nlev = len(ips), cfg.n_walkers, cfg.dim, cfg.Nlev
    act = np.broadcast_to(ACTIVE[:, None], (W, K)).copy()
    act[1, 0] = False
    key = jax.random.key(81 + K + keyed)
    n_shift = (cfg.M - 1 - K * 2 ** nlev) // 2 + 1
    if keyed:
        jr, tr = None, bisect_multi_keyed_draws(key, W, K, nlev, n_shift, D,
                                                F64, True)
    else:
        jr, tr = bisect_multi_draws(key, W, K, nlev, n_shift, D, F64)
    want, wacc = jbis.bisection_multi(jsys, tables, key, jnp.asarray(paths),
                                      list(ips), jnp.asarray(act), nlev,
                                      rand=jr)
    got, gacc = bis.bisection_multi(tsys, _t(paths), list(ips), _t(act), nlev,
                                    tr)
    _check(got, want, gacc, wacc)


@pytest.mark.parametrize("regrow", ["bridge", "scan"])
@pytest.mark.parametrize("move", ["staging", "head", "tail"])
def test_staging_sampler_moves(move, regrow):
    """staging_move / move_head / move_tail (the reference's split(key, 3)
    each), Lstag=6: the head and tail windows' per-walker Ls."""
    cfg, jsys, tables, tsys = _systems(sampling="sta", regrow=regrow,
                                       Lstag=6)
    paths = lattice_paths(cfg, seed=90)
    key = jax.random.key(91 + len(move))
    W, D, L = cfg.n_walkers, cfg.dim, cfg.Lstag
    jfn = {"staging": jmv.staging_move, "head": jmv.move_head,
           "tail": jmv.move_tail}[move]
    tfn = {"staging": mv.staging_move, "head": mv.move_head,
           "tail": mv.move_tail}[move]
    if move == "staging":
        draws = staging_half_draws(key, W, (cfg.M - 1 - L) // 2 + 1, L, D,
                                   F64)
    else:
        draws = half_draws(key, W, L, D, F64)
    want, wacc = jfn(jsys, tables, key, jnp.asarray(paths), 2,
                     jnp.asarray(ACTIVE), L)
    got, gacc = tfn(tsys, _t(paths), 2, _t(ACTIVE), L, *draws)
    _check(got, want, gacc, wacc)
    assert 0 < int(gacc.sum())


@pytest.mark.parametrize("first_mode", ["gauss", "fixed"])
def test_scan_regrow_matches_reference_and_bridge(first_mode):
    """segment_regrow with cfg.regrow='scan' against the reference's scan,
    and the port's scan against the port's bridge (the same gaussians, the
    bridge unrolled) up to the box image."""
    cfg, jsys, tables, tsys = _systems(sampling="sta", regrow="scan")
    _, _, _, tsys_b = _systems(sampling="sta")
    W, D, Lb = cfg.n_walkers, cfg.dim, 8
    paths = lattice_paths(cfg, seed=95)
    seg, R_seg = paths[:, :Lb + 1, 1], paths[:, :Lb + 1]
    ib = np.broadcast_to(np.arange(Lb + 1), (W, Lb + 1))
    Ls = (np.random.default_rng(1).integers(2, Lb + 1, W)
          if first_mode == "gauss" else np.full(W, Lb))
    key = jax.random.key(96)
    fixed_L = None if first_mode == "gauss" else Lb
    want = jmv.segment_regrow(jsys, tables, key, jnp.asarray(seg),
                              jnp.asarray(R_seg), jnp.asarray(ib), 1,
                              jnp.asarray(Ls), first_mode, 1.0,
                              fixed_L=fixed_L)
    g0, gs = regrow_draws(key, W, Lb, D, F64)
    outs = [mv.segment_regrow(s, _t(seg), _t(R_seg), _t(ib[0]), 1,
                              _t(Ls).long(), first_mode, 1.0, g0, gs,
                              fixed_L=fixed_L) for s in (tsys, tsys_b)]
    for got, w in zip(outs[0], want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    (scan, dS_scan), (bridge, dS_bridge) = outs
    np.testing.assert_allclose(wrap(scan - bridge, tsys.L, tsys.half).numpy(),
                               0.0, atol=1e-12)
    np.testing.assert_allclose(dS_scan.numpy(), dS_bridge.numpy(), rtol=1e-9,
                               atol=1e-9)


@pytest.fixture(scope="module", params=["sta_scan", "fused_per_level"])
def steps(request):
    """sampling='sta' with the scan; the fused sweep in per-level form
    without batched randoms (the threshold set below W, so the composites
    take the key form)."""
    if request.param == "sta_scan":
        return step_pair(small_cfg(sampling="sta", regrow="scan"))
    return step_pair(small_cfg(fused_sweep=True, bis_monoshot=False),
                     max_w=4)


def test_step_matches_reference(steps):
    counters = assert_step_pair(*steps, TOL)
    assert counters[2] > 0 and counters[3] > 0 and counters[4] > 0
