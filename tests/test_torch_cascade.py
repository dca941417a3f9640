"""The cascade composites (ops/cascade.py) against the reference's
ops/cascade_kernels.py, float64 on the CPU.

The reference's Pallas cascade runs only on a TPU (tests/test_cascade.py
skips it elsewhere), so its jnp twin `cascade_jnp` is the reference here:
the port's plain form `cascade_ref` must equal it on the same windows and
randoms, in the modes 'ends', 'interior' and 'rigid'; the three wrappers
must equal theirs on the reference's own draws (tests/torch_bridge.py).
Positions rtol 1e-10 / atol 1e-12, accept masks exactly equal.  Kernel 5
itself is held against cascade_ref on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import cascade_ends_draws, cascade_interior_draws, \
    lattice_paths, other_cfg, small_cfg, translate_draws, tt

from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.config import SimConfig
from pathintegralgroundstate_tpu.ops import cascade_kernels as jcas
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])


@pytest.fixture(scope="module")
def case():
    cfg = small_cfg(fused_sweep=True, cascade=True)
    jsys = j_make_system(cfg)
    return (cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu"),
            lattice_paths(cfg))


def _slots(mode, M, L, ip):
    if mode == "ends":
        return [(0, 1, ip), (M - 1, -1, ip)]
    if mode == "interior":
        return [(2 + k * L, 1, p) for k, p in enumerate((1, 5, 7))]
    return [(0, 1, ip)]


@pytest.mark.parametrize("mode", ["ends", "interior", "rigid"])
def test_cascade_ref_matches_cascade_jnp(case, mode):
    cfg, jsys, tables, tsys, paths = case
    W, M, D = cfg.n_walkers, cfg.M, cfg.dim
    nlev = 0 if mode == "rigid" else 2
    L = M - 1 if mode == "rigid" else 2 ** nlev
    slots = _slots(mode, M, L, 3)
    S = len(slots)
    G = {"ends": nlev + 1, "interior": nlev, "rigid": 1}[mode]
    rng = np.random.default_rng(5)
    rg = 0.6 * rng.normal(size=(W, S, L + 1, D))
    if mode == "rigid":
        rg[:, :, 1:] = 0.0
        rg[:, :, 0] = 0.1 * rng.uniform(-1, 1, size=(W, S, D))
    ru = rng.uniform(size=(W, S, G))
    act = np.tile(ACTIVE[:, None], (1, S))
    act[1, -1] = False

    def window(b0, step):
        return paths[:, b0:b0 + L + 1] if step > 0 else \
            paths[:, b0 - L:b0 + 1][:, ::-1]

    Rwin = np.stack([window(b0, st) for b0, st, _ in slots], 1)
    ips = jnp.asarray([p for _, _, p in slots], jnp.int32)
    want_seg, want_acc = jcas.cascade_jnp(
        jsys, tables, mode, jnp.asarray(Rwin), jnp.asarray(rg),
        jnp.asarray(ru), ips, nlev, jnp.asarray(act))

    got = torch.from_numpy(paths.copy())
    acc = cas.cascade_ref(tsys, mode, got, slots, tt(rg), tt(ru),
                          torch.from_numpy(act), nlev)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert 0 < int(acc.sum()) < int(act.sum())
    want_seg = np.asarray(want_seg)
    rows = slice(1, L) if mode == "interior" else slice(0, L + 1)
    expect = paths.copy()
    for s, (b0, step, ip) in enumerate(slots):
        beads = b0 + step * np.arange(L + 1)
        expect[:, beads[rows], ip] = want_seg[:, s, rows]
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


@pytest.mark.parametrize("ip", [0, 6])
def test_fused_ends_cascade(case, ip):
    cfg, jsys, tables, tsys, paths = case
    key = jax.random.key(11 + ip)
    want, wh, wt = jcas.fused_ends_cascade(jsys, tables, key,
                                           jnp.asarray(paths), ip,
                                           jnp.asarray(ACTIVE), 2)
    got, gh, gt = cas.fused_ends_cascade(
        tsys, torch.from_numpy(paths.copy()), ip, torch.from_numpy(ACTIVE), 2,
        *cascade_ends_draws(key, cfg.n_walkers, 2, cfg.dim, F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


@pytest.mark.parametrize("per_slot", [False, True])
def test_interior_cascade(case, per_slot):
    cfg, jsys, tables, tsys, paths = case
    W, M, K, L = cfg.n_walkers, cfg.M, 3, 4
    ips = [2, 7, 4]
    act = np.tile(ACTIVE[:, None], (1, K)) if per_slot else ACTIVE
    if per_slot:
        act[0, 1] = act[3, 2] = False
    key = jax.random.key(21 + per_slot)
    want, wacc = jcas.interior_cascade(jsys, tables, key, jnp.asarray(paths),
                                       ips, jnp.asarray(act), 2)
    n_shift = (M - 1 - K * L) // 2 + 1
    got, gacc = cas.interior_cascade(
        tsys, torch.from_numpy(paths.copy()), ips, torch.from_numpy(act), 2,
        *cascade_interior_draws(key, W, K, 2, n_shift, cfg.dim, F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))


@pytest.mark.parametrize("ip", [1, 5])
def test_rigid_cascade(case, ip):
    cfg, jsys, tables, tsys, paths = case
    delta = jsys.geo.delta_cm
    key = jax.random.key(31 + ip)
    want, wacc = jcas.rigid_cascade(jsys, tables, key, jnp.asarray(paths),
                                    ip, jnp.asarray(ACTIVE), delta)
    got, gacc = cas.rigid_cascade(
        tsys, torch.from_numpy(paths.copy()), ip, torch.from_numpy(ACTIVE),
        delta, *translate_draws(key, cfg.n_walkers, cfg.dim, F64))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))


def test_cascade_he4_window_hygiene():
    """tests/test_cascade.py's hygiene case on the port, on the reference's
    paths and draws: only the intended particle and beads move, and the
    accepts equal the reference's."""
    cfg = SimConfig(dim=3, Np=8, density=0.3, dt=5e-3, Nb=8, sampling="bis",
                    Nlev=2, Rm=1.2, n_walkers=16, dtype="float64",
                    potential="aziz2", seed=4)
    jsys = j_make_system(cfg)
    tables = make_tables(jsys)
    system = make_system(other_cfg(cfg), "cpu")
    W_, N, M, D = cfg.n_walkers, cfg.Np, system.M, cfg.dim
    jpaths = jnp.asarray(jsys.geo.Lbox) * (
        jax.random.uniform(jax.random.key(9), (W_, M, N, 3), jnp.float64)
        - 0.5)
    paths = np.asarray(jpaths)
    act = torch.ones(W_, dtype=torch.bool)
    L = 4

    p2, ah, at = cas.fused_ends_cascade(
        system, torch.from_numpy(paths.copy()), 3, act, 2,
        *cascade_ends_draws(jax.random.key(1), W_, 2, D, F64))
    d = np.abs(p2.numpy() - paths)
    assert d[:, L + 1: M - 1 - L].max() == 0.0       # interior untouched
    assert (d[:, :, :3].max() == 0.0) and (d[:, :, 4:].max() == 0.0)
    assert 0 < int(ah.sum()) <= W_
    _, jh, jt = jcas.fused_ends_cascade(jsys, tables, jax.random.key(1),
                                        jpaths, 3, jnp.asarray(act.numpy()),
                                        2)
    np.testing.assert_array_equal(ah.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(at.numpy(), np.asarray(jt))

    n_shift = (M - 1 - 3 * L) // 2 + 1
    p3, acc = cas.interior_cascade(
        system, torch.from_numpy(paths.copy()), [1, 5, 7], act, 2,
        *cascade_interior_draws(jax.random.key(2), W_, 3, 2, n_shift, D,
                                F64))
    d = np.abs(p3.numpy() - paths)
    assert d[:, :, [0, 2, 3, 4, 6]].max() == 0.0      # other particles fixed
    assert d[:, 0].max() == 0.0 and d[:, -1].max() == 0.0
    assert int(acc.sum()) > 0

    p4, accr = cas.rigid_cascade(
        system, torch.from_numpy(paths.copy()), 2, act, 0.05,
        *translate_draws(jax.random.key(3), W_, D, F64))
    d = np.abs(p4.numpy() - paths)
    assert (d[:, :, :2].max() == 0.0) and (d[:, :, 3:].max() == 0.0)
    moved = accr.numpy()
    assert 0 < moved.sum() <= W_
    # the whole worldline moves rigidly for accepted walkers only
    assert d[~moved].max() == 0.0 and (d[moved][:, :, 2] > 0).all()
