"""Per-walker windows (shared_windows=False) against the reference.

With shared_windows=False every walker draws its own window start
(moves._window_start, bisection._draw_monoshot with start_shape (W,)): the
port gathers each walker's window into a contiguous copy, passes kernel A
its [W, B] bead indices and scatters the accepted beads back.  Held here on
the reference's own draws (tests/torch_bridge.py with per-walker starts):
the interior bisection in monoshot and per-level form, the staging sampler's
staging_move, the worm's half-chain staging, the exact-F^2 cache's
per-walker windows (_codd_window and its write-back), and whole steps of
four forms.  Float64 on the CPU: positions rtol 1e-10, accept masks,
counters and integer state exactly equal.  The law of the port's own
per-walker starts is held in tests/test_torch_draws.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import assert_step_pair, bisect_keyed_draws, \
    lattice_paths, other_cfg, small_cfg, staging_half_draws, step_pair

from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import moves as mv
from pathintegralgroundstate_torch.ops import pairwise as tpw
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import bisection as jbis
from pathintegralgroundstate_tpu.ops import moves as jmv
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])


@functools.lru_cache(maxsize=None)
def _systems(**kw):
    cfg = small_cfg(shared_windows=False, **kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, want, gacc, wacc):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))


def _spread(start):
    """The per-walker starts take more than one value (the gather and the
    scatter see different windows)."""
    assert start.shape == (ACTIVE.size,) and len(set(start.tolist())) > 1


# ---------------------------------------------------------------------------
# The moves
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("monoshot", [True, False], ids=["monoshot",
                                                         "per_level"])
def test_interior_bisection(monoshot, level):
    """bisection without batched randoms (the reference's only form with
    per-walker windows): a [W] start from _draw_monoshot or, per level,
    from keys[0]."""
    cfg, jsys, tables, tsys = _systems(bis_monoshot=monoshot, Nlev=level)
    paths = lattice_paths(cfg, seed=10 + level)
    key = jax.random.key(11 + level + 2 * monoshot)
    n_opts = (cfg.M - 1 - 2 ** level) // 2 + 1
    tr = bisect_keyed_draws(key, cfg.n_walkers, level, cfg.dim, F64, n_opts,
                            not monoshot, shared=False)
    _spread(tr[0])
    want, wacc = jbis.bisection(jsys, tables, key, jnp.asarray(paths), 6,
                                jnp.asarray(ACTIVE), level)
    got, gacc = bis.bisection(tsys, _t(paths), 6, _t(ACTIVE), level, tr)
    _check(got, want, gacc, wacc)
    assert 0 < int(gacc.sum())


@pytest.mark.parametrize("L", [4, 6])
def test_staging_move(L):
    """The staging sampler's interior move, per-walker windows of L links."""
    cfg, jsys, tables, tsys = _systems(sampling="sta", Lstag=L)
    paths = lattice_paths(cfg, seed=20 + L)
    key = jax.random.key(21 + L)
    draws = staging_half_draws(key, cfg.n_walkers, (cfg.M - 1 - L) // 2 + 1,
                               L, cfg.dim, F64, shared=False)
    _spread(draws[0])
    want, wacc = jmv.staging_move(jsys, tables, key, jnp.asarray(paths), 2,
                                  jnp.asarray(ACTIVE), L)
    got, gacc = mv.staging_move(tsys, _t(paths), 2, _t(ACTIVE), L, *draws)
    _check(got, want, gacc, wacc)
    assert 0 < int(gacc.sum())


@pytest.mark.parametrize("Nb", [8, 9])
@pytest.mark.parametrize("half", [1, 2])
def test_staging_half_chain(half, Nb):
    """The worm's half-chain staging with a per-walker worm particle and
    per-walker windows; Nb = 9 puts the second half's windows on odd
    starts."""
    cfg, jsys, tables, tsys = _systems(Nb=Nb, Lstag=4)
    W, L = cfg.n_walkers, cfg.Lstag
    paths = lattice_paths(cfg, seed=30 + half)
    rng = np.random.default_rng(31 + half)
    iworm = rng.integers(0, cfg.Np, W).astype(np.int32)
    xend = (paths[np.arange(W), Nb, iworm][:, None]
            + 0.05 * rng.normal(size=(W, 2, cfg.dim)))
    key = jax.random.key(32 + half)
    draws = staging_half_draws(key, W, (Nb - L) // 2 + 1, L, cfg.dim, F64,
                               shared=False)
    _spread(draws[0])
    want, wx, wacc = jmv.staging_half_chain(
        jsys, tables, key, jnp.asarray(paths), jnp.asarray(xend),
        jnp.asarray(iworm), half, jnp.asarray(ACTIVE), L)
    got, gx, gacc = mv.staging_half_chain(
        tsys, _t(paths), _t(xend), _t(iworm).long(), half, _t(ACTIVE), L,
        *draws)
    _check(got, want, gacc, wacc)
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), **TOL)


# ---------------------------------------------------------------------------
# The exact-F^2 cache's per-walker windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("par", [0, 1])
def test_codd_window_and_write_back(par):
    """_codd_window gathers the cache rows under each walker's window and
    _cache_win_write scatters them back, as the reference's per-walker
    _slice_beads / .at[].set do (moves.py:464-505)."""
    cfg, jsys, tables, tsys = _systems(exact_f2=True)
    W, B = cfg.n_walkers, 5
    rng = np.random.default_rng(40 + par)
    codd = rng.normal(size=(W, cfg.Nb, cfg.Np, cfg.dim))
    lo = par + 2 * rng.integers(0, 5, W)
    jf, jsub, jk0 = jmv._codd_window(jnp.asarray(codd), jnp.asarray(lo),
                                     par, B)
    tf, tsub, tk0 = mv._codd_window(_t(codd), _t(lo), B, par)
    assert tsub == jsub
    np.testing.assert_array_equal(tk0.numpy(), np.asarray(jk0))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    dfield = rng.normal(size=tf.shape)
    acc = rng.random(W) < 0.5
    for reverse in (False, True):
        want = jmv._cache_win_write(jnp.asarray(codd), jf,
                                    jnp.asarray(dfield), jnp.asarray(acc),
                                    jk0, reverse)
        got = _t(codd)
        mv._cache_win_write(got, tf, _t(dfield), _t(acc), tk0, reverse)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("monoshot", [True, False], ids=["monoshot",
                                                         "per_level"])
def test_cached_bisection(monoshot):
    """The interior bisection with the odd-bead cache and per-walker
    windows: the paths, the accepts and the cache as the reference leaves
    them."""
    cfg, jsys, tables, tsys = _systems(exact_f2=True, bis_monoshot=monoshot)
    paths = lattice_paths(cfg, seed=50)
    key = jax.random.key(51 + monoshot)
    level = cfg.Nlev
    n_opts = (cfg.M - 1 - 2 ** level) // 2 + 1
    fodd = np.asarray(jpw.force_field(jsys, tables,
                                      jnp.asarray(paths[:, 1::2])))
    tr = bisect_keyed_draws(key, cfg.n_walkers, level, cfg.dim, F64, n_opts,
                            not monoshot, shared=False)
    _spread(tr[0])
    want, wf, wacc = jbis.bisection(jsys, tables, key, jnp.asarray(paths), 4,
                                    jnp.asarray(ACTIVE), level,
                                    fodd=jnp.asarray(fodd))
    tf = _t(fodd)
    got, gacc = bis.bisection(tsys, _t(paths), 4, _t(ACTIVE), level, tr, tf)
    _check(got, want, gacc, wacc)
    np.testing.assert_allclose(tf.numpy(), np.asarray(wf), **TOL)
    # the kept cache is still the field of the new paths
    np.testing.assert_allclose(
        tf.numpy(), tpw.force_field(tsys, got[:, 1::2]).numpy(), rtol=1e-9,
        atol=1e-9)


# ---------------------------------------------------------------------------
# Whole steps on the reference's draws
# ---------------------------------------------------------------------------

STEP_FORMS = {
    "flagship": {},                              # unfused monoshot
    "reference_order": dict(bis_monoshot=False),  # per level
    "staging": dict(sampling="sta"),
    "exact_f2": dict(exact_f2=True),             # the odd-bead cache
}


@pytest.mark.parametrize("form", sorted(STEP_FORMS))
def test_step_matches_reference(form):
    """Two steps of the port on the reference's draws (per-walker starts at
    every bisection and staging site, the worm's half-chain staging
    included) from a burned-in reference state."""
    cfg = small_cfg(shared_windows=False, **STEP_FORMS[form])
    ref, ref_stats, state, stats = step_pair(cfg, nstep=2)
    ctr = assert_step_pair(ref, ref_stats, state, stats, TOL)
    assert ctr[2] > 0 and ctr[3] > 0     # try_stag, acc_bd


def test_sweeper_takes_keyed_draws():
    """Per-walker windows turn the batched randoms off (sweep.py:227)."""
    from pathintegralgroundstate_torch.sweep import Sweeper
    assert not Sweeper(_systems()[3]).batch_rand
    assert Sweeper(make_system(other_cfg(small_cfg()), "cpu")).batch_rand
