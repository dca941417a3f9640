"""The fused composite sweep (fused_sweep=True) against the reference.

Each composite move against the JAX move on the reference's own draws
(tests/torch_bridge.py), then the whole Sweeper.step in the three forms
the fused sweep takes (monoshot composites, end_regrow='sta', cascade=True)
against the reference's jitted step from one burned-in state.  Float64 on
the CPU: positions rtol 1e-10 / atol 1e-12, accept masks, counters and
integer state exactly equal, step statistics rtol 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import JaxDraws, bisect_multi_draws, fused_ends_draws, \
    half_draws, lattice_paths, other_cfg, small_cfg

from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import moves as mv
from pathintegralgroundstate_torch.state import state_from_numpy, \
    state_to_numpy
from pathintegralgroundstate_torch.sweep import COUNTER_NAMES, Sweeper, \
    StepStats, run_block, stats_to_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.ops import bisection as jbis
from pathintegralgroundstate_tpu.ops import moves as jmv
from pathintegralgroundstate_tpu.state import init_state as j_init_state
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])
FIELDS = ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm", "step")
FORMS = {"monoshot": {}, "sta": {"end_regrow": "sta"},
         "cascade": {"cascade": True}}
NSTEP = 2


@pytest.fixture(scope="module")
def case():
    cfg = small_cfg(fused_sweep=True)
    jsys = j_make_system(cfg)
    return (cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu"),
            lattice_paths(cfg))


def _check(got_paths, want_paths, *accs):
    np.testing.assert_allclose(got_paths.numpy(), np.asarray(want_paths),
                               **TOL)
    for got, want in accs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("ip", [0, 5])
def test_fused_end_bisections(case, ip, level):
    cfg, jsys, tables, tsys, paths = case
    kk = jax.random.key(3 + ip + 10 * level)
    jr, tr = fused_ends_draws(kk, cfg.n_walkers, level, cfg.dim, F64)
    want, wh, wt = jbis.fused_end_bisections(
        jsys, tables, kk, jnp.asarray(paths), ip, jnp.asarray(ACTIVE), level,
        rand=jr)
    got, gh, gt = bis.fused_end_bisections(
        tsys, torch.from_numpy(paths.copy()), ip, torch.from_numpy(ACTIVE),
        level, tr)
    _check(got, want, (gh, wh), (gt, wt))


@pytest.mark.parametrize("ips,per_slot", [([1, 5, 7], False),
                                          ([6, 7, 0], True), ([2, 3], False)])
def test_bisection_multi(case, ips, per_slot):
    cfg, jsys, tables, tsys, paths = case
    K = len(ips)
    act = np.tile(ACTIVE[:, None], (1, K)) if per_slot else ACTIVE
    if per_slot:
        act[0, 1] = act[4, 2] = False
    kk = jax.random.key(40 + K + per_slot)
    n_shift = (cfg.M - 1 - K * 4) // 2 + 1
    jr, tr = bisect_multi_draws(kk, cfg.n_walkers, K, 2, n_shift, cfg.dim,
                                F64)
    want, wacc = jbis.bisection_multi(jsys, tables, kk, jnp.asarray(paths),
                                      ips, jnp.asarray(act), 2, rand=jr)
    got, gacc = bis.bisection_multi(tsys, torch.from_numpy(paths.copy()), ips,
                                    torch.from_numpy(act), 2, tr)
    _check(got, want, (gacc, wacc))


@pytest.mark.parametrize("Lmax", [4, 6])
@pytest.mark.parametrize("ip", [2, 7])
def test_fused_end_stagings(case, ip, Lmax):
    cfg, jsys, tables, tsys, paths = case
    key = jax.random.key(60 + ip + Lmax)
    want, wh, wt = jmv.fused_end_stagings(jsys, tables, key,
                                          jnp.asarray(paths), ip,
                                          jnp.asarray(ACTIVE), Lmax)
    got, gh, gt = mv.fused_end_stagings(
        tsys, torch.from_numpy(paths.copy()), ip, torch.from_numpy(ACTIVE),
        Lmax, *half_draws(key, 2 * cfg.n_walkers, Lmax, cfg.dim, F64))
    _check(got, want, (gh, wh), (gt, wt))


def test_fused_geometry_matches_reference(case):
    cfg, jsys, tables, tsys, _ = case
    for kw in ({}, {"Nlev": 3}, {"Np": 2}):
        c = small_cfg(fused_sweep=True, **kw)
        ref = jsweep.Sweeper(j_make_system(c), make_tables(j_make_system(c)))
        got = Sweeper(make_system(other_cfg(c), "cpu"))
        assert (got.fused_diag, got.K_int) == (ref.fused_diag, ref.K_int)
    assert Sweeper(tsys).K_int == 3


@functools.lru_cache(maxsize=None)
def _jax_step(form):
    """(cfg, reference system, jitted reference step): one compile per
    form."""
    cfg = small_cfg(fused_sweep=True, **FORMS[form])
    jsys = j_make_system(cfg)
    return cfg, jsys, jax.jit(jsweep.Sweeper(jsys, make_tables(jsys)).step)


@pytest.fixture(scope="module")
def burned():
    """A reference state with open and closed walkers (fused sweep)."""
    cfg, jsys, step = _jax_step("monoshot")
    st, stats = j_init_state(jsys), jsweep.zero_stats(jsys)
    for _ in range(150):
        st, stats = step(st, stats)
    nopen = int(np.sum(np.asarray(st.isopen)))
    assert 0 < nopen < cfg.n_walkers
    return st


@pytest.fixture(scope="module", params=list(FORMS))
def runs(request, burned):
    cfg, jsys, step = _jax_step(request.param)
    st, ref_stats = burned, jsweep.zero_stats(jsys)
    for _ in range(NSTEP):
        st, ref_stats = step(st, ref_stats)
    tsys = make_system(other_cfg(cfg), "cpu")
    state = state_from_numpy(tsys, {k: getattr(burned, k) for k in FIELDS})
    state, stats = run_block(Sweeper(tsys), state, NSTEP,
                             JaxDraws(burned.key, cfg.dim, jnp.float64))
    return st, ref_stats, state, stats


def test_fused_step_state_matches_reference(runs):
    ref, _, state, _ = runs
    got = state_to_numpy(state)
    for k in ("paths", "xend"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(ref, k)), **TOL,
                                   err_msg=k)
    for k in ("isopen", "iworm", "in_cycle", "iperm", "step"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ref, k)),
                                      err_msg=k)


def test_fused_step_counters_match_reference(runs):
    _, ref_stats, _, stats = runs
    got = stats_to_numpy(stats)["counters"]
    np.testing.assert_array_equal(got, np.asarray(ref_stats.counters))
    c = dict(zip(COUNTER_NAMES, got))
    assert c["try_int"] > 0 and c["acc_bd"] > 0 and c["acc_head"] > 0


def test_fused_step_stats_match_reference(runs):
    _, ref_stats, _, stats = runs
    got = stats_to_numpy(stats)
    for k in StepStats._fields:
        if k != "counters":
            np.testing.assert_allclose(got[k],
                                       np.asarray(getattr(ref_stats, k)),
                                       rtol=1e-9, atol=1e-12, err_msg=k)
