"""dim > 3 in the torch port against the reference, float64 on the CPU.

The System takes every dim >= 1, and at dim 4 and 5 the plain forms of
the five kernels equal the reference's, per pair model: pair_terms_ref
against the reference's Pallas kernel A (pair_rows_pallas) and
pair_rows_ref against its jnp delta_action_rows; pair_pot_ref against
pair_pot_pallas and the jnp pair_pot; pair_delta_ref and pair_u_ref
against pair_delta_pallas and pair_u_pallas, and the action delta against
the jnp delta_action; cascade_ref against cascade_pallas (three models).
The Pallas kernels run in interpret mode, in float64, as
tests/test_torch_pairwise.py runs them (no coincident partner reaches them:
they form r as r^2 rsqrt(r^2), NaN at r^2 = 0).  Tolerance rtol 1e-10,
atol 1e-12 (the summation order only).

One whole D = 4 step, in the flagship form, fused + cascade and the
reference order, equals the reference's on its own draws from one burned-in
state: positions within rtol 1e-10, the integer state and the counters
exactly, the statistics within rtol 1e-9.  The kernels against these plain
forms at D = 4 and 5, on the card:
tests/test_torch_cuda.py::test_kernels_at_dims_4_and_5_match_plain.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_bridge import STATE_FIELDS, JaxDraws, assert_step_pair, \
    lattice_paths, other_cfg, small_cfg, tt

from pathintegralgroundstate_torch import sweep as tsweep
from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table
from pathintegralgroundstate_torch.state import state_from_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.ops import cascade_kernels as jcas
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops.pallas_kernels import \
    pair_delta_pallas, pair_pot_pallas, pair_rows_pallas, pair_u_pallas
from pathintegralgroundstate_tpu.state import init_state as j_init_state
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
MODELS = [("aziz2", "mcmillan_c1"), ("soft", "dipolar2d"),
          ("dipolar", "dipolar2d"), ("dipolar", "none"), ("none", "none"),
          ("none", "mcmillan")]
# kernel 5's models: each potential kind with a Jastrow (one Pallas
# compile each; the pair passes above take every model)
CASCADE_MODELS = MODELS[:2] + MODELS[5:]
DIMS = [4, 5]
# densities of a box of about 3.6 sigma at Np=16: D=4 and D=5
DENSITY = {4: 0.1, 5: 0.03}


def _ids(m):
    return "-".join(m)


def _cfg(model, dim, **kw):
    pot, jas = model
    return small_cfg(dim=dim, Np=16, n_walkers=4, density=DENSITY[dim],
                     potential=pot, jastrow=jas, **kw)


def _window(cfg, seed, coincident):
    """(R, xnew, xold, ip [W, B]) numpy float64: whole chains of lattice
    paths and the moved particle per row; with coincident one row's new
    position on a partner."""
    paths = lattice_paths(cfg, seed=seed)
    W, B, N, _ = paths.shape
    rng = np.random.default_rng(seed + 1)
    ip = rng.integers(0, N, (W, B))
    xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
    xnew = xold + 0.1 * rng.normal(size=xold.shape)
    if coincident:
        xnew[1, 2] = paths[1, 2, (ip[1, 2] + 1) % N]
    return paths, xnew, xold, ip


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _systems(cfg):
    jsys = j_make_system(cfg)
    return jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def test_system_takes_every_dim():
    for dim in (1, 4, 5, 7):
        system = make_system(other_cfg(small_cfg(dim=dim)), "cpu")
        assert system.L.shape == (dim,)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_pair_rows_ref_matches_reference(model, dim):
    """Kernel A's raw terms against the Pallas kernel (no coincident
    partner), its weighted rows and walker sums against the jnp form (a
    coincident partner in one row)."""
    cfg = _cfg(model, dim)
    jsys, tab, tsys = _systems(cfg)
    R, xnew, xold, ip = _window(cfg, 3, coincident=False)
    for need_wf in (True, False):
        with pltpu.force_tpu_interpret_mode():
            want = pair_rows_pallas(jsys, *_j(R, xnew, xold),
                                    jnp.asarray(ip, jnp.int32), need_wf)
        got = kernels.pair_terms_ref(tsys, *_t(R, xnew, xold, ip),
                                     need_wf=need_wf)
        for g, w in zip(got[:2 + need_wf], want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    R, xnew, xold, ip = _window(cfg, 4, coincident=True)
    ib = np.arange(cfg.M)
    for need_wf, need_f2 in ((True, True), (False, False)):
        want = np.asarray(jpw.delta_action_rows(
            jsys, tab, *_j(R, xnew, xold, ip, ib), need_wf=need_wf,
            need_f2=need_f2))
        for reduce in (False, True):
            got = kernels.pair_rows_ref(tsys, *_t(R, xnew, xold, ip),
                                        chin_table(tsys), *_t(ib), need_wf,
                                        need_f2, reduce=reduce)
            np.testing.assert_allclose(
                got.numpy(), want.sum(-1) if reduce else want, **TOL)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_pair_pot_ref_matches_reference(model, dim):
    cfg = _cfg(model, dim)
    jsys, tab, tsys = _systems(cfg)
    R = lattice_paths(cfg, seed=7)
    for with_force in (False, True):
        got = kernels.pair_pot_ref(tsys, *_t(R), with_force)
        with pltpu.force_tpu_interpret_mode():
            pallas = pair_pot_pallas(jsys, jnp.asarray(R), with_force)
        for want in (pallas, jpw.pair_pot(jsys, tab, jnp.asarray(R),
                                          with_force)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_dense_forms_match_reference(model, dim):
    """Kernel 3 (raw, with and without force) and kernel 4 against the
    Pallas kernels; the action delta (kernels 3 and 4 in one launch on the
    card) against the jnp delta_action, with a coincident partner."""
    cfg = _cfg(model, dim)
    jsys, tab, tsys = _systems(cfg)
    R, xnew, xold, ip = _window(cfg, 5, coincident=False)
    args_j = _j(R, xnew, xold) + [jnp.asarray(ip, jnp.int32)]
    args_t = _t(R, xnew, xold, ip)
    for with_force in (False, True):
        with pltpu.force_tpu_interpret_mode():
            want = pair_delta_pallas(jsys, *args_j, with_force)
        got = kernels.pair_delta_ref(tsys, *args_t, with_force)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    with pltpu.force_tpu_interpret_mode():
        want = pair_u_pallas(jsys, *args_j)
    np.testing.assert_allclose(kernels.pair_u_ref(tsys, *args_t).numpy(),
                               np.asarray(want), **TOL)
    R, xnew, xold, ip = _window(cfg, 6, coincident=True)
    ib = np.arange(cfg.M)
    for with_force in (False, True):
        dt = cfg.dt
        wf = (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0
        want = jpw.delta_action(jsys, tab, *_j(R, xnew, xold, ip, ib),
                                with_force=with_force)
        got = kernels.pair_delta_ref(tsys, *_t(R, xnew, xold, ip),
                                     with_force, chin_table(tsys), *_t(ib),
                                     wf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["ends", "interior"])
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("model", CASCADE_MODELS, ids=_ids)
def test_cascade_ref_matches_reference(model, dim, mode):
    """cascade_ref (in place on paths) against cascade_pallas in interpret
    mode on the same windows and draws: the same decisions, the same
    written windows."""
    cfg = _cfg(model, dim, fused_sweep=True, cascade=True)
    jsys, tab, tsys = _systems(cfg)
    paths = lattice_paths(cfg, seed=9)
    W, M, D = cfg.n_walkers, cfg.M, cfg.dim
    nlev, L = 2, 4
    slots = ([(0, 1, 3), (M - 1, -1, 3)] if mode == "ends"
             else [(2 + k * L, 1, p) for k, p in enumerate((1, 5))])
    S, G = len(slots), nlev + (mode == "ends")
    rng = np.random.default_rng(11)
    rg, ru = 0.6 * rng.normal(size=(W, S, L + 1, D)), rng.uniform(
        size=(W, S, G))
    act = rng.uniform(size=(W, S)) < 0.8

    def window(b0, step):
        return paths[:, b0:b0 + L + 1] if step > 0 else \
            paths[:, b0 - L:b0 + 1][:, ::-1]

    Rwin = np.stack([window(b0, st) for b0, st, _ in slots], 1)
    ips = jnp.asarray([p for _, _, p in slots], jnp.int32)
    got = torch.from_numpy(paths.copy())
    acc = cas.cascade_ref(tsys, mode, got, slots, tt(rg), tt(ru),
                          torch.from_numpy(act), nlev)
    with pltpu.force_tpu_interpret_mode():
        pallas = jcas.cascade_pallas(jsys, mode, *_j(Rwin, rg, ru), ips,
                                     nlev, jnp.asarray(act))
    want_seg, want_acc = pallas
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    rows = slice(1, L) if mode == "interior" else slice(0, L + 1)
    expect = paths.copy()
    for s, (b0, step, ip) in enumerate(slots):
        beads = b0 + step * np.arange(L + 1)
        expect[:, beads[rows], ip] = np.asarray(want_seg)[:, s, rows]
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


# --- one whole D = 4 step on the reference's draws --------------------------

FORMS = {"flagship": {},
         "fused+cascade": dict(fused_sweep=True, cascade=True),
         "reference order": dict(bis_monoshot=False,
                                 bis_end_random_depth=True)}
NSTEP = 2


def _step_cfg(form):
    return small_cfg(dim=4, density=0.02186, **FORMS[form])


@functools.lru_cache(maxsize=None)
def _jax_step(form):
    """(reference system, its jitted step): one compile per form."""
    jsys = j_make_system(_step_cfg(form))
    return jsys, jax.jit(jsweep.Sweeper(jsys, make_tables(jsys)).step)


@pytest.fixture(scope="module")
def burned():
    """A D = 4 reference state with open and closed walkers."""
    jsys, step = _jax_step("flagship")
    st, stats = j_init_state(jsys), jsweep.zero_stats(jsys)
    for _ in range(150):
        st, stats = step(st, stats)
    nopen = int(np.sum(np.asarray(st.isopen)))
    assert 0 < nopen < jsys.cfg.n_walkers
    return st


@pytest.fixture(scope="module", params=list(FORMS))
def runs(request, burned):
    """(form, reference state and stats after NSTEP steps, port state and
    stats after NSTEP steps on the reference's draws)."""
    jsys, step = _jax_step(request.param)
    st, ref_stats = burned, jsweep.zero_stats(jsys)
    for _ in range(NSTEP):
        st, ref_stats = step(st, ref_stats)
    tsys = make_system(other_cfg(_step_cfg(request.param)), "cpu")
    state = state_from_numpy(tsys, {k: getattr(burned, k)
                                    for k in STATE_FIELDS})
    state, stats = tsweep.run_block(
        tsweep.Sweeper(tsys), state, NSTEP,
        JaxDraws(burned.key, 4, jnp.float64))
    return request.param, st, ref_stats, state, stats


def test_d4_step_matches_reference(runs):
    form, ref, ref_stats, state, stats = runs
    ctr = dict(zip(tsweep.COUNTER_NAMES,
                   assert_step_pair(ref, ref_stats, state, stats, TOL)))
    assert ctr["try_stag"] > 0 and ctr["acc_cm"] > 0, (form, ctr)
    if form == "fused+cascade":
        assert ctr["try_int"] > 0, ctr
