"""Exact Chin F^2 (cfg.exact_f2) in the torch port against the reference.

Float64 on the CPU, the same inputs through the JAX function (its jnp
path: the Pallas kernels are off on the CPU) and the port's:
  * force_field, delta_pot_cached, delta_action_rows' fold branch at both
    fold_sub forms and its brute branch, delta_action_sum with the fold and
    the dense exact delta_action: rtol 1e-10, atol 1e-12;
  * the port's own copies of tests/test_exact_f2.py's gates: the exact dF^2
    is the field difference, twice the partial one at N=2, the cache equals
    the brute form, and the partial form is not conservative;
  * cached == brute trajectories of the port over 3 steps (the fused sweep
    with MALA, the production worm configuration in 'bis' and 'sta'):
    paths rtol 1e-8, atol 1e-10, counters equal;
  * the port's cached exact-F^2 step against the JAX step on the
    reference's own draws (tests/torch_bridge.step_pair) for the flagship,
    the reference order, the fused sweep and the worm phase under staging:
    rtol 1e-10, atol 1e-12, counters equal (the brute form's steps:
    tests/test_torch_exact_f2_brute.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import assert_step_pair, lattice_paths, other_cfg, \
    small_cfg, step_pair

from pathintegralgroundstate_torch.ops import pairwise as tpw
from pathintegralgroundstate_torch.state import init_state, state_to_numpy
from pathintegralgroundstate_torch.sweep import COUNTER_NAMES, Sweeper, \
    run_block
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
IP_FORMS = ("scalar", "walker", "row")


def _systems(**kw):
    cfg = small_cfg(exact_f2=True, **kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ip_t(ip):
    return ip if isinstance(ip, int) else torch.from_numpy(ip)


def _window(cfg, ip_form, seed=0, beads=None):
    """(R, xnew, xold, ip) numpy of a window of whole chains (or of the
    beads `beads`), ip an int, [W] or [W, B]."""
    paths = lattice_paths(cfg, seed=seed)
    if beads is not None:
        paths = paths[:, beads]
    W, B, N, _ = paths.shape
    rng = np.random.default_rng(seed + 1)
    if ip_form == "scalar":
        ip = 3
        xold = paths[:, :, ip]
    elif ip_form == "walker":
        ip = rng.integers(0, N, W)
        xold = paths[np.arange(W), :, ip]
    else:
        ip = rng.integers(0, N, (W, B))
        xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
    xnew = xold + 0.1 * rng.normal(size=xold.shape)
    return paths, xnew, xold, ip


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# The functions, against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", ["pbc", "trap"])
def test_force_field_matches_reference(geometry):
    kw = dict(trap=True, dim=2, a_ho=(1.0, 1.3)) if geometry == "trap" \
        else {}
    cfg, jsys, tables, tsys = _systems(**kw)
    paths = lattice_paths(cfg, seed=2) if geometry == "pbc" else \
        np.random.default_rng(2).normal(size=(cfg.n_walkers, cfg.M, cfg.Np,
                                              cfg.dim))
    want = jpw.force_field(jsys, tables, jnp.asarray(paths[:, 1::2]))
    _close(tpw.force_field(tsys, _t(paths[:, 1::2])), want)


@pytest.mark.parametrize("ip_form", ["scalar", "walker"])
def test_delta_pot_cached_matches_reference(ip_form):
    cfg, jsys, tables, tsys = _systems()
    R, xnew, xold, ip = _window(cfg, ip_form, seed=4)
    fold = np.asarray(jpw.force_field(jsys, tables, jnp.asarray(R)))
    want = jpw.delta_pot_cached(jsys, tables, jnp.asarray(R),
                                jnp.asarray(xnew), jnp.asarray(xold),
                                jnp.asarray(ip), jnp.asarray(fold))
    got = tpw.delta_pot_cached(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                               _t(fold))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fold_sub", [(0, 1), (1, 2)])
@pytest.mark.parametrize("ip_form", IP_FORMS)
@pytest.mark.parametrize("need_wf", [True, False])
def test_fold_rows_match_reference(fold_sub, ip_form, need_wf):
    """The fold branch (dS rows, dfield) at both row subsets: the odd rows
    of a whole chain (1, 2) and a window of odd beads only (0, 1)."""
    cfg, jsys, tables, tsys = _systems()
    beads = np.arange(1, cfg.M - 1, 2) if fold_sub == (0, 1) else None
    R, xnew, xold, ip = _window(cfg, ip_form, seed=5, beads=beads)
    B = R.shape[1]
    ib = beads if beads is not None else np.arange(B)
    r0, s = fold_sub
    fold = np.asarray(jpw.force_field(jsys, tables,
                                      jnp.asarray(R[:, r0::s])))
    want = jpw.delta_action_rows(
        jsys, tables, jnp.asarray(R), jnp.asarray(xnew), jnp.asarray(xold),
        jnp.asarray(ip), jnp.broadcast_to(jnp.asarray(ib), (cfg.n_walkers,
                                                            B)),
        fold=jnp.asarray(fold), fold_sub=fold_sub, need_wf=need_wf)
    got = tpw.delta_action_rows(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                                _t(ib), need_wf=need_wf, fold=_t(fold),
                                fold_sub=fold_sub)
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("ip_form", IP_FORMS)
@pytest.mark.parametrize("rev", [False, True])
def test_brute_rows_match_reference(ip_form, rev):
    """The brute branch (no cache): the whole configurations' F^2
    difference; rev reads the window backwards (the port's tail form)."""
    cfg, jsys, tables, tsys = _systems(f2_cache=False)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=6)
    B = R.shape[1]
    ib = np.arange(B)[::-1].copy() if rev else np.arange(B)
    Rj = R[:, ::-1] if rev else R
    want = jpw.delta_action_rows(
        jsys, tables, jnp.asarray(Rj), jnp.asarray(xnew), jnp.asarray(xold),
        jnp.asarray(ip), jnp.broadcast_to(jnp.asarray(ib),
                                          (cfg.n_walkers, B)))
    got = tpw.delta_action_rows(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                                _t(ib), rev=rev)
    _close(got, want)


def test_delta_action_sum_fold_matches_reference():
    """The summed window delta with the fold and the worm centre's row
    weight 1/2 on row 0."""
    cfg, jsys, tables, tsys = _systems()
    R, xnew, xold, ip = _window(cfg, "walker", seed=7, beads=np.arange(
        cfg.Nb, cfg.Nb + 6))
    rw = np.r_[0.5, np.ones(5)]
    ib = np.arange(cfg.Nb, cfg.Nb + 6)
    fold = np.asarray(jpw.force_field(jsys, tables, jnp.asarray(R[:, 1::2])))
    want = jpw.delta_action_sum(
        jsys, tables, jnp.asarray(R), jnp.asarray(xnew), jnp.asarray(xold),
        jnp.asarray(ip), jnp.broadcast_to(jnp.asarray(ib), (cfg.n_walkers,
                                                            6)),
        fold=jnp.asarray(fold), fold_sub=(1, 2), row_weights=jnp.asarray(rw))
    got = tpw.delta_action_sum(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                               _t(ib), row_weights=_t(rw), fold=_t(fold),
                               fold_sub=(1, 2))
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("with_force", [True, False])
def test_dense_exact_delta_action_matches_reference(with_force):
    """The dense delta_action under exact F^2: kernel 3's raw dPot, kernel
    B's F^2 difference and kernel 4's u, weighted here (their plain forms
    on the CPU); without force the one-launch action mode."""
    cfg, jsys, tables, tsys = _systems(f2_cache=False)
    R, xnew, xold, ip = _window(cfg, "walker", seed=8)
    ib = np.arange(cfg.M)
    want = jpw.delta_action(jsys, tables, jnp.asarray(R), jnp.asarray(xnew),
                            jnp.asarray(xold), jnp.asarray(ip),
                            jnp.asarray(ib), with_force=with_force)
    got = tpw.delta_action(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                           _t(ib), with_force=with_force)
    _close(got, want)
    dpot_w, df2_w = jpw.delta_pot(jsys, tables, jnp.asarray(R),
                                  jnp.asarray(xnew), jnp.asarray(xold),
                                  jnp.asarray(ip))
    dpot, df2 = tpw.delta_pot(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip))
    _close(dpot, dpot_w)
    _close(df2, df2_w)


# ---------------------------------------------------------------------------
# tests/test_exact_f2.py's gates, on the port
# ---------------------------------------------------------------------------

def _he4(Np=8, exact=True, seed=0):
    """test_exact_f2._mk on the port: one jittered-lattice configuration
    [W=1, B=1, N, D] in a box at density 0.3."""
    from pathintegralgroundstate_torch.config import SimConfig
    cfg = SimConfig(dim=3, Np=Np, density=0.3, dt=5e-3, Nb=4, Rm=1.2,
                    dtype="float64", potential="aziz2", n_walkers=1,
                    exact_f2=exact)
    system = make_system(cfg, "cpu")
    L = system.geo.Lbox[0]
    n = int(np.ceil(Np ** (1 / 3)))
    grid = (np.stack(np.meshgrid(*[np.arange(n)] * 3), -1)
            .reshape(-1, 3)[:Np] + 0.5) / n * L - L / 2
    R = grid + 0.05 * np.random.default_rng(seed).normal(size=(Np, 3))
    return system, _t(R[None, None])


def _df2(system, R, xnew, xold, ip):
    return float(tpw.delta_pot(system, R, xnew, xold, ip)[1][0, 0])


def _moved(R, ip, x):
    R = R.clone()
    R[:, :, ip] = x
    return R


def test_exact_f2_equals_field_difference():
    system, R = _he4()
    xold = R[:, :, 3]
    xnew = xold + 0.11
    got = _df2(system, R, xnew, xold, 3)
    f2n = tpw.pair_pot(system, _moved(R, 3, xnew), True)[1]
    f2o = tpw.pair_pot(system, R, True)[1]
    np.testing.assert_allclose(got, float((f2n - f2o)[0, 0]), rtol=1e-10)


def test_exact_f2_n2_is_twice_partial():
    """N=2, pure pair forces: F_2 = -F_1, so the exact delta of
    sum_i |F_i|^2 is twice the reference's moved-particle delta."""
    sys_p, R = _he4(Np=2, exact=False)
    sys_e, _ = _he4(Np=2, exact=True)
    xold = R[:, :, 0]
    xnew = xold + 0.07
    d_partial = _df2(sys_p, R, xnew, xold, 0)
    d_exact = _df2(sys_e, R, xnew, xold, 0)
    assert abs(d_partial) > 1e-12
    np.testing.assert_allclose(d_exact, 2.0 * d_partial, rtol=1e-10)


def test_cached_matches_brute_exact():
    """delta_pot_cached == the brute field difference, and fold + dfield is
    the new field."""
    system, R = _he4(seed=4)
    R3 = torch.cat([R, R + 0.01, R - 0.02], 1)
    ip = 5
    xold = R3[:, :, ip]
    xnew = xold + torch.tensor([[0.08, -0.03, 0.05], [-0.06, 0.04, 0.02],
                                [0.03, 0.07, -0.04]], dtype=R.dtype)[None]
    dpot_b, df2_b = tpw.delta_pot(system, R3, xnew, xold, ip)
    fold = tpw.force_field(system, R3)
    dpot_c, df2_c, dfield = tpw.delta_pot_cached(system, R3, xnew, xold, ip,
                                                 fold)
    np.testing.assert_allclose(dpot_c.numpy(), dpot_b.numpy(), rtol=1e-12)
    np.testing.assert_allclose(df2_c.numpy(), df2_b.numpy(), rtol=1e-9)
    np.testing.assert_allclose(
        (fold + dfield).numpy(),
        tpw.force_field(system, _moved(R3, ip, xnew)).numpy(), rtol=1e-9,
        atol=1e-12)


def test_partial_f2_is_not_conservative_exact_is():
    """dF^2 around a closed cycle of single-particle moves: zero for the
    exact form, not for the reference's partial one."""
    d0 = torch.tensor([0.09, -0.04, 0.06], dtype=torch.float64)
    d1 = torch.tensor([-0.05, 0.08, 0.03], dtype=torch.float64)

    def cycle(exact):
        system, R = _he4(exact=exact, seed=2)
        total = 0.0
        for ip, d in ((0, d0), (1, d1), (0, -d0), (1, -d1)):
            x = R[:, :, ip]
            total += _df2(system, R, x + d, x, ip)
            R = _moved(R, ip, x + d)
        return total

    assert abs(cycle(True)) < 1e-9
    assert abs(cycle(False)) > 1e-6


# ---------------------------------------------------------------------------
# cached == brute trajectories of the port
# ---------------------------------------------------------------------------

def _port_run(cfg, nstep=3):
    system = make_system(cfg, "cpu")
    state, stats = run_block(Sweeper(system), init_state(system), nstep)
    return state_to_numpy(state), stats.counters.numpy()


@pytest.mark.parametrize("form", ["fused+mala", "worm bis", "worm sta"])
def test_cached_trajectory_matches_brute(form):
    """tests/test_exact_f2.py:100-165 on the port's own draws: the fused
    sweep with MALA, and the production configuration (the unfused sweep
    with the worm phase) in 'bis' and 'sta'."""
    from pathintegralgroundstate_torch.config import SimConfig
    if form == "fused+mala":
        base = dict(Nb=8, sampling="bis", Nlev=2, Nstag=2, CMFreq=1,
                    delta_cm=0.1, swapping=False, CWorm=0.0, Nobdm=0,
                    n_walkers=4, smart_mc=0.05)
    else:
        base = dict(Nb=8, sampling=form.split()[1], Nlev=2, Lstag=4, Nstag=2,
                    CMFreq=1, delta_cm=0.1, swapping=True, CWorm=0.5,
                    Nobdm=2, n_walkers=8, fused_sweep=False)
    outs = [_port_run(SimConfig(dim=3, Np=6, density=0.3, dt=5e-3, Rm=1.2,
                                dtype="float64", potential="aziz2",
                                exact_f2=True, f2_cache=cache, seed=3,
                                Nstep=3, **base))
            for cache in (True, False)]
    (s_c, c_c), (s_b, c_b) = outs
    for k in ("paths", "xend"):
        np.testing.assert_allclose(s_c[k], s_b[k], rtol=1e-8, atol=1e-10,
                                   err_msg=k)
    np.testing.assert_array_equal(c_c, c_b)
    c = dict(zip(COUNTER_NAMES, c_c))
    assert c["acc_cm"] > 0 and c["acc_bd"] > 0
    if form == "fused+mala":
        assert c["try_mala"] > 0
    else:
        assert c["try_open"] > 0


# ---------------------------------------------------------------------------
# The cached exact-F^2 step against the reference step on its own draws
# (the brute form's: tests/test_torch_exact_f2_brute.py)
# ---------------------------------------------------------------------------

FORMS = {
    "flagship": {},
    "reference order": dict(bis_monoshot=False, bis_end_random_depth=True,
                            Nlev=3),
    "fused": dict(fused_sweep=True),
    "worm sta": dict(sampling="sta"),
}


def check_step(form, cache):
    """The port's step against the JAX step from one burned-in state on
    the reference's draws: states, counters and statistics equal."""
    counters = assert_step_pair(
        *step_pair(small_cfg(exact_f2=True, f2_cache=cache, **FORMS[form]),
                   nstep=2),
        TOL)
    c = dict(zip(COUNTER_NAMES, counters))
    assert c["try_cm"] > 0 and c["try_cm_half"] > 0 and c["try_swap"] > 0


@pytest.mark.parametrize("form", list(FORMS))
def test_cached_step_matches_reference(form):
    check_step(form, True)
