"""The harmonic-trap geometry of the torch port against the reference.

Under the trap there is no minimum image and no pair cutoff, and every pair
pass adds the trap's one-body terms; the reference routes the trap away
from every Pallas kernel, so its jnp branches are the reference here.
Float64 on the CPU, rtol 1e-10 / atol 1e-12 (reassociation only),
histograms and accept masks exactly equal:

  * the plain forms (kernel A's rows and walker sums, the dense
    delta_pot / delta_wf / delta_action, pair_pot, the cascade composites)
    and the estimators (local_energy, therm_energy, obdm_terms,
    density_map) at dim 1, 2 and 3, for the potentials aziz2 and 'none'
    and the Jastrows mcmillan_c1 (not C1-shifted under the trap) and
    'none', on paths drawn around the trap's centre;
  * one whole step of the trapped worm form (staging, worm, swaps, the
    density map; dim 2) and of a fused bisection form with cascades
    (dim 3, aziz2) against the reference's step on its own draws;
  * the Driver over 2 blocks of the trapped worm form, file by file equal
    to the JAX Driver (density_vpi.out included);
  * the 1-D harmonic oscillator with its exact trial WF through the torch
    CLI: E = 0.5 +/- 0 exactly.
"""

import contextlib
import io
import math
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import STATE_FIELDS, JaxDraws, assert_step_pair, \
    other_cfg, step_pair, tt

from pathintegralgroundstate_torch import cli
from pathintegralgroundstate_torch import driver as tdriver
from pathintegralgroundstate_torch.flagship import trap_worm_cfg
from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.ops import estimators as est
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops import worm as wm
from pathintegralgroundstate_torch.ops.pairwise import delta_action, \
    delta_action_rows, delta_action_sum, delta_pot, delta_wf, pair_pot
from pathintegralgroundstate_torch.state import init_state, state_from_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import driver as jdriver
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.config import SimConfig
from pathintegralgroundstate_tpu.ops import cascade_kernels as jcas
from pathintegralgroundstate_tpu.ops import estimators as jest
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops import worm as jwm
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
MODELS = [(d, p, j) for d in (1, 2, 3) for p in ("aziz2", "none")
          for j in ("mcmillan_c1", "none")]


def _ids(m):
    return f"dim{m[0]}-{m[1]}-{m[2]}"


def trap_cfg(**kw):
    """A small trapped system in float64 (the reference's SimConfig)."""
    base = dict(dim=3, Np=6, trap=True, dt=0.02, Nb=8, sampling="bis",
                Lstag=4, Nlev=2, Nstag=1, CMFreq=1, delta_cm=0.3, Rm=1.2,
                swapping=True, CWorm=0.5, Nobdm=2, Npw=1, Nbin=40,
                n_walkers=4, dtype="float64", potential="aziz2",
                jastrow="mcmillan_c1", fused_sweep=False, exact_f2=False)
    base.update(kw)
    return SimConfig(**base)


def trap_paths(cfg, seed=0):
    """Worldlines [W, M, N, D] around the trap's centre: particles 1.3
    apart on a line (1-D) or on a ring of radius 1.2 (2-D and 3-D, the
    third axis alternating by +-0.6), each walker's jittered by 0.1, plus
    0.05 of noise per bead; numpy float64."""
    rng = np.random.default_rng(seed)
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    if D == 1:
        base = (np.arange(N) - 0.5 * (N - 1)) * 1.3
        base = base[:, None]
    else:
        ang = 2.0 * np.pi * np.arange(N) / N
        base = np.zeros((N, D))
        base[:, 0], base[:, 1] = 1.2 * np.cos(ang), 1.2 * np.sin(ang)
        if D == 3:
            base[:, 2] = 0.6 * (-1.0) ** np.arange(N)
    x = (base[None, None] + 0.1 * rng.normal(size=(W, 1, N, D))
         + 0.05 * rng.normal(size=(W, M, N, D)))
    return x


def _systems(dim, potential, jastrow, **kw):
    cfg = trap_cfg(dim=dim, potential=potential, jastrow=jastrow, **kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _window(cfg, seed, coincident):
    """(R, xnew, xold, ip [W]) numpy over the whole chain; with coincident,
    one row's xnew sits exactly on a partner (the worm pin)."""
    paths = trap_paths(cfg, seed)
    W, M, N, D = paths.shape
    rng = np.random.default_rng(seed + 1)
    ip = rng.integers(0, N, W)
    xold = paths[np.arange(W), :, ip]
    xnew = xold + 0.2 * rng.normal(size=xold.shape)
    if coincident:
        xnew[1, 2] = paths[1, 2, (ip[1] + 1) % N]
    return paths, xnew, xold, ip


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# System and models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_trap_system_matches_reference_models(model):
    """The trap builds at every dim and model; u, u', u'' equal the
    reference's, and mcmillan_c1 carries no C1 shift under the trap."""
    cfg, jsys, _, tsys = _systems(*model)
    assert not tsys.pbc and tsys.c1 is False and tsys.u_rc == 0.0
    r = np.linspace(0.3, 4.0, 17)
    for f in ("u", "du", "d2u"):
        _close(getattr(tsys, f)(_t(r)).numpy(), getattr(jsys, f)(
            jnp.asarray(r)))
    v = tsys.potential.v_dv(_t(r), 1.0 / _t(r))
    jv = jsys.potential.v_dv(jnp.asarray(r))
    for g, w in zip(v, jv):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# The plain pair forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_trap_rows_match_reference(model):
    """Kernel A's plain form, rows (need_wf/need_f2 on and off) and the
    walker sums with the worm centre's 1/2 over a reversed window, with a
    coincident partner."""
    cfg, jsys, tables, tsys = _systems(*model)
    R, xnew, xold, ip = _window(cfg, seed=1, coincident=True)
    ib = np.arange(cfg.M)
    args = [jnp.asarray(a) for a in (R, xnew, xold, ip, ib)]
    for need_wf, need_f2 in ((True, True), (False, False), (True, False)):
        want = jpw.delta_action_rows(jsys, tables, *args, need_wf=need_wf,
                                     need_f2=need_f2)
        got = delta_action_rows(tsys, _t(R), _t(xnew), _t(xold), _t(ip),
                                _t(ib), need_wf=need_wf, need_f2=need_f2)
        assert np.isfinite(got.numpy()).all()
        _close(got.numpy(), want)
    B = 6
    rw = np.r_[0.5, np.ones(B - 1)]
    Rf, xn, xo, ibr = R[:, 1:1 + B], xnew[:, :B], xold[:, :B], ib[B:0:-1]
    want = jpw.delta_action_sum(jsys, tables, jnp.asarray(Rf[:, ::-1]),
                                jnp.asarray(xn), jnp.asarray(xo),
                                jnp.asarray(ip), jnp.asarray(ibr),
                                row_weights=jnp.asarray(rw))
    got = delta_action_sum(tsys, _t(Rf), _t(xn), _t(xo), _t(ip), _t(ibr),
                           row_weights=_t(rw), rev=True)
    _close(got.numpy(), want)


@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_trap_dense_forms_match_reference(model):
    """The dense delta_pot (with and without force), delta_wf and
    delta_action (kernels 3 and 4's plain forms) on every kind of row."""
    cfg, jsys, tables, tsys = _systems(*model)
    R, xnew, xold, ip = _window(cfg, seed=2, coincident=False)
    ib = np.arange(cfg.M)
    args = [jnp.asarray(a) for a in (R, xnew, xold, ip)]
    targs = (tsys, _t(R), _t(xnew), _t(xold), _t(ip))
    for wf in (True, False):
        for g, w in zip(delta_pot(*targs, wf), jpw.delta_pot(
                jsys, tables, *args, wf)):
            _close(g.numpy(), w)
        _close(delta_action(*targs, _t(ib), wf).numpy(), jpw.delta_action(
            jsys, tables, *args, jnp.asarray(ib), wf))
    _close(delta_wf(*targs).numpy(), jpw.delta_wf(jsys, tables, *args))


@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_trap_pair_pot_matches_reference(model):
    cfg, jsys, tables, tsys = _systems(*model)
    R = trap_paths(cfg, seed=3)
    for wf in (False, True):
        got = pair_pot(tsys, _t(R), wf)
        want = jpw.pair_pot(jsys, tables, jnp.asarray(R), wf)
        for g, w in zip(got, want):
            _close(g.numpy(), w)


@pytest.mark.parametrize("mode", ["ends", "interior", "rigid"])
@pytest.mark.parametrize("dim", [1, 2, 3])
def test_trap_cascade_matches_cascade_jnp(dim, mode):
    """cascade_ref (the trap's route of every cascade mode) against the
    reference's cascade_jnp, whose trap branch has no wrap."""
    cfg, jsys, tables, tsys = _systems(dim, "aziz2", "mcmillan_c1",
                                       n_walkers=8, Nb=16)
    paths = trap_paths(cfg, seed=4)
    W, M, D = cfg.n_walkers, cfg.M, cfg.dim
    nlev = 0 if mode == "rigid" else 2
    L = M - 1 if mode == "rigid" else 2 ** nlev
    slots = {"ends": [(0, 1, 2), (M - 1, -1, 2)],
             "interior": [(2 + k * L, 1, p) for k, p in enumerate((1, 3, 5))],
             "rigid": [(0, 1, 2)]}[mode]
    S = len(slots)
    G = {"ends": nlev + 1, "interior": nlev, "rigid": 1}[mode]
    rng = np.random.default_rng(5 + dim)
    rg = 2.0 * rng.normal(size=(W, S, L + 1, D))
    if mode == "rigid":
        rg[:, :, 1:] = 0.0
        rg[:, :, 0] = 0.3 * rng.uniform(-1, 1, size=(W, S, D))
    ru = rng.uniform(size=(W, S, G))
    act = np.ones((W, S), bool)
    act[1, -1] = act[5, 0] = False

    def window(b0, step):
        return paths[:, b0:b0 + L + 1] if step > 0 else \
            paths[:, b0 - L:b0 + 1][:, ::-1]

    Rwin = np.stack([window(b0, st) for b0, st, _ in slots], 1)
    ips = jnp.asarray([p for _, _, p in slots], jnp.int32)
    want_seg, want_acc = jcas.cascade_jnp(
        jsys, tables, mode, jnp.asarray(Rwin), jnp.asarray(rg),
        jnp.asarray(ru), ips, nlev, jnp.asarray(act))
    got = torch.from_numpy(paths.copy())
    acc = cas._dispatch(tsys, mode, got, slots, tt(rg), tt(ru),
                        torch.from_numpy(act), nlev)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    assert 0 < int(acc.sum()) < int(act.sum())
    want_seg = np.asarray(want_seg)
    rows = slice(1, L) if mode == "interior" else slice(0, L + 1)
    expect = paths.copy()
    for s, (b0, step, ip) in enumerate(slots):
        beads = b0 + step * np.arange(L + 1)
        expect[:, beads[rows], ip] = want_seg[:, s, rows]
    _close(got.numpy(), expect)


def test_trap_routes_every_wrapper_to_its_plain_form():
    """The route predicates (rows_route, cascade_route, pair_route) are
    false under the trap and true under PBC; under the trap each wrapper
    returns its plain form and counts no launch (on the card too:
    tests/test_torch_cuda.py)."""
    cfg, _, _, tsys = _systems(2, "aziz2", "mcmillan_c1")
    pbc = make_system(other_cfg(trap_cfg(trap=False, density=0.3)), "cpu")
    routes = (kernels.rows_route, kernels.cascade_route, kernels.pair_route)
    assert not any(f(tsys) for f in routes) and all(f(pbc) for f in routes)
    R, xnew, xold, ip = _window(cfg, seed=6, coincident=False)
    counts = [f.launches for f in (kernels.pair_rows, kernels.pair_pot,
                                   kernels.pair_delta, kernels.pair_u,
                                   kernels.cascade)]
    ib = torch.arange(cfg.M)
    from pathintegralgroundstate_torch.ops.pairwise import chin_table
    got = kernels.pair_rows(tsys, _t(R), _t(xnew), _t(xold), _t(ip),
                            chin_table(tsys), ib)
    assert torch.equal(got, kernels.pair_rows_ref(
        tsys, _t(R), _t(xnew), _t(xold), _t(ip), chin_table(tsys), ib))
    kernels.pair_pot(tsys, _t(R), True)
    kernels.pair_delta(tsys, _t(R), _t(xnew), _t(xold), _t(ip))
    kernels.pair_u(tsys, _t(R), _t(xnew), _t(xold), _t(ip))
    assert counts == [f.launches for f in (
        kernels.pair_rows, kernels.pair_pot, kernels.pair_delta,
        kernels.pair_u, kernels.cascade)]


# ---------------------------------------------------------------------------
# Estimators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_trap_energies_match_reference(model):
    """local_energy at both chain ends (the halved trap Laplacian kept) and
    therm_energy (the whole spring r^2, no rcut gate)."""
    cfg, jsys, tables, tsys = _systems(*model)
    paths = trap_paths(cfg, seed=7)
    for bead in (0, -1):
        R = paths[:, bead]
        want = jax.vmap(partial(jest.local_energy, jsys, tables))(
            jnp.asarray(R))
        for g, w in zip(est.local_energy(tsys, _t(R)), want):
            _close(g.numpy(), w)
    want = jest.therm_energy(jsys, tables, jnp.asarray(paths))
    for g, w in zip(est.therm_energy(tsys, _t(paths)), want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_trap_obdm_and_density_map_match_reference(dim):
    """obdm_terms without the minimum image, and the density map (bins and
    drops exactly equal, walkers weighted as the sweep weights them)."""
    cfg, jsys, tables, tsys = _systems(dim, "none", "none", n_walkers=16,
                                       Npw=2)
    rng = np.random.default_rng(8 + dim)
    rc = jsys.geo.rcut
    xend = rng.normal(scale=2.0, size=(cfg.n_walkers, 2, dim))
    want = jwm.obdm_terms(jsys, jnp.asarray(xend))
    got = wm.obdm_terms(tsys, _t(xend))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    R = rng.normal(scale=0.2 * rc, size=(cfg.n_walkers, cfg.Np, dim))
    R[1, 0, 0] = 0.6 * rc                         # off the grid: dropped
    weight = (np.arange(cfg.n_walkers) % 3 != 0).astype(np.float64)
    dn = jax.vmap(partial(jest.density_map, jsys))(jnp.asarray(R))
    want = np.sum(np.asarray(dn) * weight[:, None, None], axis=0)
    got = est.density_map(tsys, _t(R), _t(weight))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < weight.sum() * cfg.Np


# ---------------------------------------------------------------------------
# Whole steps and the Driver
# ---------------------------------------------------------------------------

NBLOCK = 2
OUTPUTS = ("e_vpi.out", "et_vpi.out", "nr_vpi.out", "density_vpi.out",
           "perm_histogram.out")


def worm_cfg(**kw):
    """The trapped worm flagship's form (flagship.trap_worm_cfg: dim 2,
    ideal bosons, staging, worm with swaps, the density map) at W=16, 2
    blocks of 2 steps: the reference's SimConfig."""
    base = dict(n_walkers=16, Nstep=2, Nblock=NBLOCK)
    base.update(kw)
    return other_cfg(trap_worm_cfg().replace(**base))




@pytest.fixture(scope="module")
def worm_runs(tmp_path_factory):
    """The trapped worm form: one JAX Driver, its jitted step burning a
    state in (until some walkers are open and some closed), then from that
    state 2 steps of the reference and of the port on the reference's
    draws, and both Drivers over NBLOCK blocks (the reference's block a
    loop over the same jitted step: one JAX compile)."""
    cfg = worm_cfg()
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("torch"))
    jdrv = jdriver.Driver(cfg, out_dir=jdir, verbose=False)
    step = jax.jit(jdrv.sweeper.step)
    st = jdrv.state
    stats = jsweep.zero_stats(jdrv.system)
    for _ in range(60):
        st, stats = step(st, stats)
    burned = st
    nopen = int(np.sum(np.asarray(burned.isopen)))
    assert 0 < nopen < cfg.n_walkers, nopen

    ref, ref_stats = burned, jsweep.zero_stats(jdrv.system)
    for _ in range(2):
        ref, ref_stats = step(ref, ref_stats)
    from pathintegralgroundstate_torch import sweep as tsweep
    tsys = make_system(other_cfg(cfg), "cpu")
    state = state_from_numpy(tsys, {k: getattr(burned, k)
                                    for k in STATE_FIELDS})
    state, stats_t = tsweep.run_block(tsweep.Sweeper(tsys), state, 2,
                                      JaxDraws(burned.key, cfg.dim,
                                               jnp.float64))

    def block(s):
        acc = jsweep.zero_stats(jdrv.system)
        for _ in range(cfg.Nstep):
            s, acc = step(s, acc)
        return s, acc

    jdrv._block_fn = block
    jdrv.state = burned
    jdrv.run()
    tdrv = tdriver.Driver(other_cfg(cfg), out_dir=tdir, device="cpu",
                          verbose=False,
                          draws=JaxDraws(burned.key, cfg.dim, jnp.float64))
    tdrv.state = state_from_numpy(tdrv.system, {k: getattr(burned, k)
                                                for k in STATE_FIELDS})
    tdrv.run()
    return dict(step=(ref, ref_stats, state, stats_t), dirs=(jdir, tdir),
                drivers=(jdrv, tdrv))


def test_trap_worm_step_matches_reference(worm_runs):
    ctr = assert_step_pair(*worm_runs["step"],
                           dict(rtol=1e-10, atol=1e-12))
    from pathintegralgroundstate_torch.sweep import COUNTER_NAMES
    c = dict(zip(COUNTER_NAMES, ctr))
    assert c["try_cm"] > 0 and c["try_swap"] > 0 and c["try_cm_half"] > 0
    dens = worm_runs["step"][3].dens
    assert dens.shape == (150, 150) and float(dens.sum()) > 0
    assert not worm_runs["step"][3].gr.any()


@pytest.mark.parametrize("name", OUTPUTS)
def test_trap_worm_driver_file_matches_reference(worm_runs, name):
    jdir, tdir = worm_runs["dirs"]
    want = np.loadtxt(os.path.join(jdir, name))
    got = np.loadtxt(os.path.join(tdir, name))
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12,
                               err_msg=name)


def test_trap_worm_driver_writes_no_pbc_profiles(worm_runs):
    """No g(r) or S(k) under the trap, in either package; the density map
    in PrintDensity's layout (a blank line after each row of x) and the
    final results equal."""
    jdrv, tdrv = worm_runs["drivers"]
    for d in worm_runs["dirs"]:
        names = set(os.listdir(d))
        assert not names & {"gr_vpi.out", "sk_vpi.out"}
    with open(os.path.join(worm_runs["dirs"][1], "density_vpi.out")) as f:
        assert f.read().count("\n\n") == 150
    assert set(tdrv.final) == set(jdrv.final) and tdrv.final
    for k, w in jdrv.final.items():
        assert math.isclose(tdrv.final[k], w, rel_tol=1e-9, abs_tol=1e-12), k
    assert tdrv.final["E"] == 1.0


def test_trap_fused_bisection_step_matches_reference():
    """The fused bisection sweep with both cascades at dim 3 with aziz2 and
    mcmillan_c1 in the trap (a_ho = 1.5, where a worm opens within the
    burn-in), on the reference's draws."""
    cfg = trap_cfg(n_walkers=8, Nb=16, Np=4, fused_sweep=True, cascade=True,
                   Nstag=1, a_ho=(1.5, 1.5, 1.5))
    ctr = assert_step_pair(*step_pair(cfg, nstep=2, nburn=120),
                           dict(rtol=1e-10, atol=1e-12))
    from pathintegralgroundstate_torch.sweep import COUNTER_NAMES
    c = dict(zip(COUNTER_NAMES, ctr))
    assert c["try_int"] > 0 and c["acc_bd"] > 0 and c["acc_head"] > 0


def test_trap_init_state_is_in_the_trap():
    """Particles start uniform in [-a_ho, a_ho] per axis, the same slice on
    every bead."""
    cfg = other_cfg(worm_cfg(a_ho=(1.0, 2.0), n_walkers=256))
    st = init_state(make_system(cfg, "cpu"))
    x = st.paths[:, 0]
    assert torch.equal(st.paths, st.paths[:, :1].expand_as(st.paths))
    for k, a in enumerate(cfg.a_ho):
        assert float(x[..., k].abs().max()) <= a
        assert float(x[..., k].abs().max()) > 0.9 * a


HO_IN = """&system
 dim = 1, Np = 1, trap = T /
&samp
 resume = F, dt = 0.05d0, Nb = 8, seed = 1982, delta_cm = 0.5d0, CMFreq = 1,
 sampling = 'sta', Lstag = 8, Nlev = 2, Nstag = 2, Nblock = 2, Nstep = 10,
 Nbin = 50, Nk = 10 /
&obdm
 swapping = F, CWorm = 0.d0, Nobdm = 0, Npw = 0 /
&wavefun
 Nmax = 1000, wf_table = F, v_table = F /
&jastrow
 Rm = 1.20d0 /
&extpot
 a_ho = 1.0d0 /
&tpu
 n_walkers = 16, dtype = 'float64', potential = 'none' /
"""


def test_harmonic_oscillator_cli_gives_the_exact_energy(tmp_path,
                                                        monkeypatch):
    """The 1-D oscillator of the verify recipe through the torch CLI on the
    CPU: every block prints <E> = 0.5 +/- 0, and e_vpi.out holds 0.5."""
    monkeypatch.setenv("PIGS_PLATFORM", "cpu")
    nml = tmp_path / "ho.in"
    nml.write_text(HO_IN)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli.main([str(nml), "-o", str(tmp_path / "out")]) == 0
    log = out.getvalue()
    assert log.count("<E>  =  0.5 +/- 0\n") == 2, log
    e = np.loadtxt(tmp_path / "out" / "e_vpi.out", ndmin=2)
    np.testing.assert_array_equal(e[:, 1], [0.5, 0.5])
