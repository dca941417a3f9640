"""The model variants of the torch port against the reference, float64 (and
float32 where stated) on the CPU.

The soft, dipolar and ideal-gas potentials and the dipolar2d Jastrow
(models/, System.u_closed / du_closed / d2u_closed), the plain forms of the
five kernels for each pair model (kernels.pair_rows_ref, pair_pot_ref,
pair_delta_ref, pair_u_ref, cascade.cascade_ref against the reference's jnp
delta_action_rows, pair_pot, delta_pot, delta_wf, delta_action and
cascade_jnp), one whole step of a small 2-D dipolar gas and of a small ideal
Bose gas under PBC on the reference's own draws, and a dipolar Driver run
over 2 blocks.  Elementwise forms: rtol 1e-12 in float64, 2e-6 in float32;
pair sums: rtol 1e-10, atol 1e-12 (reassociation only).  The kernels
against these plain forms: chip_smoke.py's [variants] phase, on the card.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import STATE_FIELDS, JaxDraws, assert_step_pair, \
    lattice_paths, other_cfg, small_cfg, step_pair, tt

from pathintegralgroundstate_torch import driver as tdriver
from pathintegralgroundstate_torch import sweep as tsweep
from pathintegralgroundstate_torch.flagship import dipolar_cfg
from pathintegralgroundstate_torch.models import jastrow as tjas
from pathintegralgroundstate_torch.models.potentials import get_potential
from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table
from pathintegralgroundstate_torch.state import state_from_numpy
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu import driver as jdriver
from pathintegralgroundstate_tpu import sweep as jsweep
from pathintegralgroundstate_tpu.models import potentials as jpot
from pathintegralgroundstate_tpu.ops import cascade_kernels as jcas
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
POTENTIALS = ["aziz2", "aziz1", "soft", "dipolar", "none"]
JASTROWS = ["mcmillan", "mcmillan_c1", "dipolar2d", "none"]
# the pair models of the kernel forms: every potential and every Jastrow
MODELS = [("aziz2", "dipolar2d"), ("soft", "mcmillan_c1"),
          ("dipolar", "dipolar2d"), ("dipolar", "none"), ("none", "none"),
          ("none", "mcmillan")]
ELEM = {np.float64: dict(rtol=1e-12, atol=0.0),
        np.float32: dict(rtol=2e-6, atol=0.0)}


def _ids(m):
    return "-".join(m)


def _radii(dtype):
    return np.r_[np.linspace(0.3, 3.0, 41), 0.05, 0.9, 1.7].astype(dtype)


# --- the elementwise forms --------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name", POTENTIALS)
def test_potential_matches_reference(name, dtype):
    r = _radii(dtype)
    want, got = jpot.get_potential(name), get_potential(name)
    rt = torch.from_numpy(r)
    for fn in ("v", "dvdr"):
        np.testing.assert_allclose(getattr(got, fn)(rt).numpy(),
                                   np.asarray(getattr(want, fn)(jnp.asarray(r))),
                                   **ELEM[dtype], err_msg=fn)
    rinv = 1.0 / r
    try:
        wv = want.v_dv(jnp.asarray(r), jnp.asarray(rinv))
    except TypeError:                 # the reference's non-Aziz signature
        wv = want.v_dv(jnp.asarray(r))
    gv = got.v_dv(rt, torch.from_numpy(rinv))
    for g, w in zip(gv, wv):
        assert g.dtype == rt.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **ELEM[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("trap", [False, True])
@pytest.mark.parametrize("jastrow", JASTROWS)
def test_jastrow_matches_reference(jastrow, trap, dtype):
    """System.u_closed, du_closed and d2u_closed against the reference
    System's u, du and d2u, with the C1 shift at rcut under PBC.  In
    float32 the shift cancels u to well below its terms (about 1.4 at
    r = 0.3): atol 1e-6, a few of their ulps."""
    kw = dict(trap=True, a_ho=(1.0, 1.0, 1.0)) if trap else {}
    cfg = small_cfg(jastrow=jastrow, dtype=dtype, **kw)
    jsys = j_make_system(cfg)
    tsys = make_system(other_cfg(cfg), "cpu")
    npdt = np.float64 if dtype == "float64" else np.float32
    r = _radii(npdt)
    for jfn, tfn in ((jsys.u, tsys.u_closed), (jsys.du, tsys.du_closed),
                     (jsys.d2u, tsys.d2u_closed)):
        want = np.asarray(jfn(jnp.asarray(r)))
        got = tfn(torch.from_numpy(r))
        assert got.dtype == torch.from_numpy(r).dtype
        np.testing.assert_allclose(got.numpy(), want, rtol=ELEM[npdt]["rtol"],
                                   atol=0.0 if npdt == np.float64 else 1e-6)
    assert tsys.c1 == (not trap and jastrow in ("mcmillan_c1", "dipolar2d"))


def test_dipolar_jastrow_cancels_core():
    """tests/test_dipolar.py's check on the port: |u'|^2 == Rm/r^3 cancels
    the dipolar potential's divergence in the local energy (Rm = Cdd),
    u'' + u'/r = -1/2 sqrt(Rm) r^-5/2, and u' is u's derivative."""
    r = torch.tensor([0.03, 0.1, 0.5, 1.7], dtype=torch.float64)
    Rm = 1.0
    du, d2u = tjas.dipolar_du(Rm, r), tjas.dipolar_d2u(Rm, r)
    np.testing.assert_allclose((du ** 2).numpy(), (Rm / r ** 3).numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose((d2u + du / r).numpy(),
                               -0.5 * np.sqrt(Rm) * r.numpy() ** -2.5,
                               rtol=1e-12)
    h = 1e-6
    fd = (tjas.dipolar_u(Rm, r + h) - tjas.dipolar_u(Rm, r - h)) / (2 * h)
    np.testing.assert_allclose(du.numpy(), fd.numpy(), rtol=1e-6)


# --- the plain forms of the kernels, per pair model --------------------------

def _model_cfg(model, dim=3, **kw):
    pot, jas = model
    if dim == 2:
        kw = dict(dict(density=0.26, Np=8, n_walkers=4), **kw)
    return small_cfg(dim=dim, potential=pot, jastrow=jas, **kw)


def _window(cfg, seed):
    """(R, xnew, xold, ip [W, B]) numpy float64: whole chains of lattice
    paths, the moved particle per row, one row with an exactly coincident
    partner."""
    paths = lattice_paths(cfg, seed=seed)
    W, B, N, _ = paths.shape
    rng = np.random.default_rng(seed + 1)
    ip = rng.integers(0, N, (W, B))
    xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
    xnew = xold + 0.1 * rng.normal(size=xold.shape)
    xnew[1, 2] = paths[1, 2, (ip[1, 2] + 1) % N]
    return paths, xnew, xold, ip


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_pair_rows_ref_matches_reference(model, dim):
    cfg = _model_cfg(model, dim)
    R, xnew, xold, ip = _window(cfg, 3)
    ib = np.arange(cfg.M)
    jsys = j_make_system(cfg)
    tsys = make_system(other_cfg(cfg), "cpu")
    for need_wf, need_f2 in ((True, True), (False, False)):
        want = np.asarray(jpw.delta_action_rows(
            jsys, make_tables(jsys), *_j(R, xnew, xold, ip, ib),
            need_wf=need_wf, need_f2=need_f2))
        got = kernels.pair_rows_ref(tsys, *_t(R, xnew, xold, ip),
                                    chin_table(tsys), *_t(ib), need_wf,
                                    need_f2)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        red = kernels.pair_rows_ref(tsys, *_t(R, xnew, xold, ip),
                                    chin_table(tsys), *_t(ib), need_wf,
                                    need_f2, reduce=True)
        np.testing.assert_allclose(red.numpy(), want.sum(-1), **TOL)


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_pair_pot_ref_matches_reference(model, dim):
    cfg = _model_cfg(model, dim)
    R = lattice_paths(cfg, seed=7)
    jsys = j_make_system(cfg)
    tsys = make_system(other_cfg(cfg), "cpu")
    for with_force in (False, True):
        want = jpw.pair_pot(jsys, make_tables(jsys), jnp.asarray(R),
                            with_force)
        got = kernels.pair_pot_ref(tsys, *_t(R), with_force)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_dense_forms_match_reference(model, dim):
    """pair_delta_ref (raw, with and without force, and the action delta
    with the Chin table) and pair_u_ref against delta_pot, delta_wf and
    delta_action; the coincident row gives the reference's non-finite
    values."""
    cfg = _model_cfg(model, dim)
    R, xnew, xold, ip = _window(cfg, 5)
    ib = np.arange(cfg.M)
    jsys = j_make_system(cfg)
    tab = make_tables(jsys)
    tsys = make_system(other_cfg(cfg), "cpu")
    args_j, args_t = _j(R, xnew, xold, ip), _t(R, xnew, xold, ip)
    for with_force in (False, True):
        want = jpw.delta_pot(jsys, tab, *args_j, with_force=with_force)
        got = kernels.pair_delta_ref(tsys, *args_t, with_force)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
        dt = cfg.dt
        wf = (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0
        want = jpw.delta_action(jsys, tab, *args_j, jnp.asarray(ib),
                                with_force=with_force)
        got = kernels.pair_delta_ref(tsys, *args_t, with_force,
                                     chin_table(tsys), *_t(ib), wf)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jpw.delta_wf(jsys, tab, *args_j)
    got = kernels.pair_u_ref(tsys, *args_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["ends", "interior"])
@pytest.mark.parametrize("model", MODELS, ids=_ids)
def test_cascade_ref_matches_reference(model, mode):
    cfg = _model_cfg(model, 3, fused_sweep=True, cascade=True)
    jsys = j_make_system(cfg)
    tsys = make_system(other_cfg(cfg), "cpu")
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
    want_seg, want_acc = jcas.cascade_jnp(
        jsys, make_tables(jsys), mode, *_j(Rwin, rg, ru), ips, nlev,
        jnp.asarray(act))
    got = torch.from_numpy(paths.copy())
    acc = cas.cascade_ref(tsys, mode, got, slots, tt(rg), tt(ru),
                          torch.from_numpy(act), nlev)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(want_acc))
    rows = slice(1, L) if mode == "interior" else slice(0, L + 1)
    expect = paths.copy()
    for s, (b0, step, ip) in enumerate(slots):
        beads = b0 + step * np.arange(L + 1)
        expect[:, beads[rows], ip] = np.asarray(want_seg)[:, s, rows]
    np.testing.assert_allclose(got.numpy(), expect, **TOL)


# --- whole steps and the Driver ---------------------------------------------

def test_dipolar_cfg_matches_the_reference_tool():
    """flagship.dipolar_cfg is tools/dipolar2d.py's build_cfg without its
    mesh and without use_pallas=False, so that the dipolar path runs the
    kernels (use_pallas=False would route all five to their plain
    forms)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "_dipolar2d_tool", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "dipolar2d.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    want = tool.build_cfg(n_walkers=1024, Nblock=3, use_pallas=True)
    assert other_cfg(dipolar_cfg(1024, 3)) == want


def _small_dipolar():
    """A small 2-D dipolar gas: dim 2, Np 16, Nb 4, W 4, float64, the
    dipolar configuration's sweep otherwise (the reference's SimConfig)."""
    return other_cfg(dipolar_cfg(4, 2).replace(Np=16, Nb=4, Lstag=4,
                                               Nstep=2))


@pytest.fixture(scope="module")
def dipolar_runs(tmp_path_factory):
    """The reference's dipolar step (jitted once) and a state burned in by
    it, then both Drivers over 2 blocks from that state, the port on the
    reference's draws.  Returns (cfg, step, burned state, reference dir,
    port dir)."""
    cfg = _small_dipolar()
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("torch"))
    jdrv = jdriver.Driver(cfg, out_dir=jdir, verbose=False)
    step = jax.jit(jdrv.sweeper.step)
    st, stats = jdrv.state, jsweep.zero_stats(jdrv.system)
    for _ in range(5):
        st, stats = step(st, stats)
    burned = st

    def block(state):
        acc = jsweep.zero_stats(jdrv.system)
        for _ in range(cfg.Nstep):
            state, acc = step(state, acc)
        return state, acc

    jdrv._block_fn = block
    jdrv.state = burned
    jdrv.run()
    tdrv = tdriver.Driver(other_cfg(cfg), out_dir=tdir, device="cpu",
                          verbose=False,
                          draws=JaxDraws(burned.key, cfg.dim, jnp.float64))
    tdrv.state = state_from_numpy(tdrv.system, {k: getattr(burned, k)
                                                for k in STATE_FIELDS})
    tdrv.run()
    return cfg, step, burned, jdir, tdir


def test_dipolar_step_matches_reference(dipolar_runs):
    """One step of the small dipolar gas (the fused sweep) from the burned
    state, the port on the reference's draws."""
    cfg, step, burned, _, _ = dipolar_runs
    ref, ref_stats = step(burned, jsweep.zero_stats(j_make_system(cfg)))
    tsys = make_system(other_cfg(cfg), "cpu")
    state = state_from_numpy(tsys, {k: getattr(burned, k)
                                    for k in STATE_FIELDS})
    state, stats = tsweep.Sweeper(tsys).step(
        state, tsweep.zero_stats(tsys),
        JaxDraws(burned.key, cfg.dim, jnp.float64))
    counters = assert_step_pair(ref, ref_stats, state, stats, TOL)
    assert counters.sum() > 0


@pytest.mark.parametrize("name", ["e_vpi.out", "et_vpi.out", "gr_vpi.out",
                                  "sk_vpi.out"])
def test_dipolar_driver_matches_reference(dipolar_runs, name):
    """The dipolar Driver over 2 blocks: every output file equal to the
    reference Driver's, E/N > 0 in each block."""
    _, _, _, jdir, tdir = dipolar_runs
    want = np.loadtxt(os.path.join(jdir, name), ndmin=2)
    got = np.loadtxt(os.path.join(tdir, name), ndmin=2)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    if name == "e_vpi.out":
        assert got.shape[0] == 2 and (got[:, 1] > 0).all()


def test_ideal_gas_under_pbc_step_matches_reference():
    """One step of the ideal Bose gas under PBC (potential and Jastrow
    'none', worm on) on the reference's draws: the mixed energy is exactly
    0 on every walker, and the step equals the reference's."""
    cfg = small_cfg(potential="none", jastrow="none", Np=8, n_walkers=8)
    ref, ref_stats, state, stats = step_pair(cfg, nstep=1, nburn=40)
    assert_step_pair(ref, ref_stats, state, stats, TOL)
    assert float(stats.sumE) == 0.0 and float(stats.sumE2) == 0.0
