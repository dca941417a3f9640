"""Table mode of the torch port against the reference, and the three RefRNG
replay goldens through the port.

utils/interpolate (opt 0/1/2, inside the grid and at both clipped edges)
and make_tables against the reference's (float64 tables bitwise equal
where their form is exact arithmetic, see EXACT); the table-mode dense delta_action, local_energy and therm_energy
against the reference's with its tables (rtol 1e-10, atol 1e-12:
reassociation only), and a whole table-mode step on the reference's draws;
the C MT19937 stream (native/mtref.c, built into build/) against its
pure-Python transcription; then tests/golden/refrng_replay*.json replayed
through the port's utils/replay, whose every Delta-S is the port's
delta_action with both tables, at tests/test_refrng.py's tolerance (atol
1e-12).  The goldens need no JAX: the reference's side is the golden file.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import assert_step_pair, lattice_paths, other_cfg, \
    small_cfg, step_pair

from pathintegralgroundstate_torch.ops import estimators as est
from pathintegralgroundstate_torch.ops.pairwise import delta_action
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.system import make_tables as t_make_tables
from pathintegralgroundstate_torch.utils import interpolate as tint
from pathintegralgroundstate_torch.utils import refrng, replay
from pathintegralgroundstate_tpu.ops import estimators as jest
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables
from pathintegralgroundstate_tpu.utils import interpolate as jint

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
TABLES = [dict(v_table=True, wf_table=True), dict(v_table=True),
          dict(wf_table=True)]


def _ids(kw):
    return ",".join(kw)


# --- interpolate and the tables ---------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("opt", [0, 1, 2])
def test_interpolate_matches_reference(opt, dtype):
    """Inside the grid, below 2 dx (index clipped to 2) and beyond rmax
    (clipped to n); the one-step-below interval of the reference."""
    n, rmax = 200, 4.0
    F, dx = jint.build_table(lambda r: jnp.cos(r) * jnp.exp(-0.2 * r), rmax,
                             n, dtype)
    rng = np.random.default_rng(opt)
    x = np.r_[rng.uniform(0.0, rmax, 200), 0.0, 0.3 * dx, 1.5 * dx,
              rmax - 0.5 * dx, rmax, rmax + 0.7, 2 * rmax].astype(dtype)
    want = np.asarray(jint.interpolate(opt, dx, F, jnp.asarray(x)))
    got = tint.interpolate(opt, dx, torch.from_numpy(np.array(F)),
                           torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype
    rtol = 1e-12 if dtype == np.float64 else 2e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=1e-12 if dtype == np.float64 else 1e-5)


def test_interpolate_rejects_other_opts():
    with pytest.raises(ValueError, match="opt must be 0, 1 or 2"):
        tint.interpolate(3, 0.1, torch.zeros(10), torch.zeros(3))


# the forms of the tables whose float64 values round as the reference's on
# every grid point: every operation an IEEE product, quotient or sum (the
# reference's integer powers are square-and-multiply chains, models.ipow).
# Aziz takes exp, and dipolar2d sqrt, whose last bit differs on a few
# percent of the points between XLA's CPU exp and torch's, and between
# torch's CPU sqrt and the correctly rounded one: those within rtol 1e-13
# (a few ulp, raised by the C1 shift's cancellation), atol 1e-15.
EXACT = {("logwf", "mcmillan"), ("logwf", "mcmillan_c1"), ("logwf", "none"),
         ("vtab", "soft"), ("vtab", "dipolar"), ("vtab", "none")}


@pytest.mark.parametrize("model", [("aziz2", "mcmillan_c1"),
                                   ("aziz1", "mcmillan"),
                                   ("soft", "dipolar2d"),
                                   ("dipolar", "dipolar2d"),
                                   ("none", "none")],
                         ids=lambda m: "-".join(m))
def test_make_tables_equal_reference(model):
    """make_tables in float64 against the reference's: bitwise equal where
    the form is exact arithmetic (EXACT), within a few ulp where it takes
    exp or sqrt; on the System, the same tables."""
    cfg = small_cfg(potential=model[0], jastrow=model[1], v_table=True,
                    wf_table=True, Nmax=500)
    jsys = j_make_system(cfg)
    want = make_tables(jsys)
    tsys = make_system(other_cfg(cfg), "cpu")
    got = t_make_tables(tsys)
    for name, form in (("logwf", model[1]), ("vtab", model[0])):
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert g.shape == (cfg.Nmax + 2,) and g.dtype == np.float64
        if (name, form) in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-13, atol=1e-15,
                                       err_msg=name)
        np.testing.assert_array_equal(getattr(tsys.tables, name).numpy(), g)


@pytest.mark.parametrize("tables", TABLES, ids=_ids)
def test_float32_tables_tabulate_in_float32(tables):
    """float32 tables are tabulated in float32, as build_table does: within
    a few float32 ulps of the table's scale of the reference's."""
    cfg = small_cfg(dtype="float32", Nmax=300, **tables)
    tsys = make_system(other_cfg(cfg), "cpu")
    want = make_tables(j_make_system(cfg))
    for name in ("logwf", "vtab"):
        g, w = getattr(tsys.tables, name), getattr(want, name)
        assert (g is None) == (w is None)
        if g is not None:
            assert g.dtype == torch.float32
            w = np.asarray(w)
            scale = np.abs(w[np.isfinite(w)]).max()
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-6,
                                       atol=4 * 2.0 ** -23 * scale)


# --- table mode in the plain forms ------------------------------------------

def _cfg(tables, **kw):
    return small_cfg(**dict(dict(Np=8, n_walkers=4, Nmax=800), **tables, **kw))


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("tables", TABLES, ids=_ids)
def test_delta_action_with_tables_matches_reference(tables, with_force):
    cfg = _cfg(tables)
    paths = lattice_paths(cfg, seed=3)
    rng = np.random.default_rng(4)
    W, B, N, _ = paths.shape
    ip = rng.integers(0, N, (W, B))
    xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
    xnew = xold + 0.1 * rng.normal(size=xold.shape)
    ib = np.arange(cfg.M)
    jsys = j_make_system(cfg)
    want = jpw.delta_action(jsys, make_tables(jsys), jnp.asarray(paths),
                            jnp.asarray(xnew), jnp.asarray(xold),
                            jnp.asarray(ip), jnp.asarray(ib),
                            with_force=with_force)
    got = delta_action(make_system(other_cfg(cfg), "cpu"),
                       *[torch.from_numpy(np.ascontiguousarray(x))
                         for x in (paths, xnew, xold, ip, ib)], with_force)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("tables", TABLES, ids=_ids)
def test_estimators_with_tables_match_reference(tables):
    """local_energy (per walker at bead 0) and therm_energy with the
    tables."""
    cfg = _cfg(tables)
    paths = lattice_paths(cfg, seed=5)
    jsys = j_make_system(cfg)
    jt = make_tables(jsys)
    tsys = make_system(other_cfg(cfg), "cpu")
    got = est.local_energy(tsys, torch.from_numpy(paths[:, 0].copy()))
    for w in range(cfg.n_walkers):
        want = jest.local_energy(jsys, jt, jnp.asarray(paths[w, 0]))
        for g, x in zip(got, want):
            np.testing.assert_allclose(g[w].item(), float(x), **TOL)
    got = est.therm_energy(tsys, torch.from_numpy(paths))
    for w in range(cfg.n_walkers):
        want = jest.therm_energy(jsys, jt, jnp.asarray(paths[w]))
        for g, x in zip(got, want):
            np.testing.assert_allclose(g[w].item(), float(x), **TOL)


def test_table_mode_step_matches_reference():
    """One whole step with both tables (the flagship's unfused sweep, worm
    on) on the reference's draws."""
    cfg = _cfg(TABLES[0], n_walkers=8)
    ref, ref_stats, state, stats = step_pair(cfg, nstep=1, nburn=40)
    counters = assert_step_pair(ref, ref_stats, state, stats, TOL)
    assert counters.sum() > 0


# --- RefRNG and the goldens --------------------------------------------------

def test_refrng_c_matches_python_transcription():
    c, p = refrng.RefRNG(seed=1982), refrng.PyRefRNG(seed=1982)
    np.testing.assert_array_equal(c.uniform(2000),
                                  [p.grnd() for _ in range(2000)])
    for _ in range(50):
        assert c.rangauss(2.0, 0.5) == p.rangauss(2.0, 0.5)
    g = refrng.RefRNG(seed=3).gauss(20_000)
    assert abs(g.mean()) < 0.03 and abs(g.std() - 1.0) < 0.03


def test_refrng_builds_outside_native():
    """The C library is built into build/mtref/, never into native/."""
    lib = refrng.build()
    assert lib.parent.parent.name == "mtref" and lib.exists()
    assert "native" not in lib.parts


def _golden(name):
    with open(os.path.join(GOLDEN, name)) as fh:
        g = json.load(fh)
    paths = np.array([[[float.fromhex(v) for v in row] for row in sl]
                      for sl in g["paths_hex"]])
    return g, paths


def test_reference_trajectory_replay_golden():
    g, want = _golden("refrng_replay.json")
    got = replay.replay_trajectory(
        seed=g["seed"], nsteps=g["nsteps"], Np=g["Np"], Nb=g["Nb"],
        dim=g["dim"], Lstag=g["Lstag"], density=g["density"], dt=g["dt"],
        Rm=g["Rm"], Nmax=g["Nmax"], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert np.abs(np.diff(want, axis=0)).max() > 1e-3


def test_reference_bisection_replay_golden():
    g, want = _golden("refrng_replay_bisection.json")
    got = replay.replay_bisection_trajectory(
        seed=g["seed"], nsteps=g["nsteps"], Np=g["Np"], Nb=g["Nb"],
        dim=g["dim"], Nlev=g["Nlev"], density=g["density"], dt=g["dt"],
        Rm=g["Rm"], device="cpu")
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_reference_worm_replay_golden():
    g, want = _golden("refrng_replay_worm.json")
    path, xend, events = replay.replay_worm_trajectory(
        seed=g["seed"], nsteps=g["nsteps"], Np=g["Np"], Nb=g["Nb"],
        dim=g["dim"], Lstag=g["Lstag"], density=g["density"], dt=g["dt"],
        Rm=g["Rm"], CWorm=g["CWorm"], nequil=g["nequil"], device="cpu")
    assert [list(e) for e in events] == [list(e) for e in g["events"]]
    np.testing.assert_allclose(path, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        xend, [[float.fromhex(v) for v in row] for row in g["xend_hex"]],
        rtol=0, atol=1e-12)
