"""The differentiable action of the torch port against the reference.

Float64 on the CPU, the same inputs through the JAX function and the
port's:
  * ops/action's weights and green_function, and total_action,
    interaction_action and grad_action (torch.autograd of the summed
    action, per walker): rtol 1e-10 against JAX, and the gradient against
    central finite differences (tests/test_action.py:136);
  * mala_move on the same xi and u as the JAX move draws from its key, with
    and without the odd-bead cache;
  * ops/variational against tests/test_variational.py's six checks: the
    parameterized local energy, dS/dRm, dS/da_ho and dE_V/dRm against JAX
    and finite differences, and the two optimizations on the port's own
    sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import lattice_paths, mala_draws, other_cfg, small_cfg

from pathintegralgroundstate_torch.config import SimConfig
from pathintegralgroundstate_torch.ops import action as tact
from pathintegralgroundstate_torch.ops import estimators as test
from pathintegralgroundstate_torch.ops import total_action as tta
from pathintegralgroundstate_torch.ops import variational as tvar
from pathintegralgroundstate_torch.ops.pairwise import force_field
from pathintegralgroundstate_torch.ops.smartmc import mala_move
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import action as jact
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops import smartmc as jsm
from pathintegralgroundstate_tpu.ops import total_action as jta
from pathintegralgroundstate_tpu.ops import variational as jvar
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
F64 = jnp.float64


def _t(x):
    return torch.from_numpy(np.array(x))


def _systems(**kw):
    cfg = small_cfg(exact_f2=True, **kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _trap_paths(cfg, seed):
    """Worldlines [W, M, N, D] in the trap: particles spread over a few
    trap lengths, each chain a small jitter about its place."""
    rng = np.random.default_rng(seed)
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    return (2.0 * rng.normal(size=(W, 1, N, D))
            + 0.05 * rng.normal(size=(W, M, N, D)))


GEOMETRIES = {"pbc": {}, "trap": dict(trap=True, dim=2, a_ho=(1.0, 1.3))}


def _case(geometry, seed=3, **kw):
    cfg, jsys, tables, tsys = _systems(**GEOMETRIES[geometry], **kw)
    paths = (lattice_paths(cfg, seed=seed) if geometry == "pbc"
             else _trap_paths(cfg, seed))
    return cfg, jsys, tables, tsys, paths


# ---------------------------------------------------------------------------
# ops/action
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["chin_weights", "chin_weights_thermo"])
def test_weights_match_reference(fn):
    got = getattr(tact, fn)(17, 5e-3, torch.float64)
    want = getattr(jact, fn)(17, 5e-3, F64)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("opt", [0, 1])
def test_green_function_matches_reference(opt):
    rng = np.random.default_rng(opt)
    ib = np.arange(17)
    pot, f2 = rng.normal(size=17), rng.uniform(size=17)
    got = tact.green_function(opt, torch.from_numpy(ib), 17, 5e-3, _t(pot),
                              _t(f2))
    want = jact.green_function(opt, jnp.asarray(ib), 17, 5e-3,
                               jnp.asarray(pot), jnp.asarray(f2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# ops/total_action
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_total_action_matches_reference(geometry):
    cfg, jsys, tables, tsys, paths = _case(geometry)
    for fn in ("total_action", "interaction_action"):
        want = jax.jit(jax.vmap(lambda p, f=getattr(jta, fn): f(
            jsys, tables, p)))(jnp.asarray(paths))
        got = getattr(tta, fn)(tsys, _t(paths))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=fn)
    want = jax.vmap(lambda p: jta.log_trial_wf(jsys, tables, p))(
        jnp.asarray(paths[:, 0]))
    np.testing.assert_allclose(tta.log_trial_wf(tsys, _t(paths[:, 0])),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_grad_action_matches_reference(geometry):
    """The gradient of the batch: per walker the gradient of its own action
    (the walkers do not interact), equal to jax.grad's."""
    cfg, jsys, tables, tsys, paths = _case(geometry, seed=4)
    want = np.asarray(jax.jit(jax.vmap(lambda p: jta.grad_action(
        jsys, tables, p)))(jnp.asarray(paths[:3])))
    got = tta.grad_action(tsys, _t(paths[:3]))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    S, G = tta.action_and_grad(tsys, _t(paths[:3]), chunk=2)
    np.testing.assert_allclose(G.numpy(), want, **TOL)
    np.testing.assert_allclose(
        S.numpy(), tta.total_action(tsys, _t(paths[:3])).numpy(), **TOL)


def test_action_gradient_vs_finite_difference():
    """test_action.py:136 on the port: random beads, central differences."""
    cfg = SimConfig(dim=3, Np=4, density=0.365, Nb=4, dt=5e-3, Rm=1.2,
                    dtype="float64", potential="aziz2", n_walkers=2)
    system = make_system(cfg, "cpu")
    L = system.geo.Lbox[0]
    gen = torch.Generator().manual_seed(7)
    paths = L * (torch.rand((cfg.M, cfg.Np, cfg.dim), generator=gen,
                            dtype=torch.float64) - 0.5)
    g = tta.grad_action(system, paths)

    def f(p):
        return float(tta.total_action(system, p))

    rng = np.random.default_rng(3)
    h = 1e-6
    for _ in range(6):
        ib, ip, k = (rng.integers(0, cfg.M), rng.integers(0, cfg.Np),
                     rng.integers(0, cfg.dim))
        e = torch.zeros_like(paths)
        e[ib, ip, k] = h
        fd = (f(paths + e) - f(paths - e)) / (2 * h)
        np.testing.assert_allclose(float(g[ib, ip, k]), fd, rtol=2e-4,
                                   atol=1e-7)


# ---------------------------------------------------------------------------
# ops/smartmc
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("cache", [False, True])
def test_mala_move_matches_reference(geometry, cache):
    """One MALA update on the xi and u the JAX move draws from its key:
    paths, accepts and (with the cache) the refreshed field equal.  The
    step size puts the acceptance between none and all."""
    cfg, jsys, tables, tsys, paths = _case(
        geometry, seed=5, **({} if geometry == "pbc" else dict(
            potential="none", jastrow="none")))
    eps = 1e-3 if geometry == "pbc" else 2e-3
    active = np.array([True, True, False, True, True, True, True, False])
    key = jax.random.key(11)
    xi, u = mala_draws(key, paths.shape, F64)
    fodd = np.asarray(jpw.force_field(jsys, tables,
                                      jnp.asarray(paths[:, 1::2])))
    out = jax.jit(lambda k, p, a, f: jsm.mala_move(
        jsys, tables, k, p, a, eps, fodd=f))(
            key, jnp.asarray(paths), jnp.asarray(active),
            jnp.asarray(fodd) if cache else None)
    tp, tf = _t(paths), _t(fodd)
    got, acc = mala_move(tsys, tp, torch.from_numpy(active), eps, xi, u,
                         tf if cache else None)
    assert got is tp
    np.testing.assert_allclose(got.numpy(), np.asarray(out[0]), **TOL)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(out[-1]))
    if cache:
        np.testing.assert_allclose(tf.numpy(), np.asarray(out[1]), **TOL)
        np.testing.assert_allclose(
            tf.numpy(), force_field(tsys, got[:, 1::2]).numpy(), **TOL)
    assert 0 < int(acc.sum()) < int(active.sum())


def test_smart_mc_needs_exact_f2():
    """The Sweeper refuses smart_mc > 0 without exact_f2, as the reference
    does (sweep.py:166-175)."""
    from pathintegralgroundstate_torch.sweep import Sweeper
    with pytest.raises(ValueError, match="smart_mc > 0 requires exact_f2"):
        Sweeper(make_system(other_cfg(small_cfg(smart_mc=0.1)), "cpu"))


# ---------------------------------------------------------------------------
# ops/variational: tests/test_variational.py's six checks
# ---------------------------------------------------------------------------

def _he4_cfg(Np=8):
    return dict(dim=3, Np=Np, density=0.365, dt=5e-3, Nb=4, sampling="sta",
                Lstag=4, Nstag=1, n_walkers=4, dtype="float64",
                potential="aziz2", jastrow="mcmillan_c1", seed=3)


def _he4(Np=8):
    kw = _he4_cfg(Np)
    jsys = j_make_system(other_cfg(SimConfig(**kw)))
    tsys = make_system(SimConfig(**kw), "cpu")
    # a jittered-lattice batch of slices [W, N, D] and one worldline
    cfg = small_cfg(**{k: v for k, v in kw.items() if k in (
        "Np", "density", "Nb", "n_walkers")})
    return jsys, tsys, lattice_paths(cfg, seed=9)


def test_local_energy_params_matches_estimator():
    """At Rm = cfg.Rm the parameterized local energy equals the port's
    estimator and the reference's local_energy_params."""
    jsys, tsys, paths = _he4()
    R = _t(paths[:, 0])
    e0 = test.local_energy(tsys, R)
    e1 = tvar.local_energy_params(tsys, R, tsys.cfg.Rm)
    for a, b in zip(e0, e1):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-12)
    for w in range(R.shape[0]):
        want = jvar.local_energy_params(jsys, jnp.asarray(paths[w, 0]),
                                        jnp.asarray(1.2))
        for a, b in zip(e1, want):
            np.testing.assert_allclose(float(a[w]), float(b), **TOL)


def _grad(f, x):
    x = torch.as_tensor(x, dtype=torch.float64).clone().requires_grad_(True)
    return torch.autograd.grad(f(x), x)[0].numpy()


def test_grad_action_wrt_rm_matches_fd():
    """dS/dRm by torch.autograd against jax.grad and central differences."""
    jsys, tsys, paths = _he4()
    pw = paths[0]
    f = lambda rm: tvar.total_action_params(tsys, _t(pw), rm)  # noqa: E731
    g = float(_grad(f, 1.2))
    want = float(jax.grad(lambda rm: jvar.total_action_params(
        jsys, jnp.asarray(pw), rm))(jnp.asarray(1.2)))
    np.testing.assert_allclose(g, want, **TOL)
    np.testing.assert_allclose(float(f(1.2)), float(
        jvar.total_action_params(jsys, jnp.asarray(pw), jnp.asarray(1.2))),
        **TOL)
    h = 1e-5
    fd = (float(f(1.2 + h)) - float(f(1.2 - h))) / (2 * h)
    assert abs(g - fd) < 1e-5 * max(abs(fd), 1.0), (g, fd)
    assert abs(g) > 1e-3


def test_grad_action_wrt_aho_matches_fd():
    """Trap geometry: dS/da_ho against jax.grad and finite differences."""
    kw = dict(dim=2, Np=3, trap=True, a_ho=(1.0, 1.0), dt=0.05, Nb=3,
              sampling="sta", Lstag=2, Nstag=1, n_walkers=2, dtype="float64",
              potential="none", jastrow="none", seed=5)
    tsys = make_system(SimConfig(**kw), "cpu")
    jsys = j_make_system(other_cfg(SimConfig(**kw)))
    pw = np.random.default_rng(5).normal(size=(tsys.M, 3, 2))
    f = lambda a: tvar.total_action_params(tsys, _t(pw), 1.2,  # noqa: E731
                                           a_ho=a)
    g = _grad(f, [1.0, 1.0])
    want = np.asarray(jax.grad(lambda a: jvar.total_action_params(
        jsys, jnp.asarray(pw), jnp.asarray(1.2), a_ho=a))(
            jnp.asarray([1.0, 1.0])))
    np.testing.assert_allclose(g, want, **TOL)
    h = 1e-5
    for k in range(2):
        ap, am = np.array([1.0, 1.0]), np.array([1.0, 1.0])
        ap[k] += h
        am[k] -= h
        fd = (float(f(_t(ap))) - float(f(_t(am)))) / (2 * h)
        assert abs(g[k] - fd) < 1e-5 * max(abs(fd), 1.0), (k, g[k], fd)
    assert np.abs(g).max() > 1e-3


def test_grad_vmc_energy_matches_fd():
    """dE_V/dRm of the reweighted VMC energy, on slices equilibrated under
    |psi|^2 by the port's sampler: against jax.grad on the same slices and
    against finite differences."""
    jsys, tsys, paths = _he4(Np=6)
    gen = torch.Generator().manual_seed(1)
    Rs, _ = tvar.vmc_sweep(tsys, gen, _t(paths[:, 0, :6]), 1.2, 0.3,
                           nsweeps=40)
    f = lambda rm: tvar.vmc_energy(tsys, Rs, rm, Rm_ref=1.2)  # noqa: E731
    g = float(_grad(f, 1.2))
    want = float(jax.grad(lambda rm: jvar.vmc_energy(
        jsys, jnp.asarray(Rs.numpy()), rm, Rm_ref=jnp.asarray(1.2)))(
            jnp.asarray(1.2)))
    np.testing.assert_allclose(g, want, **TOL)
    h = 1e-5
    fd = (float(f(1.2 + h)) - float(f(1.2 - h))) / (2 * h)
    assert abs(g - fd) < 1e-4 * max(abs(fd), abs(g), 1.0), (g, fd)


def test_vmc_optimization_moves_toward_optimum():
    """A few gradient steps from a bad Rm move toward the optimum (~1.2
    sigma) without blowing the variational energy up."""
    _, tsys, paths = _he4(Np=8)
    gen = torch.Generator().manual_seed(0)
    Rm = 1.00
    Rs, acc = tvar.vmc_sweep(tsys, gen, _t(paths[:, 0]), Rm, 0.3,
                             nsweeps=40)
    assert 0.1 < float(acc) < 0.99
    E0 = float(tvar.vmc_energy(tsys, Rs, Rm))
    for _ in range(6):
        g = float(_grad(lambda rm: tvar.vmc_energy(tsys, Rs, rm), Rm))
        Rm = float(np.clip(Rm - 0.05 * np.sign(g), 0.8, 1.6))
        Rs, _ = tvar.vmc_sweep(tsys, gen, Rs, Rm, 0.3, nsweeps=10)
    E1 = float(tvar.vmc_energy(tsys, Rs, Rm))
    assert Rm > 1.05, Rm
    assert E1 < E0 + 0.5


def test_aho_optimization_exact_optimum():
    """a_ho as a variational parameter of the ideal trapped gas: E(a)/N =
    (d/4)(1/a^2 + a^2/a_t^4), minimal at a = a_t; gradient descent from a
    bad a lands on the trap length."""
    kw = dict(dim=2, Np=4, trap=True, a_ho=(1.0, 1.0), dt=0.05, Nb=2,
              sampling="sta", Lstag=2, Nstag=1, n_walkers=256,
              potential="none", jastrow="none", dtype="float64", seed=13)
    system = make_system(SimConfig(**kw), "cpu")
    Rs = 0.7 * torch.randn((256, 4, 2), generator=torch.Generator()
                           .manual_seed(2), dtype=torch.float64)

    def E_of(a):
        gen = torch.Generator().manual_seed(5)
        R2, _ = tvar.vmc_sweep(system, gen, Rs, 1.2, 0.7, nsweeps=120,
                               a_ho=_t([a, a]))
        return float(tvar.vmc_energy(system, R2, 1.2, a_ho=_t([a, a]))) / 4

    for a in (1.0, 1.4):
        exact = 0.5 * (1.0 / a ** 2 + a ** 2)
        assert abs(E_of(a) - exact) < 0.07, (a, E_of(a), exact)

    a, R2 = 1.4, Rs
    gen = torch.Generator().manual_seed(9)
    for _ in range(25):
        R2, _ = tvar.vmc_sweep(system, gen, R2, 1.2, 0.5, nsweeps=5,
                               a_ho=_t([a, a]))
        g = float(_grad(lambda x: tvar.vmc_energy(
            system, R2, 1.2, a_ho=torch.stack([x, x])), a)) / 4
        a = float(np.clip(a - 0.1 * np.clip(g, -1, 1), 0.6, 2.0))
    assert abs(a - 1.0) < 0.12, a
