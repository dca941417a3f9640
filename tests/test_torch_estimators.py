"""Estimators of the torch port against the reference, float64 on the CPU
(rtol 1e-10, atol 1e-12; histograms exactly)."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import lattice_paths, other_cfg, small_cfg

from pathintegralgroundstate_torch.ops import estimators as est
from pathintegralgroundstate_torch.ops import worm as wm
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import estimators as jest
from pathintegralgroundstate_tpu.ops import worm as jwm
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)


def _setup(**kw):
    cfg = small_cfg(**kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu"), \
        lattice_paths(cfg, seed=5)


@pytest.mark.parametrize("jastrow", ["mcmillan", "mcmillan_c1"])
def test_local_energy(jastrow):
    cfg, jsys, tables, tsys, paths = _setup(jastrow=jastrow)
    for bead in (0, -1):
        R = paths[:, bead]
        want = jax.vmap(partial(jest.local_energy, jsys, tables))(
            jnp.asarray(R))
        got = est.local_energy(tsys, torch.from_numpy(R))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("potential", ["aziz2", "aziz1"])
def test_therm_energy(potential):
    cfg, jsys, tables, tsys, paths = _setup(potential=potential)
    want = jest.therm_energy(jsys, tables, jnp.asarray(paths))
    got = est.therm_energy(tsys, torch.from_numpy(paths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_pair_correlation():
    cfg, jsys, tables, tsys, paths = _setup()
    R = paths[:, cfg.Nb]
    weight = (np.arange(cfg.n_walkers) % 3 != 0).astype(np.float64)
    gr_w = jax.vmap(partial(jest.pair_correlation, jsys))(jnp.asarray(R))
    want = np.sum(np.asarray(gr_w) * weight[:, None], axis=0)
    got = est.pair_correlation(tsys, torch.from_numpy(R),
                               torch.from_numpy(weight))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_structure_factor():
    cfg, jsys, tables, tsys, paths = _setup()
    R = paths[:, cfg.Nb]
    want = jax.vmap(partial(jest.structure_factor, jsys, cfg.Nk))(
        jnp.asarray(R))
    got = est.structure_factor(tsys, cfg.Nk, torch.from_numpy(R))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("Npw", [0, 3])
def test_obdm_terms(Npw):
    cfg, jsys, tables, tsys, paths = _setup(Npw=Npw)
    rng = np.random.default_rng(9)
    L = jsys.geo.Lbox[0]
    xend = rng.uniform(-0.5 * L, 0.5 * L, (cfg.n_walkers, 2, cfg.dim))
    want = jwm.obdm_terms(jsys, jnp.asarray(xend))
    got = wm.obdm_terms(tsys, torch.from_numpy(xend))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), **TOL)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
