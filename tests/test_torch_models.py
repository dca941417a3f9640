"""Pair potentials, the Jastrow, the minimum image and the Chin weights of
the torch port against the reference, in float64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import other_cfg, small_cfg

from pathintegralgroundstate_torch.models.potentials import get_potential
from pathintegralgroundstate_torch.ops.pairwise import chin_weights
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.pbc import minimum_image, wrap
from pathintegralgroundstate_tpu.models.potentials import \
    get_potential as ref_potential
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.utils import pbc as jpbc

torch.set_num_threads(1)

# below the hard-core floor (s r < D_MIN = 1e-3), through the core, out past
# rcut
R_GRID = np.concatenate([[1e-7, 1e-5, 3e-4, 8e-4, 1.2e-3],
                         np.linspace(0.01, 3.0, 400)])
TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", ["aziz2", "aziz1"])
@pytest.mark.parametrize("fn", ["v", "dvdr"])
def test_potential_matches_reference(name, fn):
    got = getattr(get_potential(name), fn)(torch.from_numpy(R_GRID))
    want = getattr(ref_potential(name), fn)(jnp.asarray(R_GRID))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["aziz2", "aziz1"])
@pytest.mark.parametrize("with_rinv", [False, True])
def test_fused_v_dv_matches_reference(name, with_rinv):
    r = torch.from_numpy(R_GRID)
    rinv = torch.rsqrt(r * r) if with_rinv else None
    v, dv = get_potential(name).v_dv(r, rinv)
    jv, jdv = ref_potential(name).v_dv(
        jnp.asarray(R_GRID), jnp.asarray(rinv.numpy()) if with_rinv else None)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), **TOL)


@pytest.mark.parametrize("jastrow", ["mcmillan", "mcmillan_c1"])
@pytest.mark.parametrize("fn", ["u", "du", "d2u"])
def test_jastrow_matches_reference(jastrow, fn):
    cfg = small_cfg(jastrow=jastrow)
    r = R_GRID[R_GRID > 0.2]
    got = getattr(make_system(other_cfg(cfg), "cpu"), fn)(torch.from_numpy(r))
    want = getattr(j_make_system(cfg), fn)(jnp.asarray(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_c1_jastrow_vanishes_at_rcut():
    system = make_system(other_cfg(small_cfg(jastrow="mcmillan_c1")), "cpu")
    rc = torch.tensor([system.geo.rcut], dtype=torch.float64)
    assert abs(float(system.u(rc))) < 1e-14
    assert abs(float(system.du(rc))) < 1e-14


def test_minimum_image_matches_reference():
    cfg = small_cfg()
    system = make_system(other_cfg(cfg), "cpu")
    L = system.geo.Lbox[0]
    x = np.random.default_rng(0).uniform(-1.5 * L, 1.5 * L, (50, 7, 3))
    got = wrap(torch.from_numpy(x), system.L, system.half)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jpbc.wrap(x, system.geo.Lbox)))
    gx, gr2 = minimum_image(torch.from_numpy(x), system.L, system.half)
    jx, jr2 = jpbc.minimum_image(jnp.asarray(x), system.geo.Lbox)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_allclose(gr2.numpy(), np.asarray(jr2), **TOL)


@pytest.mark.parametrize("shape", ["beads", "walker_rows"])
def test_chin_weights_match_reference(shape):
    cfg = small_cfg()
    M = cfg.M
    if shape == "beads":
        ib = np.arange(M)
    else:
        ib = np.random.default_rng(1).integers(0, M, (5, 9))
    got = chin_weights(make_system(other_cfg(cfg), "cpu"),
                       torch.from_numpy(ib))
    want = jpw.chin_weights(j_make_system(cfg), jnp.asarray(ib), jnp.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
