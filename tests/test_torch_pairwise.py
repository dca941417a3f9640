"""The torch window pass and all-pairs sums against the reference.

Float64 on the CPU against the reference's jnp path (rtol 1e-10, atol 1e-12:
reassociation only); float32 against the Pallas kernels in interpret mode,
with tests/test_pallas_kernel.py's tolerances.  The hand-written kernels
against their plain forms: tests/test_torch_cuda.py (on a CUDA device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_bridge import lattice_paths, other_cfg, small_cfg

from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import delta_action_rows, \
    delta_action_sum, pair_pot
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops.pallas_kernels import pair_pot_pallas, \
    pair_rows_pallas
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)


def _window(cfg, ip_form, seed=0, dtype=np.float64, coincident=True):
    """(R, xnew, xold, ip) numpy: a whole-chain window (both chain ends, odd
    and even beads), with one exactly coincident partner row."""
    paths = lattice_paths(cfg, seed=seed).astype(dtype)
    W, B, N, D = paths.shape
    rng = np.random.default_rng(seed + 1)
    if ip_form == "scalar":
        ip = 3
        xold = paths[:, :, ip]
        p3 = ip
    elif ip_form == "walker":
        ip = rng.integers(0, N, W)
        xold = paths[np.arange(W), :, ip]
        p3 = ip[1]
    else:
        ip = rng.integers(0, N, (W, B))
        xold = np.take_along_axis(paths, ip[:, :, None, None], 2)[:, :, 0]
        p3 = ip[1, 2]
    xnew = xold + 0.1 * rng.normal(size=xold.shape).astype(dtype)
    if coincident:
        xnew[1, 2] = paths[1, 2, (p3 + 1) % N]
    return paths, xnew, xold, ip


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ip_t(ip):
    return ip if isinstance(ip, int) else torch.from_numpy(ip)


def _tsys(cfg):
    """The port's System of a reference cfg."""
    return make_system(other_cfg(cfg))


@pytest.mark.parametrize("need_wf,need_f2", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_delta_action_rows_matches_reference(ip_form, need_wf, need_f2):
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form)
    ib = np.arange(cfg.M)
    jsys = j_make_system(cfg)
    want = jpw.delta_action_rows(jsys, make_tables(jsys), jnp.asarray(R),
                                 jnp.asarray(xnew), jnp.asarray(xold),
                                 jnp.asarray(ip), jnp.asarray(ib),
                                 need_wf=need_wf, need_f2=need_f2)
    got = delta_action_rows(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                            _ip_t(ip), _t(ib), need_wf=need_wf,
                            need_f2=need_f2)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ip_form", ["scalar", "walker"])
def test_reversed_window_matches_reference(ip_form):
    """rev=True reads a forward window backwards: the reference's [:, ::-1]
    view."""
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=3)
    B = 9
    Rf = R[:, 2:2 + B]                        # forward beads 2..10
    xn, xo = xnew[:, :B], xold[:, :B]         # rows: beads 10, 9, .., 2
    ib = np.arange(10, 1, -1)
    jsys = j_make_system(cfg)
    want = jpw.delta_action_rows(jsys, make_tables(jsys),
                                 jnp.asarray(Rf[:, ::-1]), jnp.asarray(xn),
                                 jnp.asarray(xo), jnp.asarray(ip),
                                 jnp.asarray(ib))
    got = delta_action_rows(_tsys(cfg), _t(Rf), _t(xn), _t(xo),
                            _ip_t(ip), _t(ib), rev=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_delta_action_sum_row_weights_matches_reference():
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, "walker", seed=5)
    ib = np.arange(cfg.M)
    rw = np.ones(cfg.M)
    rw[0] = 0.5
    jsys = j_make_system(cfg)
    want = jpw.delta_action_sum(jsys, make_tables(jsys), jnp.asarray(R),
                                jnp.asarray(xnew), jnp.asarray(xold),
                                jnp.asarray(ip), jnp.asarray(ib),
                                row_weights=jnp.asarray(rw))
    got = delta_action_sum(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                           _ip_t(ip), _t(ib), row_weights=_t(rw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_force", [False, True])
@pytest.mark.parametrize("potential", ["aziz2", "aziz1"])
def test_pair_pot_matches_reference(with_force, potential):
    cfg = small_cfg(potential=potential)
    R = lattice_paths(cfg, seed=7)
    jsys = j_make_system(cfg)
    want = jpw.pair_pot(jsys, make_tables(jsys), jnp.asarray(R), with_force)
    got = pair_pot(_tsys(cfg), _t(R), with_force)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# --- against the Pallas kernels in interpret mode (float32) ----------------

def _f32_cfg():
    return small_cfg(Np=16, n_walkers=4, dtype="float32")


@pytest.mark.parametrize("with_force", [True, False])
def test_pair_pot_ref_matches_pallas_interpret(with_force):
    cfg = _f32_cfg()
    R = lattice_paths(cfg, seed=9).astype(np.float32)[:, :4]
    jsys = j_make_system(cfg)
    with pltpu.force_tpu_interpret_mode():
        want = pair_pot_pallas(jsys, jnp.asarray(R), with_force)
    got = kernels.pair_pot_ref(_tsys(cfg), _t(R), with_force)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=1e-3)
    if with_force:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=2e-4, atol=1e-2)


@pytest.mark.parametrize("need_wf", [True, False])
@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_pair_rows_ref_matches_pallas_interpret(ip_form, need_wf):
    """No coincident partner here: the Pallas kernel forms r as r2 *
    rsqrt(r2), which is NaN at r2 == 0, where the jnp path (and the port)
    masks the pair."""
    cfg = _f32_cfg()
    R, xnew, xold, ip = _window(cfg, ip_form, seed=11, dtype=np.float32,
                                coincident=False)
    R, xnew, xold = R[:, :5], xnew[:, :5], xold[:, :5]
    if ip_form == "row":
        ip = np.ascontiguousarray(ip[:, :5])
    jsys = j_make_system(cfg)
    with pltpu.force_tpu_interpret_mode():
        want = pair_rows_pallas(jsys, jnp.asarray(R), jnp.asarray(xnew),
                                jnp.asarray(xold),
                                jnp.asarray(ip, jnp.int32), need_wf)
    got = kernels.pair_rows_ref(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                                _ip_t(ip), need_wf=need_wf)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=2e-4, atol=1e-3)
    if need_wf:
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=2e-4, atol=1e-4)


# --- wrappers ---------------------------------------------------------------

def test_cpu_tensors_take_the_plain_form_and_count_no_launch():
    cfg = small_cfg(Np=8, n_walkers=4)
    system = _tsys(cfg)
    R, xnew, xold, ip = _window(cfg, "scalar")
    n_rows, n_pot = kernels.pair_rows.launches, kernels.pair_pot.launches
    got = kernels.pair_rows(system, _t(R), _t(xnew), _t(xold), ip)
    ref = kernels.pair_rows_ref(system, _t(R), _t(xnew), _t(xold), ip)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    kernels.pair_pot(system, _t(R), True)
    assert (kernels.pair_rows.launches, kernels.pair_pot.launches) == \
        (n_rows, n_pot)
