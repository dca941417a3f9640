"""The dense delta_action (kernels 3 and 4, one launch on the card) and the
reference-order step that runs it, against the reference.

The plain forms of kernels 3 and 4 (pair_delta_ref, pair_u_ref) against the
reference's jnp delta_pot / delta_wf in float64 (rtol 1e-12: reassociation
only) and against pair_delta_pallas / pair_u_pallas in interpret mode in
float32 (tests/test_pallas_kernel.py's tolerances); the dense delta_action;
the per-level end bisection with its dense gate, at every depth of the
random-depth end move; paired ends against the sequential order (bitwise);
then whole steps of the reference-order configuration (per-level bisection,
random end depth) and of paired ends against the reference's step on its
own draws.  Float64 on the CPU: positions rtol 1e-12, accept masks, counters
and integer state exactly equal.  Kernel 3's plain form also closes the
dense action delta (given the Chin table and ib, with kernel 4's du on the
chain ends, as the one launch on the card does): it is held against the
reference's delta_action on every kind of row, NaN included.  The kernels
themselves: tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_bridge import assert_step_pair, bisect_draws, end_bisect_draws, \
    lattice_paths, other_cfg, small_cfg, step_pair

from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table, \
    delta_action, delta_pot, delta_wf
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import bisection as jbis
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops.pallas_kernels import pair_delta_pallas, \
    pair_u_pallas
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-12, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])
IP_FORMS = ["scalar", "walker", "row", "window_row"]
# the reference-order step: per-level bisection, the Fortran's random end
# depth (Nlev=3, so the depth has a choice of 2 or 3)
REF_ORDER = dict(bis_monoshot=False, bis_end_random_depth=True, Nlev=3)


@functools.lru_cache(maxsize=None)
def _systems(**kw):
    cfg = small_cfg(**kw)
    jsys = j_make_system(cfg)
    return cfg, jsys, make_tables(jsys), make_system(other_cfg(cfg), "cpu")


def _window(cfg, ip_form, seed):
    """(R, xnew, xold, ip) numpy: the whole chain as the window (both chain
    ends, odd and even beads); no coincident partner (the dense forms have
    no r^2 > 0 guard)."""
    paths = lattice_paths(cfg, seed=seed)
    W, B, N, _ = paths.shape
    rng = np.random.default_rng(seed + 1)
    ip = {"scalar": lambda: 3, "walker": lambda: rng.integers(0, N, W),
          "row": lambda: rng.integers(0, N, (W, B)),
          "window_row": lambda: rng.integers(0, N, (1, B))}[ip_form]()
    return paths, *_moved(paths, ip, 0.1 * rng.normal(size=(W, B, 3))), ip


def _moved(R, ip, step):
    """(xnew, xold): the moved particle's rows of R, and those plus step."""
    W, B = R.shape[:2]
    ipb = np.broadcast_to(ip if np.ndim(ip) != 1 else ip[:, None], (W, B))
    xold = np.take_along_axis(R, ipb[:, :, None, None], 2)[:, :, 0]
    return xold + step.astype(R.dtype), xold


def _t(x):
    return torch.from_numpy(np.array(x))


def _ip_t(ip):
    return ip if isinstance(ip, int) else torch.from_numpy(np.array(ip))


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_pair_delta_ref_matches_delta_pot(ip_form, with_force):
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=1)
    want = jpw.delta_pot(jsys, tables, jnp.asarray(R), jnp.asarray(xnew),
                         jnp.asarray(xold), jnp.asarray(ip), with_force)
    got = kernels.pair_delta_ref(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                                 with_force)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert with_force or not got[1].any()


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_delta_pot_matches_reference(ip_form, with_force):
    """pairwise.delta_pot, the public raw (dPot, dF2) form, unchanged by the
    epilogue: kernel 3's raw mode."""
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=7)
    want = jpw.delta_pot(jsys, tables, jnp.asarray(R), jnp.asarray(xnew),
                         jnp.asarray(xold), jnp.asarray(ip), with_force)
    got = delta_pot(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip), with_force)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# rows (walker, bead) given an exactly coincident partner: bead 0 (an end),
# bead 3 (odd interior) and bead 4 (even interior) of the whole chain
COINCIDENT = ((1, 0), (2, 3), (3, 4))


@pytest.mark.parametrize("coincident", [False, True])
@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ib_form", ["B", "WB"])
def test_pair_delta_ref_epilogue_matches_delta_action(ib_form, with_force,
                                                      coincident):
    """The plain form of kernels 3 and 4 in one launch (the Chin table, ib
    [B] or [W, B], the F^2 weight (4 dt/3) dt^2/6; du on the chain ends)
    against the reference's delta_action on the whole chain: both ends, odd
    and even interior rows.  With a coincident partner the reference gives
    NaN on that row with force (0 * NaN dF2) and +inf at an end without
    (-dLogPsi of u = -inf); the plain form gives the same."""
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, "row", seed=8)
    W, M, N = R.shape[:3]
    if coincident:
        for w, b in COINCIDENT:
            xnew[w, b] = R[w, b, (ip[w, b] + 1) % N]
    ib = np.arange(M) if ib_form == "B" else \
        np.random.default_rng(9).integers(0, M, (W, M))
    want = np.asarray(jpw.delta_action(
        jsys, tables, jnp.asarray(R), jnp.asarray(xnew), jnp.asarray(xold),
        jnp.asarray(ip), jnp.asarray(ib), with_force))
    args = (tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip))
    dt = cfg.dt
    got = kernels.pair_delta_ref(
        *args, with_force, chin_table(tsys), _t(ib),
        (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0)
    np.testing.assert_allclose(got.numpy(), want, equal_nan=True, **TOL)
    nonfinite = set(zip(*np.nonzero(~np.isfinite(want))))
    if not coincident:
        assert not nonfinite
    elif with_force:
        assert nonfinite == set(COINCIDENT)
        assert np.isnan(got.numpy()[tuple(zip(*COINCIDENT))]).all()
    elif ib_form == "B":
        assert nonfinite == {(1, 0)} and float(got[1, 0]) == float("inf")


@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_pair_u_ref_matches_delta_wf(ip_form):
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=2)
    want = jpw.delta_wf(jsys, tables, jnp.asarray(R), jnp.asarray(xnew),
                        jnp.asarray(xold), jnp.asarray(ip))
    got = kernels.pair_u_ref(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_delta_wf_matches_reference(ip_form):
    """pairwise.delta_wf, the public du form: the dense kernel's u mode
    (pair_u), its plain form here."""
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=5)
    want = jpw.delta_wf(jsys, tables, jnp.asarray(R), jnp.asarray(xnew),
                        jnp.asarray(xold), jnp.asarray(ip))
    n = kernels.pair_delta.launches, kernels.pair_u.launches
    got = delta_wf(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert n == (kernels.pair_delta.launches, kernels.pair_u.launches)


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_plain_forms_match_pallas_float32(ip_form, with_force):
    """Interpret mode, float32, on tests/test_pallas_kernel.py's inputs
    (partners uniform in the box, moves of 0.05); the Pallas kernels take
    ip scalar, [W] or [W, B]."""
    cfg, jsys, _, tsys = _systems(Np=16, n_walkers=4, dtype="float32")
    L = float(jsys.geo.Lbox[0])
    R = np.asarray((jax.random.uniform(jax.random.key(0), (4, 5, 16, 3),
                                       jnp.float32) - 0.5) * L)
    ip = {"scalar": 2, "walker": np.array([0, 3, 7, 15]),
          "row": np.random.default_rng(3).integers(0, 16, (4, 5))}[ip_form]
    xnew, xold = _moved(R, ip, 0.05 * np.asarray(jax.random.normal(
        jax.random.key(1), (4, 5, 3), jnp.float32)))
    with pltpu.force_tpu_interpret_mode():
        w_pot, w_f2 = pair_delta_pallas(jsys, jnp.asarray(R),
                                        jnp.asarray(xnew), jnp.asarray(xold),
                                        jnp.asarray(ip), with_force)
        w_u = pair_u_pallas(jsys, jnp.asarray(R), jnp.asarray(xnew),
                            jnp.asarray(xold), jnp.asarray(ip))
    pot, f2 = kernels.pair_delta_ref(tsys, _t(R), _t(xnew), _t(xold),
                                     _ip_t(ip), with_force)
    u = kernels.pair_u_ref(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip))
    np.testing.assert_allclose(pot.numpy(), np.asarray(w_pot), rtol=2e-4,
                               atol=1e-4)
    np.testing.assert_allclose(f2.numpy(), np.asarray(w_f2), rtol=2e-4,
                               atol=1e-3)
    np.testing.assert_allclose(u.numpy(), np.asarray(w_u), rtol=2e-4,
                               atol=1e-4)


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_dense_delta_action_matches_reference(ip_form, with_force):
    """[W, B] rows at chain ends, odd and even beads, ib [B] and [W, B]."""
    cfg, jsys, tables, tsys = _systems(n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=4)
    ib = np.arange(cfg.M)
    args = (jnp.asarray(R), jnp.asarray(xnew), jnp.asarray(xold),
            jnp.asarray(ip))
    for ibx in (ib, np.broadcast_to(ib[::-1], (4, cfg.M))):
        want = jpw.delta_action(jsys, tables, *args, jnp.asarray(ibx),
                                with_force)
        got = delta_action(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                           _t(ibx), with_force)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _end_case(seed, **kw):
    cfg, jsys, tables, tsys = _systems(**kw)
    return (cfg, jsys, tables, tsys, lattice_paths(cfg, seed=seed),
            jax.random.key(seed + 50))


def _check(got, want, gacc, wacc):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(gacc.numpy(), np.asarray(wacc))


@pytest.mark.parametrize("tail", [False, True])
@pytest.mark.parametrize("level", [2, 3])
def test_per_level_end_bisection_dense_gate(level, tail):
    """The per-level end move without batched randoms: the gate through the
    dense delta_action, the depth max(level, 2)."""
    cfg, jsys, tables, tsys, paths, key = _end_case(
        10 + level + 2 * tail, bis_monoshot=False, Nlev=level)
    jfn = jbis.move_tail_bisection if tail else jbis.move_head_bisection
    tfn = bis.move_tail_bisection if tail else bis.move_head_bisection
    want, wacc = jfn(jsys, tables, key, jnp.asarray(paths), 3,
                     jnp.asarray(ACTIVE), level)
    depth, rand = end_bisect_draws(key, cfg.n_walkers, level, cfg.dim, F64,
                                   True, False)
    n = kernels.pair_delta.launches, kernels.pair_u.launches
    got, gacc = tfn(tsys, _t(paths), 3, _t(ACTIVE), depth, rand, True)
    _check(got, want, gacc, wacc)
    assert 0 < int(gacc.sum()) < int(ACTIVE.sum())
    assert n == (kernels.pair_delta.launches, kernels.pair_u.launches)


@pytest.mark.parametrize("tail", [False, True])
def test_per_level_end_bisection_rand(tail):
    """With batched randoms the gate is a row of delta_action_rows."""
    cfg, jsys, tables, tsys, paths, key = _end_case(
        20 + tail, bis_monoshot=False, Nlev=3)
    jr, tr = bisect_draws(key, cfg.n_walkers, 3, cfg.dim, F64)
    jfn = jbis.move_tail_bisection if tail else jbis.move_head_bisection
    tfn = bis.move_tail_bisection if tail else bis.move_head_bisection
    want, wacc = jfn(jsys, tables, key, jnp.asarray(paths), 5,
                     jnp.asarray(ACTIVE), 3, rand=jr)
    got, gacc = tfn(tsys, _t(paths), 5, _t(ACTIVE), 3, tr)
    _check(got, want, gacc, wacc)


def _depth_keys(level, n_depths):
    """Keys whose random end depth covers every depth 2..level."""
    seen = {}
    for seed in range(200):
        key = jax.random.key(seed)
        d = 2 + int(jax.random.randint(jax.random.split(key)[0], (), 0,
                                       level - 1))
        seen.setdefault(d, key)
        if len(seen) == n_depths:
            return [seen[d] for d in sorted(seen)]
    raise AssertionError(seen)


@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("tail", [False, True])
def test_random_depth_end_bisection_every_depth(tail, mono):
    """bis_end_random_depth: the depth U{2..level} drawn from the move's
    key; every depth, per level (dense gate) and monoshot."""
    level = 3
    cfg, jsys, tables, tsys, paths, _ = _end_case(
        30 + tail, bis_end_random_depth=True, bis_monoshot=mono, Nlev=level)
    jfn = jbis.move_tail_bisection if tail else jbis.move_head_bisection
    tfn = bis.move_tail_bisection if tail else bis.move_head_bisection
    depths = []
    for key in _depth_keys(level, level - 1):
        want, wacc = jfn(jsys, tables, key, jnp.asarray(paths), 2,
                         jnp.asarray(ACTIVE), level)
        depth, rand = end_bisect_draws(key, cfg.n_walkers, level, cfg.dim,
                                       F64, not mono, True)
        got, gacc = tfn(tsys, _t(paths), 2, _t(ACTIVE), depth, rand,
                        not mono)
        _check(got, want, gacc, wacc)
        depths.append(depth)
    assert depths == [2, 3]


@pytest.mark.parametrize("keyed", [False, True])
def test_paired_end_bisections_bitwise(keyed):
    """Paired ends equal the reference's paired ends, and equal the port's
    sequential head then tail bitwise."""
    cfg, jsys, tables, tsys, paths, key = _end_case(40 + keyed,
                                                    paired_ends=True)
    kh, kt = jax.random.split(key)
    W, D, nl = cfg.n_walkers, cfg.dim, max(cfg.Nlev, 2)
    if keyed:
        jrh = jrt = None
        rh = end_bisect_draws(kh, W, cfg.Nlev, D, F64, False, False)[1]
        rt = end_bisect_draws(kt, W, cfg.Nlev, D, F64, False, False)[1]
    else:
        jrh, rh = bisect_draws(kh, W, nl, D, F64)
        jrt, rt = bisect_draws(kt, W, nl, D, F64)
    want, wh, wt = jbis.paired_end_bisections(
        jsys, tables, kh, kt, jnp.asarray(paths), 4, jnp.asarray(ACTIVE),
        cfg.Nlev, rand_h=jrh, rand_t=jrt)
    got, gh, gt = bis.paired_end_bisections(tsys, _t(paths), 4, _t(ACTIVE),
                                            cfg.Nlev, rh, rt)
    _check(got, want, gh, wh)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))
    seq, sh = bis.move_head_bisection(tsys, _t(paths), 4, _t(ACTIVE),
                                      cfg.Nlev, rh)
    seq, st = bis.move_tail_bisection(tsys, seq, 4, _t(ACTIVE), cfg.Nlev, rt)
    assert torch.equal(seq, got) and torch.equal(sh, gh)
    assert torch.equal(st, gt) and int(gh.sum()) > 0


@pytest.fixture(scope="module", params=["reference_order", "paired_ends"])
def steps(request):
    kw = REF_ORDER if request.param == "reference_order" else dict(
        paired_ends=True)
    return step_pair(small_cfg(**kw))


def test_step_matches_reference(steps):
    """The reference order runs kernels 3 and 4 at every end move's gate
    (their plain forms here); counters, states and statistics equal."""
    counters = assert_step_pair(*steps, TOL)
    assert counters[2] > 0 and counters[4] > 0 and counters[5] > 0
