"""The torch window pass and all-pairs sums against the reference (in 3-D,
and in 2-D on a He-4 film under PBC).

Float64 on the CPU against the reference's jnp path (rtol 1e-10, atol 1e-12:
reassociation only); float32 against the Pallas kernels in interpret mode,
with tests/test_pallas_kernel.py's tolerances.  The plain form of kernel A
(kernels.pair_rows_ref) weights and sums the rows itself, so every case
of delta_action_rows and delta_action_sum here is a case of it too.  The
hand-written kernels against their plain forms: tests/test_torch_cuda.py
(on a CUDA device).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch_bridge import lattice_paths, other_cfg, small_cfg

from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table, \
    delta_action_rows, delta_action_sum, pair_pot
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import pairwise as jpw
from pathintegralgroundstate_tpu.ops.pallas_kernels import pair_pot_pallas, \
    pair_rows_pallas
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)


IP_FORMS = ["scalar", "walker", "row", "span"]


def _window(cfg, ip_form, seed=0, dtype=np.float64, coincident=True):
    """(R, xnew, xold, ip) numpy: a whole-chain window (both chain ends, odd
    and even beads), with one exactly coincident partner row.  ip_form:
    'scalar' int, 'walker' [W], 'row' [W, B], 'span' [1, B] (one particle
    per window row for every walker)."""
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
        ip = rng.integers(0, N, (W, B) if ip_form == "row" else (1, B))
        ipb = np.broadcast_to(ip, (W, B))
        xold = np.take_along_axis(paths, ipb[:, :, None, None], 2)[:, :, 0]
        p3 = ipb[1, 2]
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
    return make_system(other_cfg(cfg), "cpu")


def _beads(cfg, ib_form, B, seed, first=0):
    """Bead indices of B window rows: [B] from `first`, or [W, B] drawn per
    walker and row ('walker')."""
    if ib_form == "beads":
        return np.arange(first, first + B)
    rng = np.random.default_rng(seed + 7)
    return rng.integers(0, cfg.M, (cfg.n_walkers, B))


@pytest.mark.parametrize("ib_form", ["beads", "walker"])
@pytest.mark.parametrize("need_wf,need_f2", [(True, True), (True, False),
                                             (False, True), (False, False)])
@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_delta_action_rows_matches_reference(ip_form, need_wf, need_f2,
                                             ib_form):
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form)
    ib = _beads(cfg, ib_form, cfg.M, seed=0)
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


@pytest.mark.parametrize("ib_form", ["beads", "walker"])
@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_reversed_window_matches_reference(ip_form, ib_form):
    """rev=True reads a forward window backwards: the reference's [:, ::-1]
    view."""
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=3)
    B = 9
    Rf = R[:, 2:2 + B]                        # forward beads 2..10
    xn, xo = xnew[:, :B], xold[:, :B]         # rows: beads 10, 9, .., 2
    if not isinstance(ip, int) and ip.ndim == 2:
        ip = np.ascontiguousarray(ip[:, :B])
    ib = (np.arange(10, 1, -1) if ib_form == "beads"
          else _beads(cfg, ib_form, B, seed=3))
    jsys = j_make_system(cfg)
    want = jpw.delta_action_rows(jsys, make_tables(jsys),
                                 jnp.asarray(Rf[:, ::-1]), jnp.asarray(xn),
                                 jnp.asarray(xo), jnp.asarray(ip),
                                 jnp.asarray(ib))
    got = delta_action_rows(_tsys(cfg), _t(Rf), _t(xn), _t(xo),
                            _ip_t(ip), _t(ib), rev=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ib_form", ["beads", "walker"])
@pytest.mark.parametrize("rev", [False, True])
@pytest.mark.parametrize("weights", [True, False])
def test_delta_action_sum_row_weights_matches_reference(weights, rev,
                                                        ib_form):
    """The walker sums, with the worm centre's 1/2 on row 0 or without row
    weights, over a forward window or one read backwards (rev)."""
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, "walker", seed=5)
    ib = _beads(cfg, ib_form, cfg.M, seed=5)
    rw = np.ones(cfg.M)
    rw[0] = 0.5
    jsys = j_make_system(cfg)
    want = jpw.delta_action_sum(jsys, make_tables(jsys),
                                jnp.asarray(R[:, ::-1] if rev else R),
                                jnp.asarray(xnew), jnp.asarray(xold),
                                jnp.asarray(ip), jnp.asarray(ib),
                                row_weights=jnp.asarray(rw) if weights
                                else None)
    got = delta_action_sum(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                           _ip_t(ip), _t(ib),
                           row_weights=_t(rw) if weights else None, rev=rev)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_delta_action_sum_without_forces_matches_reference(ip_form):
    """need_f2=False (every row's F^2 weight zero) sums the reference's
    need_f2=False rows."""
    cfg = small_cfg(Np=8, n_walkers=4)
    R, xnew, xold, ip = _window(cfg, ip_form, seed=6)
    R, xnew, xold = R[:, 2::2], xnew[:, 2::2], xold[:, 2::2]
    if not isinstance(ip, int) and ip.ndim == 2:
        ip = np.ascontiguousarray(ip[:, 2::2])
    ib = np.arange(2, cfg.M, 2)
    jsys = j_make_system(cfg)
    want = jpw.delta_action_rows(jsys, make_tables(jsys), jnp.asarray(R),
                                 jnp.asarray(xnew), jnp.asarray(xold),
                                 jnp.asarray(ip), jnp.asarray(ib),
                                 need_f2=False).sum(-1)
    got = delta_action_sum(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                           _ip_t(ip), _t(ib), need_f2=False)
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


# --- a 2-D He-4 film under PBC (density 0.26 sigma^-2) ----------------------

def _film_cfg(**kw):
    return small_cfg(dim=2, density=0.26, Np=8, n_walkers=4, **kw)


@pytest.mark.parametrize("need_wf,need_f2", [(True, True), (False, False)])
@pytest.mark.parametrize("ip_form", IP_FORMS)
def test_2d_delta_action_rows_matches_reference(ip_form, need_wf, need_f2):
    cfg = _film_cfg()
    R, xnew, xold, ip = _window(cfg, ip_form, seed=13)
    ib = _beads(cfg, "beads", cfg.M, seed=13)
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


@pytest.mark.parametrize("rev", [False, True])
def test_2d_delta_action_sum_matches_reference(rev):
    cfg = _film_cfg()
    R, xnew, xold, ip = _window(cfg, "walker", seed=14)
    ib = np.arange(cfg.M)
    rw = np.r_[0.5, np.ones(cfg.M - 1)]
    jsys = j_make_system(cfg)
    want = jpw.delta_action_sum(jsys, make_tables(jsys),
                                jnp.asarray(R[:, ::-1] if rev else R),
                                jnp.asarray(xnew), jnp.asarray(xold),
                                jnp.asarray(ip), jnp.asarray(ib),
                                row_weights=jnp.asarray(rw))
    got = delta_action_sum(_tsys(cfg), _t(R), _t(xnew), _t(xold),
                           _ip_t(ip), _t(ib), row_weights=_t(rw), rev=rev)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("with_force", [False, True])
def test_2d_pair_pot_matches_reference(with_force):
    cfg = _film_cfg()
    R = lattice_paths(cfg, seed=15)
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
    """The raw terms (pair_terms_ref) against the Pallas kernel's, and the
    weighted rows (pair_rows_ref) against its terms weighted by the
    reference's chin_weights, each term's tolerance weighted as the term.
    No coincident partner here: the Pallas kernel forms r as r2 *
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
    tsys = _tsys(cfg)
    got = kernels.pair_terms_ref(tsys, _t(R), _t(xnew), _t(xold),
                                 _ip_t(ip), need_wf=need_wf)
    tols = [(2e-4, 1e-4), (2e-4, 1e-3), (2e-4, 1e-4)]
    for g, w, (rtol, atol) in zip(got[:2 + need_wf], want, tols):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol,
                                   atol=atol)
    ib = np.arange(5)
    wv, wf, wpsi = (np.asarray(x) for x in jpw.chin_weights(
        jsys, jnp.asarray(ib), jnp.float32))
    dS = wv * np.asarray(want[0]) + wf * np.asarray(want[1])
    tol = wv * (1e-4 + 2e-4 * np.abs(want[0])) \
        + wf * (1e-3 + 2e-4 * np.abs(want[1]))
    if need_wf:
        dS = dS - wpsi * np.asarray(want[2])
        tol = tol + wpsi * (1e-4 + 2e-4 * np.abs(want[2]))
    rows = kernels.pair_rows_ref(tsys, _t(R), _t(xnew), _t(xold), _ip_t(ip),
                                 chin_table(tsys), _t(ib), need_wf=need_wf)
    assert (np.abs(rows.numpy() - dS) <= tol).all()


# --- wrappers ---------------------------------------------------------------

@pytest.mark.parametrize("reduce", [False, True])
def test_cpu_tensors_take_the_plain_form_and_count_no_launch(reduce):
    cfg = small_cfg(Np=8, n_walkers=4)
    system = _tsys(cfg)
    R, xnew, xold, ip = _window(cfg, "scalar")
    args = (system, _t(R), _t(xnew), _t(xold), ip, chin_table(system),
            torch.arange(cfg.M))
    n_rows, n_pot = kernels.pair_rows.launches, kernels.pair_pot.launches
    got = kernels.pair_rows(*args, reduce=reduce)
    assert torch.equal(got, kernels.pair_rows_ref(*args, reduce=reduce))
    assert got.shape == ((cfg.n_walkers,) if reduce
                         else (cfg.n_walkers, cfg.M))
    kernels.pair_pot(system, _t(R), True)
    assert (kernels.pair_rows.launches, kernels.pair_pot.launches) == \
        (n_rows, n_pot)


@pytest.mark.parametrize("B,G", [(1, 32), (2, 32), (4, 16), (8, 8), (16, 4),
                                 (32, 4), (65, 4)])
def test_rows_lanes_rule(B, G):
    """Kernel A's lanes per row at W=1024, N=64 (the rule PERF.md measured:
    the fewest lanes whose W*B*G threads reach ROWS_FILL), and never more
    than the partners' power of two."""
    assert kernels.rows_lanes(1024, B, 64) == G
    assert kernels.rows_lanes(4, B, 8) <= 8


@pytest.mark.parametrize("esize", [4, 8])
@pytest.mark.parametrize("B", [1, 16, 65, 300])
@pytest.mark.parametrize("G", kernels.ROWS_LANES)
def test_rows_layout_fits_a_block(G, B, esize):
    """Every row gets a slot, a block holds at most 512 threads and its
    shared memory fits, and slot g of a warp starts D*G elements (G lanes
    of one partner each) after slot g-1 modulo the 32 banks."""
    N, D = 64, 3
    spw, wpb, slab, smem = kernels.rows_layout(1024, B, N, D, esize, G)
    assert 1 <= spw <= B and G * spw <= 512 and G * spw * wpb <= 512
    assert smem <= kernels.SMEM_MAX and slab >= N * D
    bank = 32 * 4 // esize
    assert (slab - D * G) % bank == 0 and slab - N * D < bank


def test_cascade_smem_counts_every_buffer():
    """Kernel 5's shared memory at the flagship: the window's 17 rows of 64
    particles, 3 x 17 x 3 positions and gaussians, the 5 gate uniforms and
    two row-sum sets of max(L/2, threads/4) entries (64 threads)."""
    assert kernels.cascade_smem(16, 64, 3, 4, 5) == \
        (17 * 64 * 3 + 9 * 17 + 5 + 2 * 16) * 4
    assert kernels.cascade_smem(16, 64, 3, 8, 4) == \
        (17 * 64 * 3 + 9 * 17 + 4 + 2 * 16) * 8
    assert kernels.cascade_smem(64, 31, 3, 8, 7) == \
        (65 * 31 * 3 + 9 * 65 + 7 + 2 * 32) * 8


def _slab_views():
    """(name, view, whether its [N, D] slabs are aligned 16-byte runs)."""
    f64 = torch.zeros(2 * 65 * 64 * 3 + 2, dtype=torch.float64)
    f32 = torch.zeros(2 * 65 * 30 * 3 + 4, dtype=torch.float32)
    wide = torch.zeros(2, 65, 128, 3, dtype=torch.float64)
    paths = f64[:2 * 65 * 64 * 3].view(2, 65, 64, 3)
    return [("paths", paths, True),
            ("window view", paths[:, 3:19], True),
            ("reversed-start window", paths[:, 1:17], True),
            ("start 8 bytes past", f64[1:1 + 2 * 65 * 64 * 3].view(
                2, 65, 64, 3), False),
            ("N=30 float32", f32[:2 * 65 * 30 * 3].view(2, 65, 30, 3),
             False),
            ("N=31 float64", f64[:2 * 65 * 31 * 3].view(2, 65, 31, 3),
             False),
            ("strided particles", wide[:, :, ::2], False)]


@pytest.mark.parametrize("case", range(len(_slab_views())))
def test_slabs16_sees_the_layout(case):
    """Kernels A and 5 stage partners with 16-byte (bulk) copies only where
    every [N, D] slab is a contiguous run of 16-byte multiples at an
    aligned address; any other layout they read element by element, and
    the wrapper decides from the strides and the start alone."""
    name, view, want = _slab_views()[case]
    assert view.data_ptr() % 16 == 0 or not want
    assert kernels.slabs16(view) is want, name


@pytest.mark.parametrize("B", [1, 2, 16, 65])
@pytest.mark.parametrize("G", kernels.ROWS_LANES)
def test_lanes_walkers_reach_every_lane_width(G, B):
    """The card tests (tests/torch_card.py) cover each lane-group width of
    kernel A by the walker count at which the wrapper's rule picks it."""
    import torch_card
    W = torch_card.lanes_walkers(G, B)
    assert kernels.rows_lanes(W, B, 64) == G
    assert W == 1 or kernels.rows_lanes(W - 1, B, 64) != G or G == 32
