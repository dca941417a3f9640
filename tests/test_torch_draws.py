"""The law of the port's own draw source, utils/draws.DeviceDraws, against
the reference's draws at each site (tests/torch_bridge.JaxDraws, which
replays the reference step's JAX key tree).

Every parity test of a whole step feeds the port the reference's draws; the
card runs DeviceDraws.  So at each site that Sweeper.step draws from, both
sources are asked the same question and must answer with the same
structure: the same shapes and dtypes, integer tensors with the same
support, host ints (window starts, depths, offsets) with the same support
over repeated draws, and each float field the same law by a two-sample KS
test at W = 4096 (ALPHA per field).  Where the reference's per-level form
leaves a row or column it never reads at zero, only the entries it fills
are compared.  With tests/test_torch_invariance.py (the moves on these
draws leave the exact path measure invariant) this carries the step's
equality on equal draws over to the chain's law.
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from scipy import stats as sps
from torch_bridge import JaxDraws, other_cfg, small_cfg

from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.draws import DeviceDraws

torch.set_num_threads(1)

W = 4096
D = 3
NP = 8
LMAX = 8        # the staging / worm segment length
NLEV = 2
K = 3
N_OPTS = 5      # window-start choices
N_SHIFT = 3     # interior-shift choices of the K-slot composites
ALPHA = 1e-3
NREP = 64       # repeated draws for the supports of host ints

SITES = [
    ("iupdate", (W,)),
    ("cand", (W, NP)),
    ("worm", (1, W, LMAX)),
    ("worm", (3, W, LMAX)),
    ("translate", (10, 0, W)),
    ("translate", (31, 2, W)),
    ("bisect", (25, 0, W, NLEV)),
    ("bisect", (27, 1, W, NLEV, N_OPTS)),
    ("bisect_keyed", (22, 0, W, NLEV, N_OPTS, False)),
    ("bisect_keyed", (22, 0, W, NLEV, N_OPTS, True)),
    ("end_bisect", (20, 0, W, NLEV, False, False)),
    ("end_bisect", (21, 0, W, NLEV, True, False)),
    ("end_bisect", (20, 3, W, 3, False, True)),
    ("end_bisect", (21, 3, W, 3, True, True)),
    ("fused_ends", (0, W, NLEV)),
    ("fused_ends_keyed", (0, W, NLEV, False)),
    ("fused_ends_keyed", (0, W, NLEV, True)),
    ("group_offset", (0, NP)),
    ("bisect_multi", (0, W, K, NLEV, N_SHIFT)),
    ("bisect_multi_keyed", (0, W, K, NLEV, N_SHIFT, False)),
    ("bisect_multi_keyed", (0, W, K, NLEV, N_SHIFT, True)),
    ("end_stagings", (0, W, LMAX)),
    ("cascade_ends", (0, W, NLEV)),
    ("cascade_interior", (0, W, K, NLEV, N_SHIFT)),
    ("regrow_half", (41, 0, W, LMAX)),
    ("staging_half", (45, 0, W, N_OPTS, LMAX)),
    ("swap", (0, W, NP, LMAX)),
    ("mala", ((W, 5, NP, D),)),
]


def _id(site):
    name, args = site
    return f"{name}{args}".replace(" ", "")


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [leaf for e in x for leaf in _leaves(e)]
    return [x]


def _sources(seed):
    system = make_system(other_cfg(small_cfg(dim=D, Np=NP)), "cpu")
    port = DeviceDraws(system, torch.Generator().manual_seed(seed),
                       torch.Generator().manual_seed(seed + 1))
    ref = JaxDraws(jax.random.key(seed), D, jnp.float64)
    return port, ref


def _draw(src, name, args):
    src.begin_step()
    return _leaves(getattr(src, name)(*args))


def _with_w(args, w):
    """args with every W replaced by w (the supports of host ints do not
    depend on the walker count)."""
    return tuple(w if a == W else a for a in args)


@pytest.mark.parametrize("site", SITES, ids=_id)
def test_device_draws_follow_the_reference_law(site):
    name, args = site
    port, ref = _sources(seed=3)
    got, want = _draw(port, name, args), _draw(ref, name, args)
    assert len(got) == len(want)
    if name == "end_bisect" and args[-1]:
        # a random depth: each block's shape follows its own depth; the
        # depths' support is compared below, the blocks' law at a fixed
        # depth by the cases without random_depth
        for depth, _, g, u in (got, want):
            assert g.shape == (W, 2 ** depth, D) and u.shape == (W, depth + 1)
        got, want = got[:1], want[:1]
    for i, (g, w) in enumerate(zip(got, want)):
        what = f"{name} leaf {i}"
        if w is None or isinstance(w, int):
            assert type(g) is type(w), what
            continue
        assert g.dtype == w.dtype and g.shape == w.shape, what
        if not w.is_floating_point():
            assert set(g.unique().tolist()) == set(w.unique().tolist()), what
            continue
        used = w != 0.0            # the entries the reference's form fills
        assert int(used.sum()) >= W, what
        p = sps.ks_2samp(g[used].numpy(), w[used].numpy()).pvalue
        assert p > ALPHA, f"{what}: two-sample KS p={p:.2e}"
    ints = [i for i, w in enumerate(want) if isinstance(w, int)]
    if ints:
        small = _with_w(args, 8)
        seen_g = {i: set() for i in ints}
        seen_w = {i: set() for i in ints}
        for _ in range(NREP):
            g, w = _draw(port, name, small), _draw(ref, name, small)
            for i in ints:
                seen_g[i].add(g[i])
                seen_w[i].add(w[i])
        assert seen_g == seen_w, (seen_g, seen_w)


# ---------------------------------------------------------------------------
# Per-walker window starts, and the draws of a walker-sharded rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("site", [
    ("bisect_keyed", (22, 0, W, NLEV, N_OPTS, False)),
    ("bisect_keyed", (22, 0, W, NLEV, N_OPTS, True)),
    ("staging_half", (45, 0, W, N_OPTS, LMAX)),
], ids=_id)
def test_per_walker_starts_follow_the_reference_law(site):
    """With shared_windows=False the start is per walker: a long tensor [W]
    of even starts with the reference's support, and its law by a
    two-sample KS test (ALPHA) at W = 4096 (moves._window_start,
    bisection._draw_monoshot with start_shape (W,))."""
    name, args = site
    system = make_system(other_cfg(small_cfg(dim=D, Np=NP,
                                             shared_windows=False)), "cpu")
    port = DeviceDraws(system, torch.Generator().manual_seed(3),
                       torch.Generator().manual_seed(4))
    ref = JaxDraws(jax.random.key(3), D, jnp.float64, shared=False)
    got, want = _draw(port, name, args)[0], _draw(ref, name, args)[0]
    assert got.dtype == want.dtype == torch.long
    assert got.shape == want.shape == (W,)
    assert set(got.unique().tolist()) == set(want.unique().tolist()) \
        == set(range(0, 2 * N_OPTS, 2))
    assert sps.ks_2samp(got.numpy(), want.numpy()).pvalue > ALPHA


@pytest.mark.parametrize("shared", [True, False], ids=["shared",
                                                       "per_walker"])
@pytest.mark.parametrize("site", SITES, ids=_id)
def test_dp_rank_draws_its_rows_of_the_unsharded_draws(site, shared):
    """A rank of a dp = 2 mesh draws every block for all the walkers and
    keeps its own rows (both runs of walkers of the fused ends' [2W]
    blocks), and the host ints alike: each rank's draws are its rows of
    the unsharded draws of the same generators (parallel/mesh.py)."""
    from pathintegralgroundstate_torch.parallel.mesh import Mesh
    name, args = site
    w = 8
    cfg = other_cfg(small_cfg(dim=D, Np=NP, shared_windows=shared))
    full = _leaves_of(make_system(cfg, "cpu"), name, _walkers(args, w))
    for rank in range(2):
        mesh = Mesh(dp=2, tp=1, rank=rank, backend="gloo")
        got = _leaves_of(make_system(cfg, "cpu", mesh=mesh), name,
                         _walkers(args, w // 2))
        assert len(got) == len(full)
        rows = slice(rank * w // 2, (rank + 1) * w // 2)
        for g, f in zip(got, full):
            if not isinstance(f, torch.Tensor):
                assert g == f
                continue
            ax = next(i for i, n in enumerate(f.shape) if n in (w, 2 * w))
            if f.shape[ax] == 2 * w:          # head walkers, tail walkers
                f = torch.cat([f.narrow(ax, b * w, w)[
                    (slice(None),) * ax + (rows,)] for b in (0, 1)], ax)
            else:
                f = f[(slice(None),) * ax + (rows,)]
            assert torch.equal(g, f), name


def _leaves_of(system, name, args):
    src = DeviceDraws(system, torch.Generator().manual_seed(9),
                      torch.Generator().manual_seed(10))
    return _draw(src, name, args)


def _walkers(args, w):
    """args with every W, also inside a shape tuple, replaced by w."""
    return tuple(_walkers(a, w) if isinstance(a, tuple) else
                 w if a == W else a for a in args)
