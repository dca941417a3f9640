"""Every move of the flagship path against the reference move on identical
draws (tests/torch_bridge.py splits the reference's key as its move does):
paths and xend at rtol 1e-10, accept masks and swap partners exactly equal.
Float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_bridge import bisect_draws, half_draws, lattice_paths, \
    other_cfg, small_cfg, staging_half_draws, swap_draws, translate_draws, \
    worm_draws

from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import moves as mv
from pathintegralgroundstate_torch.ops import worm as wm
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_tpu.ops import bisection as jbis
from pathintegralgroundstate_tpu.ops import moves as jmv
from pathintegralgroundstate_tpu.ops import worm as jwm
from pathintegralgroundstate_tpu.system import make_system as j_make_system
from pathintegralgroundstate_tpu.system import make_tables

torch.set_num_threads(1)

TOL = dict(rtol=1e-10, atol=1e-12)
F64 = jnp.float64
ACTIVE = np.array([True, True, False, True, True, True, False, True])


class Case:
    """One configuration, in both frameworks."""

    def __init__(self, seed=0, **kw):
        self.cfg = cfg = small_cfg(**kw)
        self.jsys = j_make_system(cfg)
        self.tables = make_tables(self.jsys)
        self.tsys = make_system(other_cfg(cfg), "cpu")
        self.W, self.D, self.Nb = cfg.n_walkers, cfg.dim, cfg.Nb
        self.paths = lattice_paths(cfg, seed=seed)
        rng = np.random.default_rng(seed + 100)
        self.iworm = rng.integers(0, cfg.Np, self.W).astype(np.int32)
        centre = self.paths[np.arange(self.W), cfg.Nb, self.iworm]
        self.xend = centre[:, None] + 0.05 * rng.normal(size=(self.W, 2,
                                                              self.D))
        self.key = jax.random.key(seed + 7)

    def j(self, x):
        return jnp.asarray(x)

    def t(self, x):
        return torch.from_numpy(np.array(x))

    def check(self, got_paths, want_paths, got_acc, want_acc, got_xend=None,
              want_xend=None):
        np.testing.assert_allclose(got_paths.numpy(), np.asarray(want_paths),
                                   **TOL)
        np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
        if got_xend is not None:
            np.testing.assert_allclose(got_xend.numpy(),
                                       np.asarray(want_xend), **TOL)


@pytest.mark.parametrize("ip", [0, 5])
def test_translate_chain(ip):
    c = Case(seed=ip)
    delta = c.jsys.geo.delta_cm
    want, acc = jmv.translate_chain(c.jsys, c.tables, c.key, c.j(c.paths),
                                    ip, c.j(ACTIVE), delta)
    got, gacc = mv.translate_chain(c.tsys, c.t(c.paths), ip, c.t(ACTIVE),
                                   delta, *translate_draws(c.key, c.W, c.D,
                                                           F64))
    c.check(got, want, gacc, acc)


@pytest.mark.parametrize("level", [2, 3])
@pytest.mark.parametrize("move", ["interior", "head", "tail"])
def test_monoshot_bisection(move, level):
    c = Case(seed=level)
    ip = 3
    nlev = level if move == "interior" else max(level, 2)
    n_opts = (c.cfg.M - 1 - 2 ** nlev) // 2 + 1
    jr, tr = bisect_draws(c.key, c.W, nlev, c.D, F64,
                          n_opts if move == "interior" else None)
    jfn = {"interior": jbis.bisection, "head": jbis.move_head_bisection,
           "tail": jbis.move_tail_bisection}[move]
    tfn = {"interior": bis.bisection, "head": bis.move_head_bisection,
           "tail": bis.move_tail_bisection}[move]
    want, acc = jfn(c.jsys, c.tables, c.key, c.j(c.paths), ip, c.j(ACTIVE),
                    level, rand=jr)
    got, gacc = tfn(c.tsys, c.t(c.paths), ip, c.t(ACTIVE), level, tr)
    c.check(got, want, gacc, acc)


@pytest.mark.parametrize("half", [1, 2])
def test_translate_half_chain(half):
    c = Case(seed=10 + half)
    delta = c.jsys.geo.delta_cm
    want, wx, acc = jmv.translate_half_chain(
        c.jsys, c.tables, c.key, c.j(c.paths), c.j(c.xend), c.j(c.iworm),
        half, c.j(ACTIVE), delta)
    got, gx, gacc = mv.translate_half_chain(
        c.tsys, c.t(c.paths), c.t(c.xend), c.t(c.iworm).long(), half,
        c.t(ACTIVE), delta, *translate_draws(c.key, c.W, c.D, F64))
    c.check(got, want, gacc, acc, gx, wx)


@pytest.mark.parametrize("Lstag", [4, 8])
@pytest.mark.parametrize("half", [1, 2])
@pytest.mark.parametrize("move", ["head", "tail", "staging"])
def test_half_chain_moves(move, half, Lstag):
    c = Case(seed=20 + half + Lstag, Lstag=Lstag)
    jfn = {"head": jmv.move_head_half_chain, "tail": jmv.move_tail_half_chain,
           "staging": jmv.staging_half_chain}[move]
    tfn = {"head": mv.move_head_half_chain, "tail": mv.move_tail_half_chain,
           "staging": mv.staging_half_chain}[move]
    if move == "staging":
        draws = staging_half_draws(c.key, c.W, (c.Nb - Lstag) // 2 + 1,
                                   Lstag, c.D, F64)
    else:
        draws = half_draws(c.key, c.W, Lstag, c.D, F64)
    want, wx, acc = jfn(c.jsys, c.tables, c.key, c.j(c.paths), c.j(c.xend),
                        c.j(c.iworm), half, c.j(ACTIVE), Lstag)
    got, gx, gacc = tfn(c.tsys, c.t(c.paths), c.t(c.xend),
                        c.t(c.iworm).long(), half, c.t(ACTIVE), Lstag,
                        *draws)
    c.check(got, want, gacc, acc, gx, wx)


@pytest.mark.parametrize("Lstag", [4, 8])
@pytest.mark.parametrize("move", ["open", "close"])
def test_open_close(move, Lstag):
    c = Case(seed=30 + Lstag, Lstag=Lstag)
    jfn = {"open": jwm.open_chain, "close": jwm.close_chain}[move]
    tfn = {"open": wm.open_chain, "close": wm.close_chain}[move]
    want, wx, acc = jfn(c.jsys, c.tables, c.key, c.j(c.paths), c.j(c.xend),
                        c.j(c.iworm), c.j(ACTIVE), Lstag)
    got, gx, gacc = tfn(c.tsys, c.t(c.paths), c.t(c.xend),
                        c.t(c.iworm).long(), c.t(ACTIVE), Lstag,
                        worm_draws(c.key, c.W, Lstag, c.D, F64))
    c.check(got, want, gacc, acc, gx, wx)


@pytest.mark.parametrize("Lstag", [4, 8])
def test_swap_move(Lstag):
    c = Case(seed=40 + Lstag, Lstag=Lstag)
    # put each worm tail next to another particle's centre bead, so some
    # walkers pick a partner other than the worm and regrow it
    other = (c.iworm + 1) % c.cfg.Np
    c.xend[:, 1] = (c.paths[np.arange(c.W), c.Nb, other]
                    + 0.05 * np.random.default_rng(0).normal(size=(c.W, 3)))
    want, wx, acc, wk = jwm.swap_move(c.jsys, c.tables, c.key, c.j(c.paths),
                                      c.j(c.xend), c.j(c.iworm), c.j(ACTIVE),
                                      Lstag)
    got, gx, gacc, gk = wm.swap_move(c.tsys, c.t(c.paths), c.t(c.xend),
                                     c.t(c.iworm).long(), c.t(ACTIVE), Lstag,
                                     swap_draws(c.key, c.W, c.cfg.Np, Lstag,
                                                c.D, F64))
    c.check(got, want, gacc, acc, gx, wx)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))


def test_gumbel_pick_is_jax_categorical():
    """The bridge's Gumbel-max pick equals jax.random.categorical."""
    key = jax.random.key(3)
    logits = jax.random.normal(jax.random.key(4), (64, 9), F64)
    g = jax.random.gumbel(key, logits.shape, F64)
    np.testing.assert_array_equal(
        np.asarray(jnp.argmax(logits + g, -1)),
        np.asarray(jax.random.categorical(key, logits)))


def test_segment_regrow_bridge_tables_match_reference():
    for Lmax, dt in ((4, 5e-3), (33, 5e-3)):
        for got, want in zip(mv._bridge_tables(Lmax, dt),
                             jmv._bridge_tables(Lmax, dt)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("level", [2, 4])
def test_bisection_tables_match_reference(level):
    for got, want in zip(bis._dyadic_tables(level, 5e-3),
                         jbis._dyadic_tables(level, 5e-3)):
        np.testing.assert_array_equal(got, want)
    for gate in (False, True):
        np.testing.assert_array_equal(bis._level_assign(level, gate),
                                      jbis._level_assign(level, gate))
