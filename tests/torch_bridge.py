"""Test helper: the reference's own jax.random draws, handed to the torch port.

Each `*_draws(key, ...)` function splits a move-site key exactly as the
reference move consumes it and returns the draws as torch tensors, in the
argument layout of the torch move.  `JaxDraws` is a draw source for the torch
`Sweeper.step` (same methods as utils/draws.DeviceDraws) that replays the
reference step's key tree: split(state.key) -> k_step, then the fold_in tags
of pathintegralgroundstate_tpu/sweep.py, in the batched-randoms branch and
without it (`*_keyed`, `end_bisect`), whichever the step takes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pathintegralgroundstate_torch import config as tconfig
from pathintegralgroundstate_torch.ops.worm import SwapDraws, WormDraws
from pathintegralgroundstate_tpu import config as jconfig

split, fold_in = jax.random.split, jax.random.fold_in


def tt(x):
    """jax array -> torch tensor (a copy, same dtype)."""
    return torch.from_numpy(np.array(x))


def ti(x):
    """jax integer array -> torch long tensor."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def other_cfg(cfg):
    """The other package's SimConfig with the same fields: the port's for a
    reference cfg, the reference's for a port cfg."""
    other = (jconfig.SimConfig if isinstance(cfg, tconfig.SimConfig)
             else tconfig.SimConfig)
    return other(**dataclasses.asdict(cfg))


def translate_draws(key, W, D, dtype):
    """moves.translate_chain / translate_half_chain: (u_dx, u_acc).  Also
    cascade_kernels.rigid_cascade, which splits its key the same way and
    draws as many uniforms ([W, 1, 1, D] and [W, 1, 1]): the same values."""
    k_dx, k_acc = split(key)
    return (tt(jax.random.uniform(k_dx, (W, 1, D), dtype)),
            tt(jax.random.uniform(k_acc, (W,), dtype)))


def regrow_draws(k_reg, W, Lb, D, dtype):
    """moves.segment_regrow: (g0 [W, D], gs [Lb-1, W, D])."""
    k_first, k_stag = split(k_reg)
    return (tt(jax.random.normal(k_first, (W, D), dtype)),
            tt(jax.random.normal(k_stag, (Lb - 1, W, D), dtype)))


def worm_draws(key, W, Lmax, D, dtype):
    """worm.open_chain / close_chain: both halves share k_reg."""
    k_ls, k_half, k_reg, k_acc = split(key, 4)
    Ls = 2 * jax.random.randint(k_ls, (W,), 0, (Lmax - 2) // 2,
                                dtype=jnp.int32) + 2
    half = jax.random.randint(k_half, (W,), 0, 2)
    g0, gs = regrow_draws(k_reg, W, Lmax - 2, D, dtype)
    return WormDraws(ti(Ls), ti(half), g0, gs,
                     tt(jax.random.uniform(k_acc, (W,), dtype)))


def half_draws(key, W, Lmax, D, dtype):
    """moves.move_head/tail_half_chain: (Ls, g0, gs, u_acc)."""
    k_ls, k_reg, k_acc = split(key, 3)
    Ls = jax.random.randint(k_ls, (W,), 0, Lmax - 1, dtype=jnp.int32) + 2
    g0, gs = regrow_draws(k_reg, W, Lmax, D, dtype)
    return ti(Ls), g0, gs, tt(jax.random.uniform(k_acc, (W,), dtype))


def _window_start(key, W, n_opts, shared):
    """moves._window_start (moves.py:161-176): 2 randint over n_opts, one
    host int shared by every walker, or per walker a long tensor [W]."""
    ii = 2 * jax.random.randint(key, () if shared else (W,), 0, n_opts,
                                dtype=jnp.int32)
    return int(ii) if shared else ti(ii)


def staging_half_draws(key, W, n_opts, L, D, dtype, shared=True):
    """moves.staging_half_chain / staging_move: (start, gs, u_acc); the
    start per walker without shared windows."""
    k_ii, k_reg, k_acc = split(key, 3)
    start = _window_start(k_ii, W, n_opts, shared)
    _, gs = regrow_draws(k_reg, W, L, D, dtype)
    return start, gs, tt(jax.random.uniform(k_acc, (W,), dtype))


def sp_draws(key, W, S, n_opts, L, D, dtype):
    """parallel/beadshard._shard_move's draws for each of the S shards of
    one SP sweep call with key `key`: fold_in(key, k) -> split(3) ->
    (2 randint start, the bridge gaussians of segment_regrow, the accept
    uniform) (beadshard.py:70-76, 84-85)."""
    out = []
    for k in range(S):
        k_ii, k_reg, k_acc = split(fold_in(key, k), 3)
        ii = 2 * int(jax.random.randint(k_ii, (), 0, n_opts, dtype=jnp.int32))
        _, gs = regrow_draws(k_reg, W, L, D, dtype)
        out.append((ii, gs, tt(jax.random.uniform(k_acc, (W,), dtype))))
    return out


def swap_draws(key, W, N, Lmax, D, dtype):
    """worm.swap_move: categorical = argmax(logits + gumbel(k_pick)); the
    pre-accept uniform is drawn in JAX's default float type."""
    k_ls, k_pick, k_pre, k_reg, k_acc = split(key, 5)
    Ls = 2 * jax.random.randint(k_ls, (W,), 0, (Lmax - 2) // 2,
                                dtype=jnp.int32) + 2
    _, gs = regrow_draws(k_reg, W, Lmax - 2, D, dtype)
    return SwapDraws(ti(Ls), tt(jax.random.gumbel(k_pick, (W, N), dtype)),
                     tt(jax.random.uniform(k_pre, (W,))), gs,
                     tt(jax.random.uniform(k_acc, (W,), dtype)))


def mala_draws(key, shape, dtype):
    """smartmc.mala_move: split(key) -> k_xi, k_acc; (xi, u)."""
    k_xi, k_acc = split(key)
    return (tt(jax.random.normal(k_xi, shape, dtype)),
            tt(jax.random.uniform(k_acc, (shape[0],), dtype)))


def _start(u, n_opts):
    """The reference's even window start 2 floor(u n_opts), a host int
    (bisection.py:256, 916)."""
    return int(2 * jnp.floor(u * n_opts).astype(jnp.int32))


def _level_rows(k_levels, k_acc, shape, nlev, D, dtype):
    """The per-level key form's draws (bisection.py:468-497) laid out as the
    port's rand blocks: g [*shape, L, D] with level ilev's
    normal(k_levels[ilev-1], [*shape, m, D]) at window rows d2::delta (row 0
    zero), u [*shape, nlev+1] with uniform(fold_in(k_acc, ilev), shape) in
    column ilev (column 0 zero)."""
    g = np.zeros(shape + (2 ** nlev, D), np.dtype(dtype))
    u = np.zeros(shape + (nlev + 1,), np.dtype(dtype))
    for ilev in range(1, nlev + 1):
        delta, m = 2 ** (nlev - ilev + 1), 2 ** (ilev - 1)
        g[..., delta // 2::delta, :] = jax.random.normal(
            k_levels[ilev - 1], shape + (m, D), dtype)
        u[..., ilev] = jax.random.uniform(fold_in(k_acc, ilev), shape, dtype)
    return g, u


def _gate_rows(k_g, k_acc0, k_lev, shape, nlev, D, dtype):
    """An end move's per-level key form (split(key, nlev+3) = k_g, k_acc0,
    k_lev): the gate's gaussian and uniform in row / column 0."""
    g, u = _level_rows(k_lev, k_lev[-1], shape, nlev, D, dtype)
    g[..., 0, :] = jax.random.normal(k_g, shape + (D,), dtype)
    u[..., 0] = jax.random.uniform(k_acc0, shape, dtype)
    return tt(g), tt(u)


def bisect_draws(kk, W, nlev, D, dtype, n_opts=None):
    """The sweep's draw(tag, nlev, start) blocks (sweep.py:428-436), as jax
    arrays (rand for the reference move) and torch tensors (the port's,
    with the window start of n_opts choices as a host int)."""
    g = jax.random.normal(fold_in(kk, 0), (W, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 1), (W, nlev + 1), dtype)
    s = jax.random.uniform(fold_in(kk, 2), (), dtype) if n_opts else None
    return (s, g, u), (None if s is None else _start(s, n_opts), tt(g), tt(u))


def bisect_keyed_draws(key, W, level, D, dtype, n_opts, per_level,
                       shared=True):
    """bisection without rand: per level, split(key, level+2) (window start,
    then level ilev from keys[ilev], accepts from fold_in(keys[-1], ilev));
    monoshot, _draw_monoshot (bisection.py:231-241).  Without shared
    windows the start is per walker, a long tensor [W]."""
    if per_level:
        keys = split(key, level + 2)
        ii = _window_start(keys[0], W, n_opts, shared)
        g, u = _level_rows(keys[1:], keys[-1], (W,), level, D, dtype)
        return ii, tt(g), tt(u)
    k_g, k_u, k_s = split(key, 3)
    if shared:
        ii = _start(jax.random.uniform(k_s, (), dtype), n_opts)
    else:
        ii = ti(2 * jnp.floor(jax.random.uniform(k_s, (W,), dtype)
                              * n_opts).astype(jnp.int32))
    return (ii,
            tt(jax.random.normal(k_g, (W, 2 ** level, D), dtype)),
            tt(jax.random.uniform(k_u, (W, level + 1), dtype)))


def end_bisect_draws(key, W, level, D, dtype, per_level, random_depth):
    """move_head/tail_bisection without rand (bisection.py:628-653): the
    depth (random with random_depth: split(key) -> k_n, k_body) and the
    body's draws, per level (split(k_body, depth+3)) or monoshot."""
    if random_depth and level > 2:
        k_n, key = split(key)
        depth = 2 + int(jax.random.randint(k_n, (), 0, level - 1))
    else:
        depth = max(level, 2)
    if per_level:
        k_g, k_acc0, *k_lev = split(key, depth + 3)
        return depth, (None, *_gate_rows(k_g, k_acc0, k_lev, (W,), depth, D,
                                         dtype))
    k_g, k_u, _ = split(key, 3)
    return depth, (None,
                   tt(jax.random.normal(k_g, (W, 2 ** depth, D), dtype)),
                   tt(jax.random.uniform(k_u, (W, depth + 1), dtype)))


def fused_ends_draws(kk, W, nlev, D, dtype):
    """The fused ends' blocks at tag 28 (sweep.py:546-558), as the rand of
    the reference move and as the port's tensors."""
    g = jax.random.normal(fold_in(kk, 0), (W, 2, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 1), (W, 2, nlev + 1), dtype)
    return (None, g, u), (None, tt(g), tt(u))


def fused_ends_keyed_draws(key, W, level, D, dtype, per_level):
    """fused_end_bisections without rand: per level split(key, level+3)
    (bisection.py:793), monoshot split(key, 2) (bisection.py:693)."""
    if per_level:
        k_g, k_acc0, *k_lev = split(key, level + 3)
        return (None, *_gate_rows(k_g, k_acc0, k_lev, (W, 2), level, D,
                                  dtype))
    k_g, k_u = split(key, 2)
    return (None, tt(jax.random.normal(k_g, (W, 2, 2 ** level, D), dtype)),
            tt(jax.random.uniform(k_u, (W, 2, level + 1), dtype)))


def bisect_multi_draws(kk, W, K, nlev, n_shift, D, dtype):
    """The K-slot interior blocks at tag 23 (sweep.py:589-599)."""
    g = jax.random.normal(fold_in(kk, 2), (W, K, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 3), (W, K, nlev + 1), dtype)
    s = jax.random.uniform(fold_in(kk, 4), (), dtype)
    return (s, g, u), (_start(s, n_shift), tt(g), tt(u))


def bisect_multi_keyed_draws(key, W, K, level, n_shift, D, dtype,
                             per_level):
    """bisection_multi without rand: per level split(key, level+2)
    (bisection.py:993-1008), monoshot split(key, 3) (bisection.py:910)."""
    if per_level:
        keys = split(key, level + 2)
        s = 2 * int(jax.random.randint(keys[0], (), 0, n_shift,
                                       dtype=jnp.int32))
        g, u = _level_rows(keys[1:], keys[-1], (W, K), level, D, dtype)
        return s, tt(g), tt(u)
    k_s, k_g, k_u = split(key, 3)
    return (_start(jax.random.uniform(k_s, (), dtype), n_shift),
            tt(jax.random.normal(k_g, (W, K, 2 ** level, D), dtype)),
            tt(jax.random.uniform(k_u, (W, K, level + 1), dtype)))


def cascade_ends_draws(key, W, nlev, D, dtype):
    """cascade_kernels.fused_ends_cascade: (rg, ru)."""
    k_g, k_u = split(key)
    return (tt(jax.random.normal(k_g, (W, 2, 2 ** nlev + 1, D), dtype)),
            tt(jax.random.uniform(k_u, (W, 2, nlev + 1), dtype)))


def cascade_interior_draws(key, W, K, nlev, n_shift, D, dtype):
    """cascade_kernels.interior_cascade: (shift, rg, ru)."""
    k_s, k_g, k_u = split(key, 3)
    s = 2 * int(jax.random.randint(k_s, (), 0, n_shift, dtype=jnp.int32))
    return (s, tt(jax.random.normal(k_g, (W, K, 2 ** nlev + 1, D), dtype)),
            tt(jax.random.uniform(k_u, (W, K, nlev), dtype)))


class JaxDraws:
    """Draw source replaying the reference Sweeper.step's key tree; shared:
    cfg.shared_windows (False: per-walker window starts)."""

    def __init__(self, key, D, dtype, shared=True):
        self.key, self.D, self.dtype = key, D, dtype
        self.shared = shared

    def begin_step(self):
        self.key, self.k_step = split(self.key)

    def _site(self, tag, it=None):
        k = fold_in(self.k_step, tag)
        return k if it is None else fold_in(k, it)

    def iupdate(self, W):
        return ti(jax.random.randint(self._site(0), (W,), 0, 2))

    def cand(self, W, Np):
        return ti(jax.random.randint(self._site(2), (W,), 0, Np,
                                     dtype=jnp.int32))

    def worm(self, tag, W, Lmax):
        return worm_draws(self._site(tag), W, Lmax, self.D, self.dtype)

    def translate(self, tag, it, W):
        return translate_draws(self._site(tag, it), W, self.D, self.dtype)

    def bisect(self, tag, it, W, nlev, n_opts=None):
        return bisect_draws(self._site(tag, it), W, nlev, self.D, self.dtype,
                            n_opts)[1]

    def bisect_keyed(self, tag, it, W, nlev, n_opts, per_level):
        return bisect_keyed_draws(self._site(tag, it), W, nlev, self.D,
                                  self.dtype, n_opts, per_level, self.shared)

    def end_bisect(self, tag, it, W, level, per_level, random_depth):
        return end_bisect_draws(self._site(tag, it), W, level, self.D,
                                self.dtype, per_level, random_depth)

    def regrow_half(self, tag, it, W, Lmax):
        return half_draws(self._site(tag, it), W, Lmax, self.D, self.dtype)

    # -- the fused composite sweep (sweep.py:521-618) -----------------------

    def fused_ends(self, it, W, nlev):
        return fused_ends_draws(self._site(28, it), W, nlev, self.D,
                                self.dtype)[1]

    def fused_ends_keyed(self, it, W, nlev, per_level):
        return fused_ends_keyed_draws(self._site(20, it), W, nlev, self.D,
                                      self.dtype, per_level)

    def group_offset(self, it, Np):
        return int(jax.random.randint(fold_in(self._site(23, it), 0), (), 0,
                                      Np, dtype=jnp.int32))

    def bisect_multi(self, it, W, K, nlev, n_shift):
        return bisect_multi_draws(self._site(23, it), W, K, nlev, n_shift,
                                  self.D, self.dtype)[1]

    def bisect_multi_keyed(self, it, W, K, nlev, n_shift, per_level):
        return bisect_multi_keyed_draws(fold_in(self._site(23, it), 1), W, K,
                                        nlev, n_shift, self.D, self.dtype,
                                        per_level)

    def end_stagings(self, it, W, Lmax):
        return half_draws(self._site(20, it), 2 * W, Lmax, self.D,
                          self.dtype)

    def cascade_ends(self, it, W, nlev):
        return cascade_ends_draws(self._site(20, it), W, nlev, self.D,
                                  self.dtype)

    def cascade_interior(self, it, W, K, nlev, n_shift):
        return cascade_interior_draws(fold_in(self._site(23, it), 1), W, K,
                                      nlev, n_shift, self.D, self.dtype)

    def staging_half(self, tag, it, W, n_opts, L):
        return staging_half_draws(self._site(tag, it), W, n_opts, L, self.D,
                                  self.dtype, self.shared)

    def swap(self, it, W, Np, Lmax):
        return swap_draws(self._site(50, it), W, Np, Lmax, self.D, self.dtype)

    def sp_staging(self, it, W, S, n_opts, L):
        return sp_draws(self._site(22, it), W, S, n_opts, L, self.D,
                        self.dtype)

    def mala(self, shape):
        return mala_draws(self._site(60), tuple(shape), self.dtype)


# ---------------------------------------------------------------------------
# Shared fixtures of the torch parity tests
# ---------------------------------------------------------------------------

def small_cfg(**kw):
    """The dry-run base (__graft_entry__.dryrun_multichip) on one device,
    on the flagship's default branch, in float64: the reference's SimConfig
    (other_cfg gives the port's)."""
    base = dict(
        dim=3, Np=8, density=0.365, trap=False,
        dt=5e-3, Nb=8, sampling="bis", Lstag=4, Nlev=2, Nstag=1,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=True, CWorm=0.5, Nobdm=2, Npw=0,
        n_walkers=8, dtype="float64", potential="aziz2",
        fused_sweep=False, exact_f2=False, jastrow="mcmillan_c1")
    base.update(kw)
    return jconfig.SimConfig(**base)


def lattice_paths(cfg, seed=0, noise=0.05):
    """Worldlines [W, M, N, D] near a cubic lattice (moderate action
    deltas, no ties), numpy float64."""
    rng = np.random.default_rng(seed)
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    L = jconfig.geometry(cfg).Lbox[0]
    n = int(round(N ** (1.0 / D)))
    grid = np.stack(np.meshgrid(*[np.arange(n)] * D, indexing="ij"),
                    -1).reshape(-1, D)[:N]
    base = (grid + 0.5) * (L / n) - 0.5 * L
    x = (base[None, None] + 0.3 * rng.normal(size=(W, 1, N, D))
         + noise * rng.normal(size=(W, M, N, D)))
    return (x + 0.5 * L) % L - 0.5 * L


# ---------------------------------------------------------------------------
# Whole steps: the port against the reference from one burned-in state
# ---------------------------------------------------------------------------

STATE_FIELDS = ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm",
                "step")


def burn_ref(cfg, nstep=2, nburn=150):
    """Burn a reference state in with the reference's jitted step of cfg
    (until some walkers are open and some closed), then run nstep more
    steps of the reference from it.  Returns (burned reference state,
    reference state after nstep steps, their statistics)."""
    from pathintegralgroundstate_tpu import sweep as jsweep
    from pathintegralgroundstate_tpu.state import init_state
    from pathintegralgroundstate_tpu.system import make_system as jmake
    from pathintegralgroundstate_tpu.system import make_tables

    jsys = jmake(cfg)
    step = jax.jit(jsweep.Sweeper(jsys, make_tables(jsys)).step)
    st, stats = init_state(jsys), jsweep.zero_stats(jsys)
    for _ in range(nburn):
        st, stats = step(st, stats)
    nopen = int(np.sum(np.asarray(st.isopen)))
    assert 0 < nopen < cfg.n_walkers, nopen
    burned, ref_stats = st, jsweep.zero_stats(jsys)
    for _ in range(nstep):
        st, ref_stats = step(st, ref_stats)
    return burned, st, ref_stats


def step_pair(cfg, nstep=2, nburn=150, max_w=None):
    """burn_ref, then nstep steps of the port (on the reference's draws)
    from the burned state.  max_w: the batched-randoms threshold of both
    packages during the run (a W above it takes the draws without batched
    randoms).  Returns (reference state, reference stats, port state, port
    stats)."""
    from pathintegralgroundstate_torch import sweep as tsweep
    from pathintegralgroundstate_torch.state import state_from_numpy
    from pathintegralgroundstate_torch.system import make_system
    from pathintegralgroundstate_tpu import sweep as jsweep

    saved = jsweep.BATCH_RAND_MAX_W, tsweep.BATCH_RAND_MAX_W
    if max_w is not None:
        jsweep.BATCH_RAND_MAX_W = tsweep.BATCH_RAND_MAX_W = max_w
    try:
        burned, st, ref_stats = burn_ref(cfg, nstep, nburn)
        tsys = make_system(other_cfg(cfg), "cpu")
        state = state_from_numpy(tsys, {k: getattr(burned, k)
                                        for k in STATE_FIELDS})
        state, stats = tsweep.run_block(
            tsweep.Sweeper(tsys), state, nstep,
            JaxDraws(burned.key, cfg.dim, jnp.float64, cfg.shared_windows))
    finally:
        jsweep.BATCH_RAND_MAX_W, tsweep.BATCH_RAND_MAX_W = saved
    return st, ref_stats, state, stats


def assert_step_pair(ref, ref_stats, state, stats, tol):
    """Positions within tol, integer state and counters exactly equal,
    statistics within rtol 1e-9."""
    from pathintegralgroundstate_torch.state import state_to_numpy
    from pathintegralgroundstate_torch.sweep import stats_to_numpy
    got = state_to_numpy(state)
    for k in STATE_FIELDS:
        want = np.asarray(getattr(ref, k))
        if k in ("paths", "xend"):
            np.testing.assert_allclose(got[k], want, **tol, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], want, err_msg=k)
    tstats = stats_to_numpy(stats)
    for k, v in tstats.items():
        want = np.asarray(getattr(ref_stats, k))
        if k == "counters":
            np.testing.assert_array_equal(v, want)
        else:
            np.testing.assert_allclose(v, want, rtol=1e-9, atol=1e-12,
                                       err_msg=k)
    return tstats["counters"]
