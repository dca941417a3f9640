"""Test helper: the reference's own jax.random draws, handed to the torch port.

Each `*_draws(key, ...)` function splits a move-site key exactly as the
reference move consumes it and returns the draws as torch tensors, in the
argument layout of the torch move.  `JaxDraws` is a draw source for the torch
`Sweeper.step` (same methods as utils/draws.DeviceDraws) that replays the
reference step's key tree: split(state.key) -> k_step, then the fold_in tags
of pathintegralgroundstate_tpu/sweep.py.  It replays the batched-randoms
branch, which the reference takes for W <= BATCH_RAND_MAX_W.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pathintegralgroundstate_torch.ops.worm import SwapDraws, WormDraws

split, fold_in = jax.random.split, jax.random.fold_in


def tt(x):
    """jax array -> torch tensor (a copy, same dtype)."""
    return torch.from_numpy(np.array(x))


def ti(x):
    """jax integer array -> torch long tensor."""
    return torch.from_numpy(np.asarray(x).astype(np.int64))


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


def staging_half_draws(key, W, n_opts, L, D, dtype):
    """moves.staging_half_chain: (start, gs, u_acc)."""
    k_ii, k_reg, k_acc = split(key, 3)
    start = int(2 * jax.random.randint(k_ii, (), 0, n_opts, dtype=jnp.int32))
    _, gs = regrow_draws(k_reg, W, L, D, dtype)
    return start, gs, tt(jax.random.uniform(k_acc, (W,), dtype))


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


def bisect_draws(kk, W, nlev, D, dtype, start=False):
    """The sweep's draw(tag, nlev, start) blocks (sweep.py:428-436), as jax
    arrays (rand for the reference move) and torch tensors (the port's)."""
    g = jax.random.normal(fold_in(kk, 0), (W, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 1), (W, nlev + 1), dtype)
    s = jax.random.uniform(fold_in(kk, 2), (), dtype) if start else None
    return (s, g, u), (None if s is None else float(s), tt(g), tt(u))


def fused_ends_draws(kk, W, nlev, D, dtype):
    """The fused ends' blocks at tag 28 (sweep.py:546-558), as the rand of
    the reference move and as the port's tensors."""
    g = jax.random.normal(fold_in(kk, 0), (W, 2, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 1), (W, 2, nlev + 1), dtype)
    return (None, g, u), (None, tt(g), tt(u))


def bisect_multi_draws(kk, W, K, nlev, D, dtype):
    """The K-slot interior blocks at tag 23 (sweep.py:589-599)."""
    g = jax.random.normal(fold_in(kk, 2), (W, K, 2 ** nlev, D), dtype)
    u = jax.random.uniform(fold_in(kk, 3), (W, K, nlev + 1), dtype)
    s = jax.random.uniform(fold_in(kk, 4), (), dtype)
    return (s, g, u), (float(s), tt(g), tt(u))


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
    """Draw source replaying the reference Sweeper.step's key tree."""

    def __init__(self, key, D, dtype):
        self.key, self.D, self.dtype = key, D, dtype

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

    def bisect(self, tag, it, W, nlev, start=False):
        return bisect_draws(self._site(tag, it), W, nlev, self.D, self.dtype,
                            start)[1]

    def regrow_half(self, tag, it, W, Lmax):
        return half_draws(self._site(tag, it), W, Lmax, self.D, self.dtype)

    # -- the fused composite sweep (sweep.py:521-618) -----------------------

    def fused_ends(self, it, W, nlev):
        return fused_ends_draws(self._site(28, it), W, nlev, self.D,
                                self.dtype)[1]

    def group_offset(self, it, Np):
        return int(jax.random.randint(fold_in(self._site(23, it), 0), (), 0,
                                      Np, dtype=jnp.int32))

    def bisect_multi(self, it, W, K, nlev):
        return bisect_multi_draws(self._site(23, it), W, K, nlev, self.D,
                                  self.dtype)[1]

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
                                  self.dtype)

    def swap(self, it, W, Np, Lmax):
        return swap_draws(self._site(50, it), W, Np, Lmax, self.D, self.dtype)


# ---------------------------------------------------------------------------
# Shared fixtures of the torch parity tests
# ---------------------------------------------------------------------------

def small_cfg(**kw):
    """The dry-run base (__graft_entry__.dryrun_multichip) on one device,
    on the flagship's default branch, in float64."""
    from pathintegralgroundstate_tpu.config import SimConfig
    base = dict(
        dim=3, Np=8, density=0.365, trap=False,
        dt=5e-3, Nb=8, sampling="bis", Lstag=4, Nlev=2, Nstag=1,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=True, CWorm=0.5, Nobdm=2, Npw=0,
        n_walkers=8, dtype="float64", potential="aziz2",
        fused_sweep=False, exact_f2=False, jastrow="mcmillan_c1")
    base.update(kw)
    return SimConfig(**base)


def lattice_paths(cfg, seed=0, noise=0.05):
    """Worldlines [W, M, N, D] near a cubic lattice (moderate action
    deltas, no ties), numpy float64."""
    from pathintegralgroundstate_tpu.config import geometry
    rng = np.random.default_rng(seed)
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    L = geometry(cfg).Lbox[0]
    n = int(round(N ** (1.0 / D)))
    grid = np.stack(np.meshgrid(*[np.arange(n)] * D, indexing="ij"),
                    -1).reshape(-1, D)[:N]
    base = (grid + 0.5) * (L / n) - 0.5 * L
    x = (base[None, None] + 0.3 * rng.normal(size=(W, 1, N, D))
         + noise * rng.normal(size=(W, M, N, D)))
    return (x + 0.5 * L) % L - 0.5 * L
