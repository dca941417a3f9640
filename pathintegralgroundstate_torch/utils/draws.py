"""The port's random source: every draw of one Monte Carlo step.

`Sweeper.step` asks a draw source for each move site's randoms through
methods named after the site, with the address of the reference's key tree
(`tag`, `it`: the fold_in tags of pathintegralgroundstate_tpu/sweep.py),
and hands them to the moves as tensors shaped as the reference draws them.
Two sources implement the same methods:

  DeviceDraws (here): the port's own.  Tensors come from the state's device
      generator; the scalar, state-independent values (the shared window
      starts, the end moves' random depths, the fused sweep's group offsets
      and interior shifts) from its host generator as Python ints, so the
      step never synchronises with the device.  With shared_windows=False
      the window starts are per walker, a long tensor [W] drawn on the
      device (the reference's _window_start / _draw_monoshot with
      start_shape (W,), moves.py:161-176, bisection.py:231-240); the
      composites' interior shift stays shared, as in the reference.  It
      ignores the addresses.
  the test bridge (tests/torch_bridge.py): replays the reference's own JAX
      key tree split for split, so the port can be held equal to the
      reference step.

A bisection move's randoms come as (start, g [W, L, D], u [W, ngroups]),
the reference's batched-randoms layout (ops/bisection.py); the `*_keyed`
sites are the reference's draws without batched randoms (W above
sweep.BATCH_RAND_MAX_W, or the random end depth), which the bridge lays
out the same way.  Here both are the same draws.

Under walker sharding (a System whose mesh has dp > 1) every rank draws
each block for all the global walkers and keeps its own rows, and the host
generator is seeded alike on every rank: a sharded run then draws exactly
the numbers of the unsharded run of the same seed, at dp times the random
number work per rank (parallel/mesh.py).  Under bead sharding (sp) every
rank draws every shard's window in the same way (`sp_staging`).

In bfloat16 the draws follow the reference's law, not torch's: its
uniform is k/128 with k uniform on {0, ..., 127} (jax.random.uniform keeps
the top 7 of 16 random bits as the mantissa of a number in [1, 2)), and
its Gaussian sqrt(2) erfinv(u) of that uniform scaled to (nextafter(-1,
0), 1) in bfloat16, so it too takes 128 values (`uniform`, `normal`,
`bf16_normal_table`).  Both are drawn on the device as an integer k and
need no host sync; float32 and float64 draw with torch.rand / randn.
"""

from __future__ import annotations

import torch

from ..ops.moves import _rand_ls
from ..ops.worm import SwapDraws, WormDraws, _rand_even_ls
from .spans import count

BF16_LEVELS = 128   # 2**7: the values of a bfloat16 uniform (7 mantissa bits)


def bf16_normal_table(device) -> torch.Tensor:
    """The 128 values of the reference's bfloat16 Gaussian, by k: sqrt(2)
    erfinv(u_k) with u_k = max(lo, (k/128) (1 - lo) + lo), lo =
    nextafter(-1, 0), every operation in bfloat16 as jax.random.normal
    does it (_normal_real)."""
    bf = dict(dtype=torch.bfloat16, device=device)
    lo = torch.tensor(-1.0 + 2.0 ** -8, **bf)     # nextafter(-1, 0)
    f = torch.arange(BF16_LEVELS, device=device).to(torch.bfloat16) \
        / BF16_LEVELS
    u = torch.maximum(lo, f * (torch.tensor(1.0, **bf) - lo) + lo)
    return torch.erfinv(u) * torch.tensor(2.0 ** 0.5, **bf)


def uniform(shape, gen, device, dtype) -> torch.Tensor:
    """Uniforms on [0, 1): torch.rand, or in bfloat16 the reference's
    k/128."""
    if dtype != torch.bfloat16:
        return torch.rand(shape, generator=gen, device=device, dtype=dtype)
    k = torch.randint(0, BF16_LEVELS, shape, generator=gen, device=device)
    return k.to(dtype) / BF16_LEVELS


def normal(shape, gen, device, dtype, table=None) -> torch.Tensor:
    """Standard Gaussians: torch.randn, or in bfloat16 the reference's
    128-value law (table: bf16_normal_table on device, made if None)."""
    if dtype != torch.bfloat16:
        return torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if table is None:
        table = bf16_normal_table(device)
    return table[torch.randint(0, BF16_LEVELS, shape, generator=gen,
                               device=device)]


class DeviceDraws:
    def __init__(self, system, gen: torch.Generator,
                 host_gen: torch.Generator):
        self.gen, self.host = gen, host_gen
        self.device, self.dtype = system.device, system.dtype
        self.D = system.cfg.dim
        self.shared = system.cfg.shared_windows
        mesh = system.mesh
        self.dp, self.dp_rank = (mesh.dp, mesh.dp_rank) if mesh else (1, 0)
        self.table = (bf16_normal_table(self.device)
                      if self.dtype == torch.bfloat16 else None)

    def begin_step(self) -> None:
        """Start of a step (the bridge splits its step key here)."""

    # -- primitives --------------------------------------------------------

    def _keep(self, t, axis: int = 0, blocks: int = 1):
        """This rank's walkers of t, drawn for all dp * W walkers along
        `axis` (blocks such runs of walkers one after the other, each kept
        in its rows); t itself without walker sharding."""
        if self.dp == 1:
            return t
        n = t.shape[axis] // (blocks * self.dp)
        lo = self.dp_rank * n
        parts = [t.narrow(axis, b * n * self.dp + lo, n)
                 for b in range(blocks)]
        return torch.cat(parts, axis) if blocks > 1 else parts[0].contiguous()

    def _global(self, shape, axis):
        shape = list(shape)
        shape[axis] *= self.dp
        return shape

    def _u(self, *shape, axis=0):
        """Uniforms of `shape`, walkers (this rank's) on `axis`."""
        return self._keep(self._rand(self._global(shape, axis)), axis)

    def _g(self, *shape, axis=0):
        """Gaussians of `shape`, walkers on `axis`."""
        return self._keep(self._randn(self._global(shape, axis)), axis)

    def _rand(self, shape):
        return uniform(shape, self.gen, self.device, self.dtype)

    def _randn(self, shape):
        return normal(shape, self.gen, self.device, self.dtype, self.table)

    def _int(self, hi: int, W: int):
        return self._keep(torch.randint(0, hi, (W * self.dp,),
                                        generator=self.gen,
                                        device=self.device))

    def _start(self, n_opts: int, W: int):
        """An even window start of n_opts choices: a host int shared by
        every walker, or per walker a long tensor [W] on the device
        (shared_windows=False), 2 U{0..n_opts-1}: the law of the
        reference's 2 floor(u n_opts), drawn as integers so that no float
        rounding reaches the top choice."""
        if self.shared:
            return 2 * self._host_int(n_opts)
        return 2 * self._int(n_opts, W)

    # -- sites -------------------------------------------------------------

    def iupdate(self, W: int):
        """Open-or-close choice per walker (tag 0): [W] long in {0, 1}."""
        return self._int(2, W)

    def cand(self, W: int, Np: int):
        """Worm-particle candidate of the open move (tag 2)."""
        return self._int(Np, W)

    def worm(self, tag: int, W: int, Lmax: int) -> WormDraws:
        """close_chain (tag 1) / open_chain (tag 3)."""
        return WormDraws(self._keep(_rand_even_ls(self.gen, W * self.dp,
                                                  Lmax, self.device)),
                         self._int(2, W), self._g(W, self.D),
                         self._g(Lmax - 3, W, self.D, axis=1), self._u(W))

    def translate(self, tag: int, it: int, W: int):
        """translate_chain and rigid_cascade (tag 10) / translate_half_chain
        (31, 32): (u_dx [W, 1, D], u_acc [W])."""
        return self._u(W, 1, self.D), self._u(W)

    def bisect(self, tag: int, it: int, W: int, nlev: int,
               n_opts: int = None):
        """Bisection with batched randoms (tags 25, 26, 27): (even window
        start of n_opts choices, a host int or per walker [W], or None for
        an end move; g [W, 2**nlev, D], u [W, nlev+1])."""
        ii = self._start(n_opts, W) if n_opts else None
        return ii, self._g(W, 2 ** nlev, self.D), self._u(W, nlev + 1)

    def bisect_keyed(self, tag: int, it: int, W: int, nlev: int,
                     n_opts: int, per_level: bool):
        """Interior bisection without batched randoms (tag 22): as
        bisect."""
        return self.bisect(tag, it, W, nlev, n_opts)

    def end_bisect(self, tag: int, it: int, W: int, level: int,
                   per_level: bool, random_depth: bool):
        """End bisection without batched randoms (tags 20, 21): (depth,
        rand).  The depth is max(level, 2), or with random_depth the
        Fortran's U{2..level} (vpi_mod.f90:1023), a host int."""
        depth = (2 + self._host_int(level - 1) if random_depth and level > 2
                 else max(level, 2))
        return depth, self.bisect(tag, it, W, depth)

    def _host_int(self, hi: int) -> int:
        count("host_int")
        return int(torch.randint(0, hi, (), generator=self.host))

    def fused_ends(self, it: int, W: int, nlev: int):
        """Fused head+tail bisection (tag 28): (None, g [W, 2, 2**nlev, D],
        u [W, 2, nlev+1])."""
        return None, self._g(W, 2, 2 ** nlev, self.D), self._u(W, 2, nlev + 1)

    def fused_ends_keyed(self, it: int, W: int, nlev: int, per_level: bool):
        """Fused head+tail bisection without batched randoms (tag 20)."""
        return self.fused_ends(it, W, nlev)

    def group_offset(self, it: int, Np: int) -> int:
        """Particle offset of interior group `it` (tag 23): host int."""
        return self._host_int(Np)

    def bisect_multi(self, it: int, W: int, K: int, nlev: int,
                     n_shift: int):
        """K-slot interior composite (tag 23): (even shift host int, of
        n_shift choices; g [W, K, 2**nlev, D], u [W, K, nlev+1])."""
        return (2 * self._host_int(n_shift), self._g(W, K, 2 ** nlev, self.D),
                self._u(W, K, nlev + 1))

    def bisect_multi_keyed(self, it: int, W: int, K: int, nlev: int,
                           n_shift: int, per_level: bool):
        """K-slot interior composite without batched randoms (tag 23)."""
        return self.bisect_multi(it, W, K, nlev, n_shift)

    def end_stagings(self, it: int, W: int, Lmax: int):
        """Fused head+tail staging (tag 20), head walkers then tail
        walkers: (Ls [2W], g0 [2W, D], gs [Lmax-1, 2W, D], u_acc [2W])."""
        return self._regrow(2 * W, Lmax, 2)

    def cascade_ends(self, it: int, W: int, nlev: int):
        """Ends cascade (tag 20): (rg [W, 2, 2**nlev+1, D],
        ru [W, 2, nlev+1])."""
        return (self._g(W, 2, 2 ** nlev + 1, self.D),
                self._u(W, 2, nlev + 1))

    def cascade_interior(self, it: int, W: int, K: int, nlev: int,
                         n_shift: int):
        """Interior cascade (tag 23): (even shift host int,
        rg [W, K, 2**nlev+1, D], ru [W, K, nlev])."""
        return (2 * self._host_int(n_shift),
                self._g(W, K, 2 ** nlev + 1, self.D), self._u(W, K, nlev))

    def regrow_half(self, tag: int, it: int, W: int, Lmax: int):
        """move_head/tail_half_chain (tags 41-44) and the staging sampler's
        move_head/tail (tags 20, 21): (Ls, g0, gs, u_acc)."""
        return self._regrow(W, Lmax)

    def _regrow(self, W: int, Lmax: int, blocks: int = 1):
        """(Ls [W], g0 [W, D], gs [Lmax-1, W, D], u_acc [W]) of W walkers
        made of `blocks` runs of walkers (the fused ends' head and tail)."""
        Wg = W * self.dp
        return (self._keep(_rand_ls(self.gen, Wg, Lmax, self.device), 0,
                           blocks),
                self._keep(self._randn((Wg, self.D)), 0, blocks),
                self._keep(self._randn((Lmax - 1, Wg, self.D)), 1, blocks),
                self._keep(self._rand((Wg,)), 0, blocks))

    def staging_half(self, tag: int, it: int, W: int, n_opts: int, L: int):
        """staging_half_chain (tags 45, 46) and staging_move (tag 22):
        (start, a host int or per walker [W]; gs, u_acc)."""
        start = self._start(n_opts, W)
        return start, self._g(L - 1, W, self.D, axis=1), self._u(W)

    def sp_staging(self, it: int, W: int, S: int, n_opts: int, L: int):
        """The SP sweep (tag 22, each shard's key folded with its index,
        beadshard.py:70-76): for each of the S shards in shard order, (even
        local start of n_opts choices, a host int; gs [L-1, W, D]; u_acc
        [W]).  Every rank of an sp mesh draws all S and keeps its own."""
        return [(2 * self._host_int(n_opts), self._g(L - 1, W, self.D,
                                                      axis=1), self._u(W))
                for _ in range(S)]

    def mala(self, shape):
        """MALA (tag 60): (xi of paths' shape [W, M, N, D], u [W]), the
        reference's split(key) -> k_xi, k_acc."""
        return self._g(*shape), self._u(shape[0])

    def swap(self, it: int, W: int, Np: int, Lmax: int) -> SwapDraws:
        """swap_move (tag 50); the Gumbel noise is -log(-log U)."""
        tiny = torch.finfo(self.dtype).tiny
        gumbel = -torch.log(-torch.log(self._u(W, Np).clamp_(min=tiny)))
        return SwapDraws(self._keep(_rand_even_ls(self.gen, W * self.dp,
                                                  Lmax, self.device)),
                         gumbel, self._u(W),
                         self._g(Lmax - 3, W, self.D, axis=1), self._u(W))
