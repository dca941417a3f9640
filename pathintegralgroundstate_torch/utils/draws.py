"""The port's random source: every draw of one Monte Carlo step.

`Sweeper.step` asks a draw source for each move site's randoms through
methods named after the site, with the address of the reference's key tree
(`tag`, `it`: the fold_in tags of pathintegralgroundstate_tpu/sweep.py),
and hands them to the moves as tensors shaped as the reference draws them.
Two sources implement the same methods:

  DeviceDraws (here): the port's own.  Tensors come from the state's device
      generator; the scalar, state-independent values (the shared window
      starts, the fused sweep's group offsets and interior shifts) from its
      host generator as Python numbers, so the step never synchronises with
      the device.  It ignores the addresses.
  the test bridge (tests/torch_bridge.py): replays the reference's own JAX
      key tree split for split, so the port can be held equal to the
      reference step.
"""

from __future__ import annotations

import torch

from ..ops.moves import _rand_ls
from ..ops.worm import SwapDraws, WormDraws, _rand_even_ls


class DeviceDraws:
    def __init__(self, system, gen: torch.Generator,
                 host_gen: torch.Generator):
        self.gen, self.host = gen, host_gen
        self.device, self.dtype = system.device, system.dtype
        self.D = system.cfg.dim

    def begin_step(self) -> None:
        """Start of a step (the bridge splits its step key here)."""

    # -- primitives --------------------------------------------------------

    def _u(self, *shape):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=self.dtype)

    def _g(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=self.dtype)

    def _int(self, hi: int, W: int):
        return torch.randint(0, hi, (W,), generator=self.gen,
                             device=self.device)

    # -- sites -------------------------------------------------------------

    def iupdate(self, W: int):
        """Open-or-close choice per walker (tag 0): [W] long in {0, 1}."""
        return self._int(2, W)

    def cand(self, W: int, Np: int):
        """Worm-particle candidate of the open move (tag 2)."""
        return self._int(Np, W)

    def worm(self, tag: int, W: int, Lmax: int) -> WormDraws:
        """close_chain (tag 1) / open_chain (tag 3)."""
        return WormDraws(_rand_even_ls(self.gen, W, Lmax, self.device),
                         self._int(2, W), self._g(W, self.D),
                         self._g(Lmax - 3, W, self.D), self._u(W))

    def translate(self, tag: int, it: int, W: int):
        """translate_chain and rigid_cascade (tag 10) / translate_half_chain
        (31, 32): (u_dx [W, 1, D], u_acc [W])."""
        return self._u(W, 1, self.D), self._u(W)

    def bisect(self, tag: int, it: int, W: int, nlev: int,
               start: bool = False):
        """Monoshot bisection (tags 25, 26, 27): (u_start host float or
        None, g [W, 2**nlev, D], u_acc [W, nlev+1])."""
        s = self._host_u() if start else None
        return s, self._g(W, 2 ** nlev, self.D), self._u(W, nlev + 1)

    def _host_int(self, hi: int) -> int:
        return int(torch.randint(0, hi, (), generator=self.host))

    def _host_u(self) -> float:
        return torch.rand((), generator=self.host, dtype=torch.float64).item()

    def fused_ends(self, it: int, W: int, nlev: int):
        """Fused head+tail bisection (tag 28): (None, g [W, 2, 2**nlev, D],
        u [W, 2, nlev+1])."""
        return None, self._g(W, 2, 2 ** nlev, self.D), self._u(W, 2, nlev + 1)

    def group_offset(self, it: int, Np: int) -> int:
        """Particle offset of interior group `it` (tag 23): host int."""
        return self._host_int(Np)

    def bisect_multi(self, it: int, W: int, K: int, nlev: int):
        """K-slot interior composite (tag 23): (u_shift host float,
        g [W, K, 2**nlev, D], u [W, K, nlev+1])."""
        return (self._host_u(), self._g(W, K, 2 ** nlev, self.D),
                self._u(W, K, nlev + 1))

    def end_stagings(self, it: int, W: int, Lmax: int):
        """Fused head+tail staging (tag 20), head walkers then tail
        walkers: (Ls [2W], g0 [2W, D], gs [Lmax-1, 2W, D], u_acc [2W])."""
        return self.regrow_half(20, it, 2 * W, Lmax)

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
        """move_head/tail_half_chain (tags 41-44): (Ls, g0, gs, u_acc)."""
        return (_rand_ls(self.gen, W, Lmax, self.device), self._g(W, self.D),
                self._g(Lmax - 1, W, self.D), self._u(W))

    def staging_half(self, tag: int, it: int, W: int, n_opts: int, L: int):
        """staging_half_chain (tags 45, 46): (start host int, gs, u_acc)."""
        start = 2 * self._host_int(n_opts)
        return start, self._g(L - 1, W, self.D), self._u(W)

    def swap(self, it: int, W: int, Np: int, Lmax: int) -> SwapDraws:
        """swap_move (tag 50); the Gumbel noise is -log(-log U)."""
        tiny = torch.finfo(self.dtype).tiny
        gumbel = -torch.log(-torch.log(self._u(W, Np).clamp_(min=tiny)))
        return SwapDraws(_rand_even_ls(self.gen, W, Lmax, self.device),
                         gumbel, self._u(W), self._g(Lmax - 3, W, self.D),
                         self._u(W))
