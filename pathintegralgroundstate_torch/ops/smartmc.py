"""Smart Monte Carlo: gradient-drifted whole-path proposals (MALA).

The torch counterpart of pathintegralgroundstate_tpu/ops/smartmc.py:

    x' = x - (eps/2) dS/dx + sqrt(eps) xi,      xi ~ N(0, 1),

accepted with the Metropolis-adjusted-Langevin ratio
exp(-S(x') + S(x)) q(x | x') / q(x' | x), log q(a | b) =
-|a - b + (eps/2) dS/dx(b)|^2 / (2 eps), on the unwrapped increments.
S is the full exact-F^2 action (ops/total_action.py), so MALA runs only
with cfg.exact_f2 (the Sweeper refuses it otherwise, as the reference
does), on diagonal walkers.
"""

from __future__ import annotations

import math

import torch

from .moves import _where, _wrap_pos
from .pairwise import force_field
from .total_action import action_and_grad


def mala_move(system, paths, active, eps: float, xi, u, fodd=None):
    """One MALA update of the whole ensemble, in place (smartmc.py:27-84):
    paths [W, M, N, D], active [W] (the diagonal walkers), xi of paths'
    shape and u [W] the draws (the reference's split(key) -> k_xi, k_acc).

    fodd: the odd-bead force-field cache.  A whole-path move invalidates
    every row of an accepted walker, which gets a fresh field; the field
    pass runs for every walker and is selected per walker, the values of
    the reference's skip when no walker accepted, without a host sync.
    Returns (paths, accepted[W])."""
    S, G = action_and_grad(system, paths)
    step = -0.5 * eps * G + math.sqrt(eps) * xi
    prop = _wrap_pos(system, paths + step)
    Sp, Gp = action_and_grad(system, prop)

    def sq(x):
        return (x * x).sum((1, 2, 3))

    log_q_fwd = -sq(step + 0.5 * eps * G) / (2.0 * eps)
    log_q_rev = -sq(-step + 0.5 * eps * Gp) / (2.0 * eps)
    logA = -(Sp - S) + log_q_rev - log_q_fwd
    acc = (torch.log(u) < logA) & active
    paths.copy_(_where(acc, prop, paths))
    if fodd is not None:
        fodd.copy_(_where(acc, force_field(system, paths[:, 1::2]), fodd))
    return paths, acc
