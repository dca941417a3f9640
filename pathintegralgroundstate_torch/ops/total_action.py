"""The total PIGS action as a differentiable function of the worldlines.

The torch counterpart of pathintegralgroundstate_tpu/ops/total_action.py:

    S(paths) = -log Psi_T(R_0) - log Psi_T(R_{2Nb})
               + sum_ib [ wv(ib) V(R_ib) + wf(ib) F2(R_ib) ]
               + sum_links |r_{ib+1} - r_ib|^2 / (2 dt)

with the Chin opt=0 weights (global_mod.f90:31-46, pairwise.chin_table)
and F2 the FULL squared force sum, the consistent 4th-order action that
exact F^2 samples.  The pair sums are the plain form of kernel B
(kernels.pair_pot_ref) on every device: kernel B has no backward, and
dF2/dx needs the second derivative of the Aziz form, so the whole chain is
built from differentiable torch operations (no in-place writes, no
detach).

Every function takes paths[..., M, N, D] with any leading batch (one
action per walker); grad_action is torch.autograd.grad of the summed
action, the per-walker gradients since the walkers do not interact.
"""

from __future__ import annotations

import torch

from ..models import jastrow as jas
from ..utils.pbc import all_pairs, separation
from .kernels import pair_pot_ref
from .pairwise import chin_table


def log_trial_wf(system, R):
    """log Psi_T of time slices R[..., N, D] (Jastrow pair sum + trap)."""
    m, r, _ = all_pairs(system, R)
    lw = 0.5 * torch.where(m, system.u(r), 0.0).sum((-1, -2))
    if system.a_ho is not None:
        lw = lw + jas.trap_psi(system.a_ho, R).sum(-1)
    return lw


def kinetic_action(system, paths):
    """Spring action sum_links |dr|^2 / (2 dt) of worldlines [..., M, N, D]."""
    dx = paths[..., 1:, :, :] - paths[..., :-1, :, :]
    _, rij2 = separation(system, dx)
    return rij2.sum((-1, -2)) / (2.0 * system.cfg.dt)


def _weighted_pot(system, paths):
    wv, wf, _ = chin_table(system, paths.dtype)
    pot, f2 = pair_pot_ref(system, paths, True, shard=False)
    s = (wv * pot).sum(-1) + (wf * f2).sum(-1)
    s = s - log_trial_wf(system, paths[..., 0, :, :])
    return s - log_trial_wf(system, paths[..., -1, :, :])


def total_action(system, paths):
    """The full 4th-order action of closed (diagonal) worldlines
    paths[..., M, N, D]; differentiable in paths."""
    return _weighted_pot(system, paths) + kinetic_action(system, paths)


def interaction_action(system, paths):
    """The interaction part (no springs), whose local differences the
    Metropolis kernels evaluate."""
    return _weighted_pot(system, paths)


def action_and_grad(system, paths, chunk: int = None):
    """(S [...], dS/dpaths) of worldlines paths[W, M, N, D], by
    torch.autograd, in walker chunks whose [chunk, M, N, N] pair blocks
    keep the saved graph bounded (the walkers are independent, so the
    chunks are exact).  chunk: walkers per chunk (default: 2**25 pair
    elements)."""
    W, M, N, _ = paths.shape
    chunk = chunk or max(1, 2 ** 25 // (M * N * N))
    S, G = [], []
    with torch.enable_grad():
        for lo in range(0, W, chunk):
            x = paths[lo:lo + chunk].detach().requires_grad_(True)
            s = total_action(system, x)
            G.append(torch.autograd.grad(s.sum(), x)[0])
            S.append(s.detach())
    return torch.cat(S), torch.cat(G)


def grad_action(system, paths):
    """dS/dpaths of worldlines paths[..., M, N, D] (autodiff): the drift of
    the smart-MC proposals."""
    with torch.enable_grad():
        x = paths.detach().requires_grad_(True)
        return torch.autograd.grad(total_action(system, x).sum(), x)[0]
