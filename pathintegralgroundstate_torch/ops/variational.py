"""Variational-parameter gradients: (Rm, a_ho) as explicit differentiable
arguments of the trial wave function, the local energy and the full
4th-order action.

The torch counterpart of pathintegralgroundstate_tpu/ops/variational.py,
on torch.autograd where the reference takes jax.grad: pass Rm (or a_ho)
as a tensor with requires_grad and differentiate the result, e.g.

    Rm = torch.tensor(1.2, dtype=torch.float64, requires_grad=True)
    torch.autograd.grad(total_action_params(system, paths_w, Rm), Rm)

The closed forms only (the reference keeps its tables out of the
derivative chain); the trial WF families are McMillan (with the C1 shift
under PBC), the 2-D dipolar form and none.  Every function takes slices R[..., N,
D] or worldlines paths_w[..., M, N, D] with any leading batch.
"""

from __future__ import annotations

import torch

from ..models import jastrow as jas
from ..utils.pbc import all_pairs, separation, wrap
from .pairwise import chin_table


# ---------------------------------------------------------------------------
# Parameterized trial wavefunction (System.u with Rm an argument)
# ---------------------------------------------------------------------------

def u_params(system, r, Rm):
    """Two-body log-Jastrow u(r; Rm): System.u_closed with Rm an explicit
    argument (the same family and C1 truncation rules)."""
    return jas.two_body_u(system.cfg.jastrow, Rm, r, system.geo.rcut,
                          system.pbc)


def du_params(system, r, Rm):
    return jas.two_body_du(system.cfg.jastrow, Rm, r, system.geo.rcut,
                           system.pbc)


def d2u_params(system, r, Rm):
    return jas.two_body_d2u(system.cfg.jastrow, Rm, r)


def _trap_lengths(system, a_ho, like):
    """The trial WF's trap lengths: a_ho, or the Hamiltonian's cfg.a_ho."""
    a = system.cfg.a_ho if a_ho is None else a_ho
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def log_trial_wf_params(system, R, Rm, a_ho=None):
    """log Psi_T(R; Rm, a_ho) of slices R[..., N, D]."""
    m, r, _ = all_pairs(system, R)
    lw = 0.5 * torch.where(m, u_params(system, r, Rm), 0.0).sum((-1, -2))
    if system.cfg.trap:
        a = _trap_lengths(system, a_ho, R)
        lw = lw + (-0.5 * ((R / a) ** 2).sum(-1)).sum(-1)
    return lw


def local_energy_params(system, R, Rm, a_ho=None):
    """E_L(R; Rm, a_ho) of slices R[..., N, D]: the closed-form local
    energy with the parameters as arguments (variational.py:109-141).
    a_ho parameterizes the trial WF only; the trap potential is the
    Hamiltonian's, cfg.a_ho.  Returns (E, Kin, Pot)."""
    cfg = system.cfg
    d = cfg.dim
    m, r, xij = all_pairs(system, R)
    dudr = torch.where(m, du_params(system, r, Rm), 0.0)
    d2u = torch.where(m, d2u_params(system, r, Rm), 0.0)
    lap = 0.5 * ((d - 1.0) * dudr / r + d2u).sum((-1, -2))
    pot = 0.5 * torch.where(m, system.potential.v(r), 0.0).sum((-1, -2))
    F = ((dudr / r)[..., None] * xij).sum(-2)
    if cfg.trap:
        a = _trap_lengths(system, a_ho, R)
        a_pot = _trap_lengths(system, None, R)
        F = F + (-(R / a ** 2))
        pot = pot + (0.5 * (R ** 2 / a_pot ** 4).sum(-1)).sum(-1)
        lap = lap + 0.5 * (-1.0 / a ** 2 * torch.ones_like(R)).sum(
            -1).sum(-1)
    kin = -0.5 * (2.0 * lap + (F * F).sum((-1, -2)))
    return kin + pot, kin, pot


def _pair_pot_f2_closed(system, R):
    """Closed-form (Pot, total |F|^2) of PBC slices R[..., N, D]
    (variational.py:204-214), with the r > 0 guard on the force."""
    m, r, xij = all_pairs(system, R)
    pot = 0.5 * torch.where(m, system.potential.v(r), 0.0).sum((-1, -2))
    fr = torch.where(m & (r > 0.0), system.potential.dvdr(r) / r, 0.0)
    F = (fr[..., None] * xij).sum(-2)
    return pot, (F * F).sum((-1, -2))


def _trap_f2(system, R, a):
    """Total |F|^2 of trapped slices: the pair force plus the trap's."""
    m, r, xij = all_pairs(system, R)
    fr = torch.where(m & (r > 0.0), system.potential.dvdr(r) / r, 0.0)
    F = (fr[..., None] * xij).sum(-2) + R / a ** 4
    return (F * F).sum((-1, -2))


def total_action_params(system, paths_w, Rm, a_ho=None):
    """The full 4th-order action S(paths; Rm, a_ho) of worldlines
    paths_w[..., M, N, D] (variational.py:144-201).  The trial WF enters at
    the end slices only, and a_ho parameterizes it alone: the trap's
    action terms are the Hamiltonian's, cfg.a_ho."""
    dt = system.cfg.dt
    wv, wf, _ = chin_table(system, paths_w.dtype)
    if system.cfg.trap:
        a_pot = _trap_lengths(system, None, paths_w)
        m, r, _ = all_pairs(system, paths_w)
        pot = 0.5 * torch.where(m, system.potential.v(r), 0.0).sum((-1, -2))
        pot = pot + (0.5 * (paths_w ** 2 / a_pot ** 4).sum(-1)).sum(-1)
        f2 = _trap_f2(system, paths_w, a_pot)
    else:
        pot, f2 = _pair_pot_f2_closed(system, paths_w)
    s = (wv * pot).sum(-1) + (wf * f2).sum(-1)
    s = s - log_trial_wf_params(system, paths_w[..., 0, :, :], Rm, a_ho)
    s = s - log_trial_wf_params(system, paths_w[..., -1, :, :], Rm, a_ho)
    dx = paths_w[..., 1:, :, :] - paths_w[..., :-1, :, :]
    _, rij2 = separation(system, dx)
    return s + rij2.sum((-1, -2)) / (2.0 * dt)


# ---------------------------------------------------------------------------
# Variational (VMC) energy of psi_Rm over a sampled batch, differentiable
# ---------------------------------------------------------------------------

def vmc_energy(system, Rs, Rm, Rm_ref=None, a_ho=None):
    """Reweighted variational energy over slices Rs[W, N, D] sampled from
    |psi_{Rm_ref}|^2 (variational.py:221-241):

        E(Rm) = sum_i w_i E_L(R_i; Rm) / sum_i w_i,
        w_i   = |psi_Rm(R_i) / psi_{Rm_ref}(R_i)|^2,

    differentiable in Rm and a_ho; the reference weights and the shift of
    the log weights carry no gradient (jax.lax.stop_gradient there)."""
    Rm_ref = Rm if Rm_ref is None else Rm_ref
    lw = log_trial_wf_params(system, Rs, Rm, a_ho)
    lw0 = log_trial_wf_params(system, Rs, Rm_ref, a_ho)
    logw = 2.0 * (lw - lw0.detach())
    logw = logw - logw.max().detach()
    w = torch.exp(logw)
    eL = local_energy_params(system, Rs, Rm, a_ho)[0]
    return (w * eL).sum() / w.sum()


def vmc_sweep(system, gen, Rs, Rm, delta, nsweeps: int = 1, a_ho=None):
    """Metropolis sampling of |psi_Rm|^2 over slices Rs[W, N, D] by
    single-particle translations, every particle once per sweep
    (variational.py:244-246), on the generator gen.  Returns (Rs', the
    acceptance fraction as a tensor)."""
    W, N, D = Rs.shape
    Rs = Rs.clone()
    acc = torch.zeros((), dtype=torch.long, device=Rs.device)
    with torch.no_grad():
        lw = log_trial_wf_params(system, Rs, Rm, a_ho)
        for _ in range(nsweeps):
            for ip in range(N):
                dx = delta * (2.0 * torch.rand((W, D), generator=gen,
                                               dtype=Rs.dtype,
                                               device=Rs.device) - 1.0)
                xnew = Rs[:, ip] + dx
                if system.pbc:
                    xnew = wrap(xnew, system.L, system.half)
                Rn = Rs.clone()
                Rn[:, ip] = xnew
                lwn = log_trial_wf_params(system, Rn, Rm, a_ho)
                a = torch.rand((W,), generator=gen, dtype=Rs.dtype,
                               device=Rs.device) < torch.exp(2.0 * (lwn - lw))
                Rs = torch.where(a[:, None, None], Rn, Rs)
                lw = torch.where(a, lwn, lw)
                acc = acc + a.sum()
    return Rs, acc / (W * N * nsweeps)
