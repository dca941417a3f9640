"""Batched pair-interaction action deltas (UpdateAction / UpdatePot /
UpdateWf, vpi_mod.f90:2491-2841) and the full-configuration pair sums.

The torch counterpart of pathintegralgroundstate_tpu/ops/pairwise.py:
delta_action_rows and delta_action_sum with row weights, the dense
delta_pot / delta_wf / delta_action (the per-level end gate's form),
pair_pot, and the exact Chin F^2 of cfg.exact_f2 in its two forms:

  cached (f2_cache, the production form): a force-field cache `fold` of the
      per-particle field at the window's odd beads (force_field) turns the
      F^2 delta into an O(N) fold per displaced bead (delta_pot_cached, the
      fold branch of delta_action_rows), which also returns the cache
      increment `dfield` for accepted moves;
  brute (f2_cache=False, the validation form): F^2(R') - F^2(R) of the
      whole configurations at each displaced bead, two kernel-B passes.

The pair passes themselves run in ops/kernels.py (a hand-written kernel on
the card, its plain form on the CPU); kernel A also applies the Chin
weights and the row weights and sums the rows, so delta_action_rows and
delta_action_sum are one launch each.  Under exact F^2 the reference takes
the window passes off its rows kernel (pairwise.py:415), and the port
takes them off kernel A (kernels.rows_route).  On the card the fold runs
in a kernel of its own (kernels.pair_fold, csrc/pair_fold.cu, route
kernels.fold_route: both sides' pair pass, the fold and the Chin weighting
in one launch); elsewhere it runs in torch (_fold_rows), as it runs in jnp
in the reference.

Shapes: R [W, B, N, D] partners at the B displaced beads; xnew/xold
[W, B, D]; ip an int, [W], [W, B] or [1, B]; ib [B] or [W, B] bead indices.

Under a tp mesh (System.tp) the fold and the force field are partner
seams too (see ops/kernels.py): each rank sums its N/tp partners, and the
partial sums, and the fold's field increments of this rank's partners
(zero-padded), are all-reduced over the tp group.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import jastrow as jas
from ..utils.pbc import all_pairs, pair_geometry
from . import kernels


def _chin_table(M: int, dt: float):
    ib = np.arange(M)
    interior = (ib > 0) & (ib < M - 1)
    odd = interior & (ib % 2 == 1)
    even_i = interior & (ib % 2 == 0)
    wv = np.where(odd, 4.0 * dt / 3.0,
                  np.where(even_i, 2.0 * dt / 3.0, dt / 3.0))
    wf = np.where(odd, 2.0 * dt ** 3 / 9.0, 0.0)
    wpsi = (~interior).astype(np.float64)
    return np.stack([wv, wf, wpsi])


def chin_table(system, dtype=None):
    """The per-bead Chin table [3, M] (wv, wf, wpsi) on the system's
    device, built once per dtype."""
    dtype = dtype or system.dtype
    return system.const(("chin", dtype),
                        lambda: _chin_table(system.M, system.cfg.dt), dtype)


def chin_weights(system, ib, dtype=None):
    """Per-bead Chin opt=0 weights (global_mod.f90:33-46): (wv, wf, wpsi).

    wv: ends dt/3, even interior 2dt/3, odd 4dt/3; wf: odd interior
    (4dt/3) dt^2/6, else 0; wpsi: 1 at beads 0 and 2Nb, else 0."""
    w = chin_table(system, dtype)[:, ib]
    return w[0], w[1], w[2]


def _moved(R, xnew, ip):
    """R with the moved particle ip at xnew[..., B, D] (a copy)."""
    sel = ~kernels.self_mask(R.shape[-2], ip, R.device)[..., None]
    return torch.where(sel, xnew[..., None, :], R)


def _brute_df2(system, R, xnew, ip):
    """Exact F^2(R') - F^2(R) per row, R' = R with ip at xnew: the whole
    configurations' force squares by kernel B, twice (pairwise.py:233-240,
    505-510)."""
    _, f2n = kernels.pair_pot(system, _moved(R, xnew, ip), True)
    _, f2o = kernels.pair_pot(system, R, True)
    return f2n - f2o


def _fold(F_n, F_o, fp_n, fp_o, fold, notself, system=None):
    """The cached exact dF^2 of a move and its field increment dfield [...,
    N, D] from the two sides' forces (kernels.pair_side) and the cache rows
    fold beneath them (pairwise.py:159-205).  Moving ip changes F_ip
    entirely and each partner j by dg_j = -(fp_n - fp_o)_j, so

        dF^2 = |F_ip^new|^2 - |F_ip^old|^2 + sum_j (2 fold_j . dg_j + |dg_j|^2)

    and dfield[ip] = F_ip^new - F_ip^old, dfield[j] = dg_j.  Under tp
    (system.tp) F_n and F_o are whole, fp_n / fp_o / notself this rank's
    partners and fold all N particles' rows: the partner sum and dfield
    (this rank's columns, zeros elsewhere) take one all-reduce."""
    tp = system.tp if system is not None else None
    if tp is not None:
        n = fp_n.shape[-2]
        fold, lo = tp.partners(fold)
    dg = -(fp_n - fp_o)
    part = (2.0 * fold * dg + dg * dg).sum((-1, -2))
    dfield = torch.where(~notself[..., None], (F_n - F_o)[..., None, :], dg)
    if tp is not None:
        full = dfield.new_zeros(dfield.shape[:-2] + (n * tp.tp,
                                                     dfield.shape[-1]))
        full[..., lo:lo + n, :] = dfield
        part, dfield = tp.tp_sum(part, full)
    df2 = (F_n * F_n).sum(-1) - (F_o * F_o).sum(-1) + part
    return df2, dfield


def _fold_rows(system, R, xnew, xold, ip, ib, fold, fold_sub, need_wf):
    """The fold branch of delta_action_rows (pairwise.py:480-499, 514-518):
    (dS [W, B], dfield [W, mo, N, D]) with the exact Chin F^2 of the rows
    r0::s (fold_sub) from the cache rows fold [W, mo, N, D] beneath them.
    The plain form of the fold kernel (kernels.pair_fold_ref)."""
    wv, wf, wpsi = chin_weights(system, ib, xnew.dtype)
    R, notself = kernels.partners(system, R, ip)
    lo = 0 if system.tp is None else system.tp.tp_rank * R.shape[-2]
    pot_n, F_n, fp_n, u_n = kernels.pair_side(system, xnew, R, notself, True,
                                              need_wf)
    pot_o, F_o, fp_o, u_o = kernels.pair_side(system, xold, R, notself, True,
                                              need_wf)
    pot_n, pot_o, F_n, F_o, u_n, u_o = kernels.tp_sum(
        system, pot_n, pot_o, F_n, F_o, u_n, u_o)
    r0, s = fold_sub
    rows = slice(r0, None, s)
    ip_o = ip if isinstance(ip, int) or ip.dim() < 2 else ip[..., rows]
    df2_o, dfield = _fold(F_n[..., rows, :], F_o[..., rows, :],
                          fp_n[..., rows, :, :], fp_o[..., rows, :, :], fold,
                          kernels.self_mask(R.shape[-2], ip_o, R.device, lo),
                          system)
    if (r0, s) == (0, 1):
        df2 = df2_o
    else:
        df2 = torch.zeros_like(pot_n)
        df2[..., rows] = df2_o
    dS = wv * (pot_n - pot_o) + wf * df2
    if need_wf:
        dS = dS - wpsi * (u_n - u_o)
    return dS, dfield


def _brute_rows(system, R, xnew, xold, ip, ib, need_wf):
    """The brute branch of delta_action_rows (pairwise.py:502-510): the
    rows' potential and u terms from the plain window pass, the F^2 term
    the whole configurations' difference (kernel B twice)."""
    wv, wf, wpsi = chin_weights(system, ib, xnew.dtype)
    dpot, _, du = kernels.pair_terms_ref(system, R, xnew, xold, ip, need_wf,
                                         False)
    dS = wv * dpot + wf * _brute_df2(system, R, xnew, ip)
    if need_wf:
        dS = dS - wpsi * du
    return dS


def delta_action_rows(system, R, xnew, xold, ip, ib, need_wf=True,
                      need_f2=True, rev=False, fold=None, fold_sub=(0, 1)):
    """Per-row action deltas dS_b = wv dPot + wf dF2 - wpsi dLogPsi, from ONE
    pair pass over the window that also weights the rows (kernels.pair_rows
    with the Chin table).

    need_f2=False: every row's F^2 weight is zero, the force pass is
    skipped and df2 := 0 (the same dS).  need_wf=False: no row is a chain
    end.  rev=True: R is in forward bead order and row b of xnew/xold/ib
    pairs with R[:, B-1-b] (a reversed window read without a copy).
    ib: a long tensor [B] or [W, B] on R's device.

    cfg.exact_f2: with fold [W, mo, N, D], the force-field cache rows under
    the rows r0::s of fold_sub (the window's odd beads), the F^2 term is
    the exact cached one and the call returns (dS [W, B], dfield [W, mo, N,
    D]), the cache increment of an accepted move; without fold and with
    need_f2 it is the brute whole-configuration difference.  Otherwise the
    reference's partial moved-particle dF^2 (vpi_mod.f90:2825).
    Returns [W, B]."""
    tab = chin_table(system, xnew.dtype)
    if fold is not None:
        return kernels.pair_fold(system, R, xnew, xold, ip, tab, ib, fold,
                                 fold_sub, need_wf, rev)
    if system.cfg.exact_f2 and need_f2:
        return _brute_rows(system, R.flip(1) if rev else R, xnew, xold, ip,
                           ib, need_wf)
    return kernels.pair_rows(system, R, xnew, xold, ip, tab, ib, need_wf,
                             need_f2, rev)


def delta_action_sum(system, R, xnew, xold, ip, ib, need_wf=True,
                     row_weights=None, rev=False, need_f2=True, fold=None,
                     fold_sub=(0, 1)):
    """Summed window action delta [W] (see delta_action_rows), summed in
    the same pass; row_weights [B] scales each row's whole dS (the worm
    centre's 1/2, vpi_mod.f90:1573-1577).  With fold: (dS [W], dfield),
    the walker sums of the fold's rows from the same launch."""
    tab = chin_table(system, xnew.dtype)
    if fold is not None:
        return kernels.pair_fold(system, R, xnew, xold, ip, tab, ib, fold,
                                 fold_sub, need_wf, rev, row_weights,
                                 reduce=True)
    if not (system.cfg.exact_f2 and need_f2):
        return kernels.pair_rows(system, R, xnew, xold, ip, tab, ib, need_wf,
                                 need_f2, rev, row_weights, reduce=True)
    rows = delta_action_rows(system, R, xnew, xold, ip, ib, need_wf, need_f2,
                             rev)
    if row_weights is not None:
        rows = rows * row_weights
    return rows.sum(-1)


def force_field(system, R):
    """Per-particle total force field F[..., N, D] of configurations
    R[..., N, D] (pairwise.py:131-156): sum_j V'(r_ij) (x_i - x_j)/r_ij
    over the partners within rcut (every partner under the trap), plus the
    trap gradient, with the exact-coincidence guard r^2 > 0.  The sweep
    calls it on paths[:, 1::2], the odd beads, the only rows whose F^2
    carries Chin weight."""
    tp = system.tp
    if tp is None:
        m, r, xij = all_pairs(system, R)
    else:
        # this rank's partners j of every particle i, then one all-reduce
        Rj, lo = tp.partners(R)
        notself = (torch.arange(R.shape[-2], device=R.device)[:, None]
                   != torch.arange(lo, lo + Rj.shape[-2], device=R.device))
        xij, _, r2s, m = pair_geometry(
            system, R[..., :, None, :] - Rj[..., None, :, :], notself)
        r = torch.sqrt(r2s)
    fr = torch.where(m & (r > 0.0), system.dv(r) / r, 0.0)
    F = (fr[..., None] * xij).sum(-2)
    a = kernels.one_body(system)
    if a is not None:
        F = F + jas.trap_pot_grad(a, R)
    return kernels.tp_sum(system, F)[0]


def delta_pot_cached(system, R, xnew, xold, ip, fold):
    """Exact Chin dF^2 at O(N B) per displaced bead from the force-field
    cache (pairwise.py:159-205): fold [W, B, N, D], the current forces at
    the displaced beads (rows aligned with R).  Returns (dpot, df2,
    dfield), dfield [W, B, N, D] the field increment of the move (_fold)."""
    R, notself = kernels.partners(system, R, ip)
    pot_n, F_n, fp_n, _ = kernels.pair_side(system, xnew, R, notself, True,
                                            False)
    pot_o, F_o, fp_o, _ = kernels.pair_side(system, xold, R, notself, True,
                                            False)
    pot_n, pot_o, F_n, F_o = kernels.tp_sum(system, pot_n, pot_o, F_n, F_o)
    return (pot_n - pot_o,
            *_fold(F_n, F_o, fp_n, fp_o, fold, notself, system))


def delta_pot(system, R, xnew, xold, ip, with_force=True):
    """UpdatePot (pairwise.py:208-276, closed form, PBC): per row (dPot,
    dF2) of the moved particle against its partners, by kernel 3.  Unlike
    delta_action_rows' rows there is no r^2 > 0 guard; dF2 is zero without
    force.  With cfg.exact_f2 and force, dF2 is the exact F^2(R') - F^2(R)
    of the whole configurations (kernel 3's raw mode for dPot, kernel B
    twice for F^2, pairwise.py:221-240)."""
    if with_force and system.cfg.exact_f2:
        dpot, _ = kernels.pair_delta(system, R, xnew, xold, ip, False)
        return dpot, _brute_df2(system, R, xnew, ip)
    return kernels.pair_delta(system, R, xnew, xold, ip, with_force)


def delta_wf(system, R, xnew, xold, ip):
    """UpdateWf (pairwise.py:279-303): per row sum u(new) - sum u(old) over
    the partners, by kernel 4's mode of the dense kernel."""
    return kernels.pair_u(system, R, xnew, xold, ip)


def delta_action(system, R, xnew, xold, ip, ib, with_force=True):
    """The dense per-row action delta (UpdateAction, pairwise.py:306-343):
    wv dPot + wf dF2 - [ib at a chain end] dLogPsi.  The F^2 weight is
    written as the reference writes it here, (4 dt/3) dt^2/6, which can
    differ from the table's 2 dt^3/9 in the last bit; it is zero without
    force.  ib [B] or [W, B].

    One launch and nothing after it, kernel 3 with kernel 4's pass on the
    chain-end rows closing the sum with the Chin table, except in two
    cases, where the terms come from delta_pot and delta_wf and the Chin
    weights are applied here (pairwise.py:331-343): under cfg.exact_f2 with
    force (that launch's epilogue adds the moved particle's partial dF^2,
    so the exact form is kernel 3's raw mode for dPot, kernel B twice for
    F^2 and kernel 4's u mode), and where the action mode does not run
    (kernels.action_route: under a table the kernel that still applies and
    the plain form of the other half; under the trap both plain)."""
    dt = system.cfg.dt
    wf = (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0
    tab = chin_table(system, xnew.dtype)
    if (with_force and system.cfg.exact_f2) \
            or not kernels.action_route(system):
        dpot, df2 = delta_pot(system, R, xnew, xold, ip, with_force)
        return kernels.chin_action(tab, ib, wf, dpot, df2,
                                   delta_wf(system, R, xnew, xold, ip))
    return kernels.pair_delta(system, R, xnew, xold, ip, with_force, tab, ib,
                              wf)


def pair_pot(system, R, with_force=False):
    """(Pot, F2) of configurations R[..., N, D] (PotentialEnergy,
    sample_mod.f90:13-150): 1/2 sum_{i != j} V(r_ij) within rcut and
    sum_i |F_i|^2 (zeros without force).  On the card R is a 4-D block
    [W, B, N, D] and kernel B runs."""
    return kernels.pair_pot(system, R, with_force)
