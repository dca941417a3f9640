"""Batched pair-interaction action deltas (UpdateAction / UpdatePot /
UpdateWf, vpi_mod.f90:2491-2841) and the full-configuration pair sums.

The torch counterpart of pathintegralgroundstate_tpu/ops/pairwise.py: the
non-fold, non-exact-F^2 branch of delta_action_rows, delta_action_sum with
row weights, the dense delta_pot / delta_wf / delta_action (the per-level
end gate's form), and pair_pot.  The pair passes themselves run in
ops/kernels.py (a hand-written kernel on the card, its plain form on the
CPU); kernel A also applies the Chin weights and the row weights and sums
the rows, so delta_action_rows and delta_action_sum are one launch each.

Shapes: R [W, B, N, D] partners at the B displaced beads; xnew/xold
[W, B, D]; ip an int, [W] or [W, B]; ib [B] or [W, B] bead indices.
"""

from __future__ import annotations

import numpy as np

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


def delta_action_rows(system, R, xnew, xold, ip, ib, need_wf=True,
                      need_f2=True, rev=False):
    """Per-row action deltas dS_b = wv dPot + wf dF2 - wpsi dLogPsi, from ONE
    pair pass over the window that also weights the rows (kernels.pair_rows
    with the Chin table).

    need_f2=False: every row's F^2 weight is zero, the force pass is
    skipped and df2 := 0 (the same dS).  need_wf=False: no row is a chain
    end.  rev=True: R is in forward bead order and row b of xnew/xold/ib
    pairs with R[:, B-1-b] (a reversed window read without a copy).
    ib: a long tensor [B] or [W, B] on R's device.  Returns [W, B]."""
    return kernels.pair_rows(system, R, xnew, xold, ip,
                             chin_table(system, xnew.dtype), ib, need_wf,
                             need_f2, rev)


def delta_action_sum(system, R, xnew, xold, ip, ib, need_wf=True,
                     row_weights=None, rev=False, need_f2=True):
    """Summed window action delta [W] (see delta_action_rows), summed in
    the same pass; row_weights [B] scales each row's whole dS (the worm
    centre's 1/2, vpi_mod.f90:1573-1577)."""
    return kernels.pair_rows(system, R, xnew, xold, ip,
                             chin_table(system, xnew.dtype), ib, need_wf,
                             need_f2, rev, row_weights, reduce=True)


def delta_pot(system, R, xnew, xold, ip, with_force=True):
    """UpdatePot (pairwise.py:208-276, closed form, PBC): per row (dPot,
    dF2) of the moved particle against its partners, by kernel 3.  Unlike
    delta_action_rows' rows there is no r^2 > 0 guard; dF2 is zero without
    force.  The exact-F^2 form waits for ROADMAP queue 1, slice 10."""
    if with_force and system.cfg.exact_f2:
        raise NotImplementedError("delta_pot with exact_f2 is not ported to "
                                  "torch yet: ROADMAP queue 1, slice 10")
    return kernels.pair_delta(system, R, xnew, xold, ip, with_force)


def delta_wf(system, R, xnew, xold, ip):
    """UpdateWf (pairwise.py:279-303): per row sum u(new) - sum u(old) over
    the partners, by kernel 4's mode of the dense kernel."""
    return kernels.pair_u(system, R, xnew, xold, ip)


def delta_action(system, R, xnew, xold, ip, ib, with_force=True):
    """The dense per-row action delta (UpdateAction, pairwise.py:306-343):
    wv dPot + wf dF2 - [ib at a chain end] dLogPsi, from one launch and
    nothing after it: kernel 3 with kernel 4's pass on the chain-end rows,
    closing the sum with the Chin table.  The F^2 weight is written as the
    reference writes it here, (4 dt/3) dt^2/6, which can differ from the
    table's 2 dt^3/9 in the last bit; it is zero without force.  ib [B] or
    [W, B]."""
    dt = system.cfg.dt
    wf = (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0
    return kernels.pair_delta(system, R, xnew, xold, ip, with_force,
                              chin_table(system, xnew.dtype), ib, wf)


def pair_pot(system, R, with_force=False):
    """(Pot, F2) of configurations R[..., N, D] (PotentialEnergy,
    sample_mod.f90:13-150): 1/2 sum_{i != j} V(r_ij) within rcut and
    sum_i |F_i|^2 (zeros without force).  On the card R is a 4-D block
    [W, B, N, D] and kernel B runs."""
    return kernels.pair_pot(system, R, with_force)
