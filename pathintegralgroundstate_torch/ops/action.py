"""The 4th-order Chin/Simpson short-time action weights (GreenFunction,
global_mod.f90:19-72), as per-bead weight vectors over the worldline.

The torch counterpart of pathintegralgroundstate_tpu/ops/action.py:

    S_pot = sum_ib  wv[ib] * V[ib] + wf[ib] * F2[ib]

opt=0 (action weights, global_mod.f90:31-46): ends dt V/3, even interior
2 dt V/3, odd interior 4 dt/3 (V + dt^2 F2/6); opt=1 (thermodynamic
estimator weights, global_mod.f90:50-65): the same pattern with 1 for dt
and V + dt^2 F2/2 on odd beads.
"""

from __future__ import annotations

import numpy as np
import torch


def _classes(ib, M: int):
    interior = (ib > 0) & (ib < M - 1)
    return interior & (ib % 2 == 1), interior & (ib % 2 == 0)


def _weights(M, w_end, w_even, w_odd, f_odd, dtype, device):
    """(wv[M], wf[M]) built in float64, then cast, as the reference casts
    its float64 weights."""
    odd, even_int = _classes(np.arange(M), M)
    wv = np.where(odd, w_odd, np.where(even_int, w_even, w_end))
    wf = np.where(odd, f_odd, 0.0)
    return (torch.as_tensor(wv, dtype=dtype, device=device),
            torch.as_tensor(wf, dtype=dtype, device=device))


def chin_weights(M: int, dt: float, dtype=torch.float32, device=None):
    """Action weights (opt=0): (wv[M], wf[M])."""
    return _weights(M, dt / 3.0, 2.0 * dt / 3.0, 4.0 * dt / 3.0,
                    4.0 * dt / 3.0 * dt * dt / 6.0, dtype, device)


def chin_weights_thermo(M: int, dt: float, dtype=torch.float32, device=None):
    """Thermodynamic-estimator weights (opt=1): (wv[M], wf[M])."""
    return _weights(M, 1.0 / 3.0, 2.0 / 3.0, 4.0 / 3.0,
                    4.0 / 3.0 * dt * dt / 2.0, dtype, device)


def green_function(opt: int, ib, M: int, dt: float, Pot, F2):
    """Elementwise GreenFunction (global_mod.f90:19-72): ib a long tensor
    of bead indices; Pot and F2 broadcast against it."""
    odd, even_int = _classes(torch.as_tensor(ib), M)
    if opt == 0:
        Vc = Pot + dt * dt * F2 / 6.0
        return torch.where(odd, 4.0 * dt * Vc / 3.0,
                           torch.where(even_int, 2.0 * dt * Pot / 3.0,
                                       dt * Pot / 3.0))
    if opt == 1:
        dVc = Pot + dt * dt * F2 / 2.0
        return torch.where(odd, 4.0 * dVc / 3.0,
                           torch.where(even_int, 2.0 * Pot / 3.0, Pot / 3.0))
    raise ValueError(f"opt must be 0 or 1, got {opt}")
