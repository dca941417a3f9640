"""The bfloat16 standard of the plain forms and the kernels.

bfloat16 keeps 8 significant bits, and the reference's own jnp forms, run
in bfloat16, differ from the port's by more than an ulp where pair terms
cancel (the order of the operations inside a formula decides the
rounding).  So a bfloat16 result x is not held to another package's x but
to float64 truth x64, the same form evaluated in float64 on the same
bfloat16 inputs:

    |x - x64| <= C * 2**-8 * sum_j |term_j|

where the sum runs over the pair terms that make up x (`*_scale`): a
partner's V and u, and for a force square the square of the summed force
components (V'(r)/r) dx_k, with the form's own masks and Chin weights.
Each term t(r) counts with its sensitivity to the rounding of its inputs,
|t| + s |dt/dr| (a force component also + s |V'/r|): the displacement is
formed in bfloat16 from two coordinates before the minimum image, so it
carries an error of about 2**-9 s with s = r + max_k (|x_k| + |x'_k|),
the size of the numbers subtracted, not of r.  C is
fixed from the reference's jnp forms in bfloat16: their worst ratio on
tests/test_torch_bf16.py's cases (every pair model, D = 1 to 4) is 2.35,
and the port's bfloat16 plain forms reach 4.23 on liquid paths on the
card (D = 1); C = 8 holds both packages' plain forms with a margin (the
tests hold them to it).  The kernels, which compute in float32, are held
to the same C on the card
(tests/test_torch_cuda.py::test_kernels_in_bfloat16_within_the_bound;
worst ratio about 1).  A non-finite truth (an exactly
coincident pair) must be non-finite in x too.
"""

from __future__ import annotations

import torch

from ..ops.kernels import self_mask
from .pbc import all_pairs, pair_geometry

EPS = 2.0 ** -8     # bfloat16's unit roundoff
C = 8.0             # the bound's constant (see the module docstring)


def _terms(system, r, xij, size):
    """Per pair at distance r with displacement xij [..., D] formed from
    coordinates of magnitude up to `size` (max_k |x_k| + |x'_k|): the
    magnitudes |t| + s |dt/dr|, s = r + size, of V, of the force
    components (V'(r)/r) xij_k (plus s |V'(r)/r|) and of u.  The
    derivative of V'(r)/r is a central difference of V' (step 1e-6 r), in
    float64."""
    s = r + size
    vv, dv = system.v_dv(r)
    h = 1e-6 * r
    g = dv / r
    dg = (system.dv(r + h) / (r + h) - system.dv(r - h) / (r - h)) / (2 * h)
    V = vv.abs() + s * dv.abs()
    f = ((g.abs() + s * dg.abs())[..., None] * xij.abs()
         + (s * g.abs())[..., None])
    U = system.u(r).abs() + s * system.du(r).abs()
    return V, f, U


def _size(x, R):
    """max_k |x_k| + |R_jk| per pair of x [..., D] and R [..., N, D]."""
    return (x.abs()[..., None, :] + R.abs()).amax(-1)


def _mags(system, x, R, notself, guard):
    """Per row of x [..., B, D] against R [..., B, N, D]: (sum V, sum_k
    (sum_j f_jk)^2, sum U) of the magnitudes of _terms over the partners
    within rcut; with guard the force and u only where r^2 > 0 (kernel A's
    masks)."""
    xij, rij2, r2s, m = pair_geometry(system, x[..., None, :] - R, notself)
    mf = m & (rij2 > 0.0) if guard else m
    V, f, U = _terms(system, torch.sqrt(r2s), xij, _size(x, R))
    F2 = (torch.where(mf[..., None], f, 0.0).sum(-2) ** 2).sum(-1)
    return (torch.where(m, V, 0.0).sum(-1), F2,
            torch.where(mf, U, 0.0).sum(-1))


def rows_scale(system, R, xnew, xold, ip, tab, ib, need_wf=True,
               need_f2=True, rev=False, row_weights=None, reduce=False):
    """sum |terms| of kernel A's rows (pair_rows_ref's arguments, float64)."""
    if rev:
        R = R.flip(1)
    ns = self_mask(R.shape[-2], ip, R.device)
    Vn, Fn, Un = _mags(system, xnew, R, ns, True)
    Vo, Fo, Uo = _mags(system, xold, R, ns, True)
    w = tab[:, ib].abs()
    s = w[0] * (Vn + Vo)
    if need_f2:
        s = s + w[1] * (Fn + Fo)
    if need_wf:
        s = s + w[2] * (Un + Uo)
    if row_weights is not None:
        s = s * row_weights.abs()
    return s.sum(-1) if reduce else s


def dense_scale(system, R, xnew, xold, ip, with_force=True, tab=None,
                ib=None, wf=0.0):
    """sum |terms| of kernel 3 (raw: (dpot, df2); with tab the action
    delta) on pair_delta_ref's arguments, float64."""
    ns = self_mask(R.shape[-2], ip, R.device)
    Vn, Fn, Un = _mags(system, xnew, R, ns, False)
    Vo, Fo, Uo = _mags(system, xold, R, ns, False)
    sv, sf = Vn + Vo, (Fn + Fo if with_force else torch.zeros_like(Vn))
    if tab is None:
        return sv, sf
    w = tab[:, ib]
    return (w[0].abs() * sv + (w[1] > 0).to(sv.dtype) * abs(wf) * sf
            + torch.where(w[2] > 0, Un + Uo, 0.0))


def u_scale(system, R, xnew, xold, ip):
    """sum |terms| of kernel 4's du, float64."""
    ns = self_mask(R.shape[-2], ip, R.device)
    return (_mags(system, xnew, R, ns, False)[2]
            + _mags(system, xold, R, ns, False)[2])


def pot_scale(system, R, with_force=False):
    """sum |terms| of kernel B's (pot, f2) on R [..., N, D], float64."""
    m, r, xij = all_pairs(system, R)
    V, f, _ = _terms(system, r, xij, _size(R, R[..., None, :, :]))
    pot = 0.5 * torch.where(m, V, 0.0).sum((-1, -2))
    f2 = torch.zeros_like(pot)
    if with_force:
        f2 = (torch.where(m[..., None], f, 0.0).sum(-2) ** 2).sum((-1, -2))
    return pot, f2


def ratio(x, x64, scale) -> float:
    """max |x - x64| / (EPS * scale) over the entries where x64 is finite
    (0 for an exact entry); raises AssertionError unless x is non-finite
    exactly where x64 is."""
    x, x64, scale = (t.detach().to("cpu", torch.float64)
                     for t in (x, x64, scale))
    fin = torch.isfinite(x64)
    if not torch.equal(torch.isfinite(x), fin):
        raise AssertionError(
            f"non-finite values differ from float64 truth's "
            f"({int((~fin).sum())} there, "
            f"{int((~torch.isfinite(x)).sum())} here)")
    err = (x - x64).abs()[fin]
    s = scale[fin]
    if err.numel() == 0:
        return 0.0
    r = torch.where(err > 0, err / (EPS * s), torch.zeros_like(err))
    return float(r.max())
