"""The hand-written kernels: wrappers, launch counts, plain forms.

The counterpart of pathintegralgroundstate_tpu/ops/pallas_kernels.py and
of the kernel half of ops/cascade_kernels.py.

  pair_rows  kernel A (csrc/pair_rows.cu), replaces pair_rows_pallas: the
             window pass of every move, both Metropolis sides per row.
  pair_pot   kernel B (csrc/pair_pot.cu), replaces pair_pot_pallas: the
             all-pairs potential and force squared of whole configurations.
  cascade    kernel 5 (csrc/cascade.cu), replaces cascade_pallas: one whole
             composite bisection move (modes 'ends' and 'interior').

Each wrapper takes its plain-PyTorch form (pair_rows_ref, pair_pot_ref,
ops/cascade.cascade_ref) only for tensors on the CPU.  On a CUDA tensor it
launches the kernel or raises; there is no fallback.  `pair_rows.launches`,
`pair_pot.launches` and `cascade.launches` count kernel launches, and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.build import kernels
from ..utils.pbc import minimum_image


# ---------------------------------------------------------------------------
# Plain forms
# ---------------------------------------------------------------------------

def self_mask(N: int, ip, device):
    """notself mask against [..., B, N] pair arrays for ip = int, [W],
    [W, B] or [1, B] (long tensors)."""
    iota = torch.arange(N, device=device)
    if isinstance(ip, int):
        return iota != ip                          # [N]
    if ip.dim() == 1:
        return iota[None, None, :] != ip[:, None, None]   # [W, 1, N]
    return iota != ip[..., None]                   # [W, B, N]


def pair_rows_ref(system, R, xnew, xold, ip, need_wf=True, need_f2=True,
                  rev=False):
    """Plain form of kernel A: per row (dpot, df2, du) of xnew/xold[W, B, D]
    against the partners R[W, B, N, D] (pairwise.py:443-478, 512).

    rev=True pairs row b with R[:, B-1-b].  df2 is zero unless need_f2; du
    is None unless need_wf."""
    if rev:
        R = R.flip(1)
    notself = self_mask(R.shape[-2], ip, R.device)

    def side(x):
        xij, rij2 = minimum_image(x[..., None, :] - R, system.L, system.half)
        ns = notself.expand(rij2.shape)
        r2s = torch.where(ns, rij2, 1.0)
        r, rinv = torch.sqrt(r2s), torch.rsqrt(r2s)
        m = ns & (rij2 <= system.geo.rcut2)
        mf = m & (rij2 > 0.0)
        vv, dv = system.potential.v_dv(r, rinv)
        pot = torch.where(m, vv, 0.0).sum(-1)
        f2 = usum = None
        if need_f2:
            F = (torch.where(mf, dv * rinv, 0.0)[..., None] * xij).sum(-2)
            f2 = (F * F).sum(-1)
        if need_wf:
            usum = torch.where(mf, system.u(r), 0.0).sum(-1)
        return pot, f2, usum

    pot_n, f2_n, u_n = side(xnew)
    pot_o, f2_o, u_o = side(xold)
    dpot = pot_n - pot_o
    df2 = f2_n - f2_o if need_f2 else torch.zeros_like(dpot)
    du = u_n - u_o if need_wf else None
    return dpot, df2, du


def pair_pot_ref(system, R, with_force=False):
    """Plain form of kernel B: (pot, f2) of configurations R[..., N, D]
    (pairwise.py:591-617).  pot = 1/2 sum_{i != j} V within rcut; f2 =
    sum_i |F_i|^2 (zeros without force).  No r^2 > 0 guard."""
    geo = system.geo
    N = R.shape[-2]
    xij, rij2 = minimum_image(R[..., :, None, :] - R[..., None, :, :],
                              system.L, system.half)
    notself = ~torch.eye(N, dtype=torch.bool, device=R.device)
    m = notself & (rij2 <= geo.rcut2)
    r = torch.sqrt(torch.where(notself, rij2, 1.0))
    if with_force:
        vv, dv = system.potential.v_dv(r)
        v = torch.where(m, vv, 0.0)
    else:
        v = torch.where(m, system.potential.v(r), 0.0)
    pot = 0.5 * v.sum((-1, -2))
    f2 = torch.zeros_like(pot)
    if with_force:
        fr = torch.where(m, dv / r, 0.0)
        F = (fr[..., None] * xij).sum(-2)
        f2 = (F * F).sum((-1, -2))
    return pot, f2


# ---------------------------------------------------------------------------
# Kernel parameters
# ---------------------------------------------------------------------------

class _PairParams(ctypes.Structure):
    """Mirror of struct PairParams in csrc/pigs_pair.cuh."""
    _fields_ = [("L", ctypes.c_double * 3), ("half", ctypes.c_double * 3)] + [
        (n, ctypes.c_double) for n in (
            "rcut2", "V0", "V0s", "s", "s_inv", "A", "neg_alpha", "beta",
            "two_beta", "C6", "C8", "C10", "Dcore", "d_min", "d_min_inv",
            "two_C8", "four_C10", "Rm", "rc", "u_rc", "du_rc")] + [
        ("c1", ctypes.c_int), ("dim", ctypes.c_int)]


def _params(system) -> _PairParams:
    p = system._consts.get("kernel_params")
    if p is None:
        geo, cfg = system.geo, system.cfg
        L = list(geo.Lbox) + [0.0] * (3 - cfg.dim)
        p = _PairParams(
            L=(ctypes.c_double * 3)(*L),
            half=(ctypes.c_double * 3)(*[0.5 * x for x in L]),
            rcut2=geo.rcut2, Rm=cfg.Rm, rc=geo.rcut, u_rc=system.u_rc,
            du_rc=system.du_rc, c1=int(cfg.jastrow == "mcmillan_c1"),
            dim=cfg.dim, **system.potential.consts)
        system._consts["kernel_params"] = p
    return p


def _check(name, system, R, *xs):
    if R.device.type != "cuda":
        raise ValueError(f"{name}: tensors must be on the CPU or a CUDA "
                         f"device, got {R.device}")
    if R.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 only, got {R.dtype}")
    if R.dim() != 4 or R.shape[-1] != system.cfg.dim or R.shape[-1] > 3:
        raise ValueError(f"{name}: R must be [W, B, N, D<=3], got "
                         f"{tuple(R.shape)}")
    for t in (R,) + xs:
        if t.device != R.device or t.dtype != R.dtype:
            raise ValueError(f"{name}: all tensors on {R.device} in {R.dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the coordinate axis must have "
                             f"stride 1, got strides {t.stride()}")


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

def pair_rows(system, R, xnew, xold, ip, need_wf=True, need_f2=True,
              rev=False):
    """Per row (dpot, df2, du) of the window pass (see pair_rows_ref).

    R [W, B, N, D] is read in place through its strides (a window view of
    paths); rev=True reads its bead rows backwards through a negative bead
    stride instead of a flipped copy.  ip: int, or a long tensor [W] (per
    walker), [W, B] (per row) or [1, B] (per window row, every walker)."""
    if R.device.type == "cpu":
        return pair_rows_ref(system, R, xnew, xold, ip, need_wf, need_f2, rev)
    _check("pair_rows", system, R, xnew, xold)
    W, B, N, D = R.shape
    if xnew.shape != (W, B, D) or xold.shape != (W, B, D):
        raise ValueError(f"pair_rows: xnew/xold must be {(W, B, D)}, got "
                         f"{tuple(xnew.shape)}, {tuple(xold.shape)}")
    if isinstance(ip, int):
        ip_t, mode, ip0 = None, 0, ip
    else:
        if (ip.device != R.device or ip.dtype != torch.long
                or not ip.is_contiguous()
                or ip.shape not in ((W,), (W, B), (1, B))):
            raise ValueError("pair_rows: ip must be an int or a contiguous "
                             f"long tensor [W], [W, B] or [1, B] on "
                             f"{R.device}")
        ip_t, mode, ip0 = ip, (3 if ip.shape == (1, B) else ip.dim()), 0
    out = torch.empty((3 if need_wf else 2, W, B), dtype=R.dtype,
                      device=R.device)
    sW, sB, sN, _ = R.stride()
    base = R.data_ptr()
    if rev:
        base += (B - 1) * sB * R.element_size()
        sB = -sB
    fn = getattr(kernels(), "pigs_pair_rows_" + _suffix(R.dtype))
    err = fn(ctypes.byref(_params(system)), base, sW, sB, sN,
             xnew.data_ptr(), xnew.stride(0), xnew.stride(1),
             xold.data_ptr(), xold.stride(0), xold.stride(1),
             ip_t.data_ptr() if ip_t is not None else None, mode, ip0,
             W, B, N, int(need_wf), int(need_f2),
             out[0].data_ptr(), out[1].data_ptr(),
             out[2].data_ptr() if need_wf else None,
             torch.cuda.current_stream(R.device).cuda_stream)
    if err:
        raise RuntimeError(f"pair_rows: kernel launch failed, cudaError {err}")
    pair_rows.launches += 1
    return out[0], out[1], (out[2] if need_wf else None)


pair_rows.launches = 0


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------

def pair_pot(system, R, with_force=False):
    """(pot, f2) [W, B] of the configurations R[W, B, N, D] (see
    pair_pot_ref); R is read in place through its strides."""
    if R.device.type == "cpu":
        return pair_pot_ref(system, R, with_force)
    _check("pair_pot", system, R)
    W, B, N, D = R.shape
    if N > 1024:
        raise ValueError(f"pair_pot: at most 1024 particles, got {N}")
    out = torch.empty((2, W, B), dtype=R.dtype, device=R.device)
    sW, sB, sN, _ = R.stride()
    fn = getattr(kernels(), "pigs_pair_pot_" + _suffix(R.dtype))
    err = fn(ctypes.byref(_params(system)), R.data_ptr(), sW, sB, sN,
             W, B, N, int(with_force), out[0].data_ptr(), out[1].data_ptr(),
             torch.cuda.current_stream(R.device).cuda_stream)
    if err:
        raise RuntimeError(f"pair_pot: kernel launch failed, cudaError {err}")
    pair_pot.launches += 1
    return out[0], out[1]


pair_pot.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5
# ---------------------------------------------------------------------------

MAX_SLOTS = 64   # kMaxSlots in csrc/cascade.cu


class _CascadeArgs(ctypes.Structure):
    """Mirror of struct CascadeArgs in csrc/cascade.cu."""
    _fields_ = [(n, ctypes.c_double) for n in (
        "dt", "wv_end", "wv_odd", "wf_odd", "wv_even")] + [
        ("bead0", ctypes.c_longlong * MAX_SLOTS),
        ("dir", ctypes.c_int * MAX_SLOTS), ("ip", ctypes.c_int * MAX_SLOTS)]


def _cascade_weights(system) -> dict:
    """The Chin weights kernel 5 takes per window position, read from the
    per-bead table of pairwise.chin_weights at bead 0 (an end), bead 1 (odd
    interior) and bead 2 (even interior): windows are even-aligned, so a
    position's parity is its bead's (cascade_kernels._chin_row_w)."""
    w = system._consts.get("cascade_weights")
    if w is None:
        from .pairwise import _chin_table
        wv, wf, _ = _chin_table(system.M, system.cfg.dt)[:, :3]
        w = dict(wv_end=float(wv[0]), wv_odd=float(wv[1]),
                 wf_odd=float(wf[1]), wv_even=float(wv[2]))
        system._consts["cascade_weights"] = w
    return w


def cascade(system, mode: str, paths, slots, rg, ru, act, nlev: int):
    """One composite cascade move, in place (see ops/cascade.cascade_ref).

    mode 'ends' or 'interior'; slots: S host tuples (bead0, dir, ip), the
    window of slot s being beads bead0 + dir * p, p = 0..2**nlev, of
    particle ip; rg [W, S, L+1, D] gaussians by window position; ru
    [W, S, G] gate uniforms; act [W, S] bool (any strides).  Accepted slots'
    displaced rows are written into paths.  Returns acc [W, S] bool."""
    if paths.device.type == "cpu":
        from .cascade import cascade_ref
        return cascade_ref(system, mode, paths, slots, rg, ru, act, nlev)
    if mode not in ("ends", "interior"):
        raise ValueError(f"cascade: mode 'ends' or 'interior', got {mode!r}")
    _check("cascade", system, paths, rg, ru)
    W, M, N, D = paths.shape
    S, L = len(slots), 2 ** nlev
    G = nlev + (mode == "ends")
    if not 1 <= S <= MAX_SLOTS:
        raise ValueError(f"cascade: 1..{MAX_SLOTS} slots, got {S}")
    if rg.shape != (W, S, L + 1, D) or ru.shape != (W, S, G):
        raise ValueError(f"cascade: rg must be {(W, S, L + 1, D)} and ru "
                         f"{(W, S, G)}, got {tuple(rg.shape)}, "
                         f"{tuple(ru.shape)}")
    if not (rg.is_contiguous() and ru.is_contiguous()):
        raise ValueError("cascade: rg and ru must be contiguous")
    if act.shape != (W, S) or act.dtype != torch.bool \
            or act.device != paths.device:
        raise ValueError(f"cascade: act must be a bool tensor {(W, S)} on "
                         f"{paths.device}")
    if 4 * (L + 1) * 3 * paths.element_size() > 48 * 1024:
        raise ValueError(f"cascade: windows of {L} links exceed the "
                         "kernel's shared memory")
    for b0, step, ip in slots:
        last = b0 + step * L
        if step not in (1, -1) or not (0 <= min(b0, last)
                                       and max(b0, last) < M
                                       and 0 <= ip < N):
            raise ValueError(f"cascade: slot {(b0, step, ip)} does not fit "
                             f"paths {tuple(paths.shape)}")
    a = _CascadeArgs(dt=system.cfg.dt, **_cascade_weights(system))
    for s, (b0, step, ip) in enumerate(slots):
        a.bead0[s], a.dir[s], a.ip[s] = b0, step, ip
    acc = torch.empty((W, S), dtype=torch.bool, device=paths.device)
    sW, sM, sN, _ = paths.stride()
    fn = getattr(kernels(), "pigs_cascade_" + _suffix(paths.dtype))
    err = fn(ctypes.byref(_params(system)), ctypes.byref(a),
             paths.data_ptr(), sW, sM, sN, rg.data_ptr(), ru.data_ptr(),
             act.data_ptr(), act.stride(0), act.stride(1), acc.data_ptr(),
             W, S, N, L, nlev, int(mode == "ends"),
             torch.cuda.current_stream(paths.device).cuda_stream)
    if err:
        raise RuntimeError(f"cascade: kernel launch failed, cudaError {err}")
    cascade.launches += 1
    return acc


cascade.launches = 0
