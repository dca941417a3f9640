"""The hand-written kernels: wrappers, launch counts, plain forms.

The counterpart of pathintegralgroundstate_tpu/ops/pallas_kernels.py and
of the kernel half of ops/cascade_kernels.py.

  pair_rows  kernel A (csrc/pair_rows.cu), replaces pair_rows_pallas: the
             window pass of every move, both Metropolis sides per row,
             with the Chin-weighted action delta per row or per walker.
  pair_pot   kernel B (csrc/pair_pot.cu), replaces pair_pot_pallas: the
             all-pairs potential and force squared of whole configurations.
  pair_delta kernel 3 (csrc/pair_delta.cu), replaces pair_delta_pallas:
             UpdatePot of the dense delta_action, (dpot, df2) per row, or
             with the Chin table the whole dense action delta per row, in
             one launch that also runs kernel 4's pass on the chain ends.
  pair_u     kernel 4's own mode of the same source, replaces pair_u_pallas:
             UpdateWf of the dense delta_action, du per row.
  cascade    kernel 5 (csrc/cascade.cu), replaces cascade_pallas: one whole
             composite bisection move (modes 'ends' and 'interior').

Each wrapper takes its plain-PyTorch form (pair_rows_ref, pair_pot_ref,
pair_delta_ref, pair_u_ref, ops/cascade.cascade_ref) for tensors on the
CPU, and for a System that its route predicate sends away from the kernel
(`rows_route`, `cascade_route`, `pair_route`, `u_route`:
use_pallas=False, the trap, a plug-in potential, the tables, exact F^2 for
kernels A and 5, and a tp mesh for all five, as the reference routes
them).  Otherwise, on a CUDA tensor, it launches the kernel or raises;
there is no fallback.  Each wrapper's `.launches` counts
its kernel's launches, and nothing else.

Under a tp mesh (System.tp, parallel/mesh.py) the plain forms are the
partner seam: each rank evaluates its N/tp partners (pair_terms_ref,
pair_delta_ref, pair_u_ref) or its N/tp particles' rows (pair_pot_ref)
with the self mask in global particle indices, adds the one-body trap
terms on tp rank 0 only, and all-reduces the partial sums over the tp
group before anything nonlinear in them (|F|^2, the Metropolis test).
"""

from __future__ import annotations

import ctypes

import torch

from ..models import jastrow as jas
from ..utils.build import kernels
from ..utils.pbc import all_pairs, pair_geometry


# ---------------------------------------------------------------------------
# Plain forms
# ---------------------------------------------------------------------------

def self_mask(N: int, ip, device, lo: int = 0):
    """notself mask against [..., B, N] pair arrays for ip = int, [W],
    [W, B] or [1, B] (long tensors); the N partners are the particles
    lo..lo+N-1 (a tp rank's slice)."""
    iota = torch.arange(lo, lo + N, device=device)
    if isinstance(ip, int):
        return iota != ip                          # [N]
    if ip.dim() == 1:
        return iota[None, None, :] != ip[:, None, None]   # [W, 1, N]
    return iota != ip[..., None]                   # [W, B, N]


def partners(system, R, ip):
    """(the partners of this rank, R[..., B, N/tp, D] under tp, else R;
    their self mask against ip in global particle indices)."""
    lo = 0
    if system.tp is not None:
        R, lo = system.tp.partners(R)
    return R, self_mask(R.shape[-2], ip, R.device, lo)


def one_body(system):
    """The trap lengths where this rank adds the one-body terms: under the
    trap, on tp rank 0 only (None elsewhere)."""
    tp = system.tp
    return system.a_ho if tp is None or tp.tp_rank == 0 else None


def tp_sum(system, *ts):
    """ts summed over the tp group in one all-reduce; ts without tp."""
    return ts if system.tp is None else system.tp.tp_sum(*ts)


def pair_side(system, x, R, notself, need_force=True, need_wf=True):
    """One Metropolis side of kernel A's plain form (pairwise.py:443-475):
    per row of x[..., B, D] against the partners R[..., B, N, D], (pot,
    F [..., D], the pair forces fpair [..., N, D], usum), with the trap's
    one-body terms under the trap and the exact-coincidence guard r^2 > 0
    on the force and on u.  F and fpair are None unless need_force, usum
    unless need_wf.  Under tp, R is this rank's partners and the sums are
    its partial sums (the one-body terms on tp rank 0 only)."""
    a = one_body(system)
    xij, rij2, r2s, m = pair_geometry(system, x[..., None, :] - R, notself)
    r, rinv = torch.sqrt(r2s), torch.rsqrt(r2s)
    mf = m & (rij2 > 0.0)
    vv, dv = system.v_dv(r, rinv)
    pot = torch.where(m, vv, 0.0).sum(-1)
    F = fpair = usum = None
    if need_force:
        fpair = torch.where(mf, dv * rinv, 0.0)[..., None] * xij
        F = fpair.sum(-2)
        if a is not None:
            F = F + jas.trap_pot_grad(a, x)
    if a is not None:
        pot = pot + jas.trap_pot(a, x)
    if need_wf:
        usum = torch.where(mf, system.u(r), 0.0).sum(-1)
        if a is not None:
            usum = usum + jas.trap_psi(a, x)
    return pot, F, fpair, usum


def pair_terms_ref(system, R, xnew, xold, ip, need_wf=True, need_f2=True,
                   rev=False):
    """The raw terms of kernel A's plain form: per row (dpot, df2, du) of
    xnew/xold[W, B, D] against the partners R[W, B, N, D]
    (pairwise.py:443-478, 512), with the trap's one-body terms under the
    trap.

    rev=True pairs row b with R[:, B-1-b].  df2 is zero unless need_f2; du
    is None unless need_wf.  Under tp one all-reduce of both sides' sums."""
    if rev:
        R = R.flip(1)
    R, notself = partners(system, R, ip)
    pot_n, F_n, _, u_n = pair_side(system, xnew, R, notself, need_f2,
                                   need_wf)
    pot_o, F_o, _, u_o = pair_side(system, xold, R, notself, need_f2,
                                   need_wf)
    pot_n, pot_o, F_n, F_o, u_n, u_o = tp_sum(system, pot_n, pot_o, F_n, F_o,
                                              u_n, u_o)
    dpot = pot_n - pot_o
    df2 = ((F_n * F_n).sum(-1) - (F_o * F_o).sum(-1) if need_f2
           else torch.zeros_like(dpot))
    du = u_n - u_o if need_wf else None
    return dpot, df2, du


def pair_rows_ref(system, R, xnew, xold, ip, tab, ib, need_wf=True,
                  need_f2=True, rev=False, row_weights=None, reduce=False):
    """Plain form of kernel A: the per-row action deltas
    dS_b = wv dpot + wf df2 - wpsi du (pairwise.py:438-441, 514-516) of the
    terms of pair_terms_ref, with (wv, wf, wpsi) = tab[:, ib] (the Chin
    table [3, M], ib [B] or [W, B] bead indices), times row_weights [B]
    when given.  Returns [W, B], or with reduce the walker sums [W]."""
    dpot, df2, du = pair_terms_ref(system, R, xnew, xold, ip, need_wf,
                                   need_f2, rev)
    w = tab[:, ib]
    dS = w[0] * dpot + w[1] * df2
    if need_wf:
        dS = dS - w[2] * du
    if row_weights is not None:
        dS = dS * row_weights
    return dS.sum(-1) if reduce else dS


# pair elements [.., rows, N, D] of one chunk of pair_pot_ref's blocks
PLAIN_PAIR_ELEMS = 1 << 26


def pair_pot_ref(system, R, with_force=False, shard=True):
    """Plain form of kernel B: (pot, f2) of configurations R[..., N, D]
    (pairwise.py:591-617).  pot = 1/2 sum_{i != j} V within rcut (every
    pair under the trap, plus the trap potential); f2 = sum_i |F_i|^2
    (zeros without force).  No r^2 > 0 guard.

    Under tp (with shard) each rank sums the rows i of its N/tp particles
    against every partner, each F_i whole, and one all-reduce adds the
    ranks' (pot, f2); shard=False sums every row on every rank (the
    differentiable total action).  A 4-D block [W, B, N, D] whose pair
    arrays would exceed PLAIN_PAIR_ELEMS elements runs in bead chunks (each
    bead's sums are its own), as the reference chunks its pair block
    (pairwise.py:570-590)."""
    a = system.a_ho
    tp = system.tp if shard else None
    if R.dim() == 4:
        W, B, N, D = R.shape
        per_bead = W * (N // (tp.tp if tp is not None else 1)) * N * D
        step = max(1, PLAIN_PAIR_ELEMS // per_bead)
        if step < B:
            outs = [pair_pot_ref(system, R[:, b:b + step], with_force, shard)
                    for b in range(0, B, step)]
            return (torch.cat([o[0] for o in outs], 1),
                    torch.cat([o[1] for o in outs], 1))
    if tp is not None:
        Ri, lo = tp.partners(R)
        n = Ri.shape[-2]
        notself = (torch.arange(lo, lo + n, device=R.device)[:, None]
                   != torch.arange(R.shape[-2], device=R.device))
        xij, _, r2s, m = pair_geometry(
            system, Ri[..., :, None, :] - R[..., None, :, :], notself)
        r, R = torch.sqrt(r2s), Ri
    else:
        m, r, xij = all_pairs(system, R)
    if with_force:
        vv, dv = system.v_dv(r)
        v = torch.where(m, vv, 0.0)
    else:
        v = torch.where(m, system.v(r), 0.0)
    pot = 0.5 * v.sum((-1, -2))
    f2 = torch.zeros_like(pot)
    if with_force:
        fr = torch.where(m, dv / r, 0.0)
        F = (fr[..., None] * xij).sum(-2)
        if a is not None:
            F = F + jas.trap_pot_grad(a, R)
        f2 = (F * F).sum((-1, -2))
    if a is not None:
        pot = pot + jas.trap_pot(a, R).sum(-1)
    if tp is not None:
        pot, f2 = tp.tp_sum(pot, f2)
    return pot, f2


def pair_delta_ref(system, R, xnew, xold, ip, with_force=True, tab=None,
                   ib=None, wf=0.0):
    """Plain form of kernel 3: per row (dpot, df2) of xnew/xold[W, B, D]
    against the partners R[W, B, N, D], as the jnp branch of the
    reference's delta_pot (pairwise.py:247-276, closed form), with the
    trap potential and its gradient under the trap.

    Unlike kernel A's rows there is no r^2 > 0 guard on the force; without
    force the potential is V(r), not V of v_dv, and df2 is zero.
    ip: int, [W], [W, B] or [1, B].

    With tab [3, M] (pairwise.chin_table) and ib [B] or [W, B], the form of
    kernels 3 and 4 in one launch: the dense action delta [W, B] of the
    reference's delta_action (pairwise.py:331-343), dS = wv dpot + wf_b
    df2 - where(wpsi > 0, du, 0) with du of pair_u_ref, (wv, _, wpsi) =
    tab[:, ib] and wf_b = wf on odd interior rows (tab[1, ib] > 0), else
    0.  Under tp one all-reduce of both sides' partial sums (and one more
    in pair_u_ref for the action's u)."""
    R_all = R
    R, notself = partners(system, R, ip)
    a = one_body(system)

    def side(x):
        xij, _, r2s, m = pair_geometry(system, x[..., None, :] - R, notself)
        r = torch.sqrt(r2s)
        F = None
        if with_force:
            rinv = torch.rsqrt(r2s)
            vv, dv = system.v_dv(r, rinv)
            pot = torch.where(m, vv, 0.0).sum(-1)
            F = (torch.where(m, dv * rinv, 0.0)[..., None] * xij).sum(-2)
        else:
            pot = torch.where(m, system.v(r), 0.0).sum(-1)
        if a is not None:
            pot = pot + jas.trap_pot(a, x)
            if with_force:
                F = F + jas.trap_pot_grad(a, x)
        return pot, F

    pot_n, F_n = side(xnew)
    pot_o, F_o = side(xold)
    pot_n, pot_o, F_n, F_o = tp_sum(system, pot_n, pot_o, F_n, F_o)
    dpot = pot_n - pot_o
    df2 = ((F_n * F_n).sum(-1) - (F_o * F_o).sum(-1) if with_force
           else torch.zeros_like(dpot))
    if tab is None:
        return dpot, df2
    return chin_action(tab, ib, wf, dpot, df2,
                       pair_u_ref(system, R_all, xnew, xold, ip))


def chin_action(tab, ib, wf, dpot, df2, du):
    """The dense action delta from a row's terms (pairwise.py:331-343):
    dS = wv dpot + wf_b df2 - where(wpsi > 0, du, 0), (wv, _, wpsi) =
    tab[:, ib], wf_b = wf on odd interior rows (tab[1, ib] > 0), else 0."""
    w = tab[:, ib]
    dS = w[0] * dpot + (w[1] > 0).to(dpot.dtype) * wf * df2
    return dS - torch.where(w[2] > 0, du, 0.0)


def pair_u_ref(system, R, xnew, xold, ip):
    """Plain form of kernel 4: per row du = sum u(new) - sum u(old) over the
    partners, as the jnp branch of the reference's delta_wf
    (pairwise.py:291-303): m = notself & r^2 <= rc^2, no r^2 > 0 guard;
    under the trap every partner and the trap's one-body log WF.  Under tp
    one all-reduce of both sides' partial sums."""
    R, notself = partners(system, R, ip)
    a = one_body(system)

    def side(x):
        _, _, r2s, m = pair_geometry(system, x[..., None, :] - R, notself)
        u = torch.where(m, system.u(torch.sqrt(r2s)), 0.0).sum(-1)
        return u + jas.trap_psi(a, x) if a is not None else u

    u_n, u_o = tp_sum(system, side(xnew), side(xold))
    return u_n - u_o


# ---------------------------------------------------------------------------
# Routing and kernel parameters
# ---------------------------------------------------------------------------

def _tables(system) -> bool:
    return system.cfg.v_table or system.cfg.wf_table


def _kernels_on(system) -> bool:
    """What every kernel needs: cfg.use_pallas (False runs the plain forms
    on every device, as the reference's pallas_ok, pallas_ok_wf and
    use_cascade_kernel have it, pallas_kernels.py:321-338,
    cascade_kernels.py:428-436), PBC, a potential of the kernels' selector
    (a plug-in potential, models/potentials.register, has no kind) and no
    tp mesh."""
    return (system.cfg.use_pallas and system.pbc
            and system.potential.kind is not None and system.tp is None)


def rows_route(system) -> bool:
    """Whether kernel A runs this System's window passes: with the kernels
    on (_kernels_on), without exact F^2 and without either table, the
    reference's `not cfg.exact_f2` guard (pairwise.py:415) with
    pallas_rows_ok (pallas_kernels.py:252-258).  Otherwise the plain form
    runs on every device.

    Two departures from the reference, both on purpose: the reference
    keeps its rows kernel off by default (cfg.pallas_rows=False) and
    ignores use_pallas for it; the port runs kernel A by default whatever
    pallas_rows says, and use_pallas=False turns it off with the other
    four, so that one switch gives an all-plain run."""
    return (_kernels_on(system) and not system.cfg.exact_f2
            and not _tables(system))


def cascade_route(system) -> bool:
    """Whether kernel 5 runs the dyadic cascades: with the kernels on,
    without exact F^2 and without either table, as use_cascade_kernel has
    it (cascade_kernels.py:428-436)."""
    return (_kernels_on(system) and not system.cfg.exact_f2
            and not _tables(system))


def pair_route(system) -> bool:
    """Whether kernels B and 3 run: with the kernels on and without
    v_table, as pallas_ok has it (pallas_kernels.py:321-330).  Exact F^2
    keeps them: its brute path calls kernel B on window blocks.

    Each predicate is a route by configuration, as the reference routes
    use_pallas=False, the trap, the tables, exact F^2 and a tp mesh away
    from a kernel: the plain form runs on every device, and a kernel that
    fails still raises."""
    return _kernels_on(system) and not system.cfg.v_table


def u_route(system) -> bool:
    """Whether kernel 4 runs: with the kernels on and without wf_table, as
    pallas_ok_wf has it (pallas_kernels.py:333-338)."""
    return _kernels_on(system) and not system.cfg.wf_table


def action_route(system) -> bool:
    """Whether the dense action delta is kernel 3's action mode, one launch
    that carries kernel 4's u on the chain-end rows: only where both
    kernels run.  Otherwise delta_action takes the kernel that still
    applies and the plain form of the other half, as the reference's
    separate delta_pot / delta_wf calls do (pairwise.py:331-341)."""
    return pair_route(system) and u_route(system)


class _PairParams(ctypes.Structure):
    """Mirror of struct PairParams in csrc/pigs_pair.cuh."""
    _fields_ = [("L", ctypes.c_double * 3), ("half", ctypes.c_double * 3)] + [
        (n, ctypes.c_double) for n in (
            "rcut2", "V0", "V0s", "s", "s_inv", "A", "neg_alpha", "beta",
            "two_beta", "C6", "C8", "C10", "Dcore", "d_min", "d_min_inv",
            "two_C8", "four_C10", "Rm", "rc", "u_rc", "du_rc", "soft_V0",
            "Cdd")] + [
        (n, ctypes.c_int) for n in ("c1", "dim", "pot_kind", "jas_kind")]


def _params(system) -> _PairParams:
    p = system._consts.get("kernel_params")
    if p is None:
        geo, cfg = system.geo, system.cfg
        L = list(geo.Lbox) + [0.0] * (3 - cfg.dim)
        p = _PairParams(
            L=(ctypes.c_double * 3)(*L),
            half=(ctypes.c_double * 3)(*[0.5 * x for x in L]),
            rcut2=geo.rcut2, Rm=cfg.Rm, rc=geo.rcut, u_rc=system.u_rc,
            du_rc=system.du_rc, c1=int(system.c1), dim=cfg.dim,
            pot_kind=system.potential.kind, jas_kind=system.jas_kind,
            **system.potential.consts)
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


def _check_rows(name, system, R, xnew, xold):
    """_check, and xnew/xold [W, B, D] beside R [W, B, N, D]."""
    _check(name, system, R, xnew, xold)
    W, B, _, D = R.shape
    if xnew.shape != (W, B, D) or xold.shape != (W, B, D):
        raise ValueError(f"{name}: xnew/xold must be {(W, B, D)}, got "
                         f"{tuple(xnew.shape)}, {tuple(xold.shape)}")


def _ip_args(name, R, ip):
    """(ip tensor or None, ip mode, scalar ip) of the row kernels: ip an
    int (mode 0) or a contiguous long tensor [W] (1), [W, B] (2) or [1, B]
    (3) on R's device."""
    if isinstance(ip, int):
        return None, 0, ip
    W, B = R.shape[:2]
    if (ip.device != R.device or ip.dtype != torch.long
            or not ip.is_contiguous()
            or ip.shape not in ((W,), (W, B), (1, B))):
        raise ValueError(f"{name}: ip must be an int or a contiguous long "
                         f"tensor [W], [W, B] or [1, B] on {R.device}")
    return ip, (3 if ip.shape == (1, B) else ip.dim()), 0


def _suffix(dtype):
    return "f32" if dtype == torch.float32 else "f64"


# ---------------------------------------------------------------------------
# Kernel A
# ---------------------------------------------------------------------------

SMEM_MAX = 232_448          # shared memory one block may use on the H100
ROWS_LANES = (4, 8, 16, 32)  # the lane-group widths kernel A is built for
ROWS_FILL = 1 << 16          # threads of a launch that fill the card (PERF.md)
ROWS_BLOCK = 256             # threads of a block, unless one walker needs more


class _RowsArgs(ctypes.Structure):
    """Mirror of struct RowsArgs in csrc/pair_rows.cu."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "sRw", "sRb", "sRn", "sNw", "sNb", "sOw", "sOb", "ip0")] + [
        (n, ctypes.c_int) for n in (
            "ip_mode", "ib_mode", "M", "W", "B", "N", "need_wf", "need_f2",
            "reduce", "G", "spw", "wpb", "slab", "vec16")]


def rows_lanes(W: int, B: int, N: int) -> int:
    """Kernel A's lanes per row: the fewest of ROWS_LANES whose W*B*G
    threads fill the card (ROWS_FILL, about 500 per SM: measured at W=1024
    for B = 1..65, PERF.md), but no more than the partners' power of two;
    32 when even that does not fill it."""
    cap = max(4, 1 << (max(N, 1) - 1).bit_length())
    for G in ROWS_LANES:
        if G >= cap or W * B * G >= ROWS_FILL:
            return G
    return ROWS_LANES[-1]


def rows_layout(W: int, B: int, N: int, D: int, esize: int, G: int):
    """(spw, wpb, slab, smem bytes) of one kernel-A launch: row slots per
    walker (all B rows at once up to 512 threads a walker, else balanced
    passes), walkers per block (up to ROWS_BLOCK threads), the shared-memory
    elements per slot and the block's shared memory.  A slot holds a row's
    N*D partners, padded so that slot g's start falls D*G elements (G lanes
    of one partner each) after slot g-1's modulo the 32 banks: the lanes of
    a warp then read distinct banks.  Fewer slots when the block would
    exceed SMEM_MAX; raises ValueError when one slot does."""
    bank = 32 * 4 // esize
    slab = N * D + (D * G - N * D) % bank
    per = (slab + 1) * esize          # a slot's partners and its sum
    most = SMEM_MAX // per
    if most == 0:
        raise ValueError(f"pair_rows: a row of {N} partners needs {per} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    spw = -(-B // max(-(-B * G // 512), -(-B // most)))
    wpb = max(1, min(W, ROWS_BLOCK // (G * spw), most // spw))
    return spw, wpb, slab, wpb * spw * per


def slabs16(t) -> bool:
    """Whether every [N, D] slab of t (its last two axes) is one contiguous
    run of 16-byte multiples at a 16-byte aligned address: t's start and
    every stride but the last two 16-byte multiples.  Kernels A and 5 then
    stage partners with 16-byte (kernel A) or bulk (kernel 5) copies, and
    otherwise element by element through the strides."""
    es = t.element_size()
    N, D = t.shape[-2:]
    return (t.stride(-2) == D and t.data_ptr() % 16 == 0
            and (N * D * es) % 16 == 0
            and all((s * es) % 16 == 0 for s in t.stride()[:-2]))


def pair_rows(system, R, xnew, xold, ip, tab, ib, need_wf=True, need_f2=True,
              rev=False, row_weights=None, reduce=False):
    """Per-row action deltas of the window pass, or with reduce their walker
    sums (see pair_rows_ref).

    R [W, B, N, D] is read in place through its strides (a window view of
    paths); rev=True reads its bead rows backwards through a negative bead
    stride instead of a flipped copy.  ip: int, or a long tensor [W] (per
    walker), [W, B] (per row) or [1, B] (per window row, every walker).
    tab [3, M]: the Chin table (pairwise.chin_table); ib: contiguous long
    [B] or [W, B]; row_weights: [B] or None.  Kernel A runs rows_lanes(W,
    B, N) lanes per row, W the global walker count under dp (so that a
    walker's sums do not depend on the sharding)."""
    if R.device.type == "cpu" or not rows_route(system):
        return pair_rows_ref(system, R, xnew, xold, ip, tab, ib, need_wf,
                             need_f2, rev, row_weights, reduce)
    _check_rows("pair_rows", system, R, xnew, xold)
    W, B, N, D = R.shape
    ip_t, mode, ip0 = _ip_args("pair_rows", R, ip)
    if (ib.device != R.device or ib.dtype != torch.long
            or not ib.is_contiguous() or ib.shape not in ((B,), (W, B))):
        raise ValueError(f"pair_rows: ib must be a contiguous long tensor "
                         f"[B] or [W, B] on {R.device}")
    if (tab.device != R.device or tab.dtype != R.dtype or tab.dim() != 2
            or tab.shape[0] != 3 or not tab.is_contiguous()):
        raise ValueError(f"pair_rows: tab must be a contiguous [3, M] tensor "
                         f"on {R.device} in {R.dtype}")
    if row_weights is not None and (
            row_weights.shape != (B,) or row_weights.device != R.device
            or row_weights.dtype != R.dtype
            or not row_weights.is_contiguous()):
        raise ValueError(f"pair_rows: row_weights must be a contiguous "
                         f"[B] tensor on {R.device} in {R.dtype}")
    G = rows_lanes(W * (system.mesh.dp if system.mesh else 1), B, N)
    spw, wpb, slab, _ = rows_layout(W, B, N, D, R.element_size(), G)
    out = torch.empty((W,) if reduce else (W, B), dtype=R.dtype,
                      device=R.device)
    sW, sB, sN, _ = R.stride()
    base = R.data_ptr()
    if rev:
        base += (B - 1) * sB * R.element_size()
        sB = -sB
    a = _RowsArgs(sRw=sW, sRb=sB, sRn=sN, sNw=xnew.stride(0),
                  sNb=xnew.stride(1), sOw=xold.stride(0),
                  sOb=xold.stride(1), ip0=ip0, ip_mode=mode,
                  ib_mode=ib.dim() - 1, M=tab.shape[1], W=W, B=B, N=N,
                  need_wf=int(need_wf), need_f2=int(need_f2),
                  reduce=int(reduce), G=G, spw=spw, wpb=wpb, slab=slab,
                  vec16=int(slabs16(R)))
    fn = getattr(kernels(), "pigs_pair_rows_" + _suffix(R.dtype))
    err = fn(ctypes.byref(_params(system)), ctypes.byref(a), base,
             xnew.data_ptr(), xold.data_ptr(),
             ip_t.data_ptr() if ip_t is not None else None, ib.data_ptr(),
             tab.data_ptr(),
             row_weights.data_ptr() if row_weights is not None else None,
             out.data_ptr(), torch.cuda.current_stream(R.device).cuda_stream)
    if err:
        raise RuntimeError(f"pair_rows: kernel launch failed, cudaError {err}")
    pair_rows.launches += 1
    return out


pair_rows.launches = 0


# ---------------------------------------------------------------------------
# Kernel B
# ---------------------------------------------------------------------------

class _PotArgs(ctypes.Structure):
    """Mirror of struct PotArgs in csrc/pair_pot.cu (C and rpb are set by
    the kernel's launcher)."""
    _fields_ = [(n, ctypes.c_longlong) for n in ("sRw", "sRb", "sRn")] + [
        (n, ctypes.c_int) for n in ("W", "B", "N", "C", "rpb", "vec16")]


def pair_pot(system, R, with_force=False):
    """(pot, f2) [W, B] of the configurations R[W, B, N, D] (see
    pair_pot_ref); R is read in place through its strides.  Each unordered
    pair is evaluated once, and two launches on the same input give bitwise
    the same sums."""
    if R.device.type == "cpu" or not pair_route(system):
        return pair_pot_ref(system, R, with_force)
    _check("pair_pot", system, R)
    W, B, N, D = R.shape
    if N > 1024:
        raise ValueError(f"pair_pot: at most 1024 particles, got {N}")
    out = torch.empty((2, W, B), dtype=R.dtype, device=R.device)
    sW, sB, sN, _ = R.stride()
    a = _PotArgs(sRw=sW, sRb=sB, sRn=sN, W=W, B=B, N=N,
                 vec16=int(slabs16(R)))
    fn = getattr(kernels(), "pigs_pair_pot_" + _suffix(R.dtype))
    err = fn(ctypes.byref(_params(system)), ctypes.byref(a), R.data_ptr(),
             int(with_force), out[0].data_ptr(), out[1].data_ptr(),
             torch.cuda.current_stream(R.device).cuda_stream)
    if err:
        raise RuntimeError(f"pair_pot: kernel launch failed, cudaError {err}")
    pair_pot.launches += 1
    return out[0], out[1]


pair_pot.launches = 0


# ---------------------------------------------------------------------------
# Kernels 3 and 4
# ---------------------------------------------------------------------------

_RAW, _U, _ACTION = 0, 1, 2  # enum Mode in csrc/pair_delta.cu


class _RowArgs(ctypes.Structure):
    """Mirror of struct RowArgs in csrc/pair_delta.cu."""
    _fields_ = [(n, ctypes.c_longlong) for n in (
        "sRw", "sRb", "sRn", "sNw", "sNb", "sOw", "sOb")] + [
        ("ip_mode", ctypes.c_int), ("ip0", ctypes.c_longlong)] + [
        (n, ctypes.c_int) for n in ("W", "B", "N", "ib_mode", "M")] + [
        ("wf", ctypes.c_double)]


def _dense(name, system, R, xnew, xold, ip, mode, with_force, tab=None,
           ib=None, wf=0.0):
    """One launch of the dense kernel in `mode`: [W, B] rows out (two for
    the raw mode)."""
    _check_rows(name, system, R, xnew, xold)
    ip_t, ip_mode, ip0 = _ip_args(name, R, ip)
    W, B, N, _ = R.shape
    sW, sB, sN, _ = R.stride()
    a = _RowArgs(sRw=sW, sRb=sB, sRn=sN, sNw=xnew.stride(0),
                 sNb=xnew.stride(1), sOw=xold.stride(0), sOb=xold.stride(1),
                 ip_mode=ip_mode, ip0=ip0, W=W, B=B, N=N)
    if mode == _ACTION:
        if (ib.device != R.device or ib.dtype != torch.long
                or not ib.is_contiguous() or ib.shape not in ((B,), (W, B))):
            raise ValueError(f"{name}: ib must be a contiguous long tensor "
                             f"[B] or [W, B] on {R.device}")
        if (tab.device != R.device or tab.dtype != R.dtype or tab.dim() != 2
                or tab.shape[0] != 3 or not tab.is_contiguous()):
            raise ValueError(f"{name}: tab must be a contiguous [3, M] "
                             f"tensor on {R.device} in {R.dtype}")
        a.ib_mode, a.M, a.wf = ib.dim() - 1, tab.shape[1], wf
    out = torch.empty((2 if mode == _RAW else 1, W, B), dtype=R.dtype,
                      device=R.device)
    fn = getattr(kernels(), "pigs_pair_delta_" + _suffix(R.dtype))
    err = fn(ctypes.byref(_params(system)), ctypes.byref(a), R.data_ptr(),
             xnew.data_ptr(), xold.data_ptr(),
             ip_t.data_ptr() if ip_t is not None else None, mode,
             int(with_force),
             ib.data_ptr() if mode == _ACTION else None,
             tab.data_ptr() if mode == _ACTION else None,
             out[0].data_ptr(), out[-1].data_ptr(),
             torch.cuda.current_stream(R.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {err}")
    return out


def pair_delta(system, R, xnew, xold, ip, with_force=True, tab=None, ib=None,
               wf=0.0):
    """Per row (dpot, df2) of UpdatePot, or with tab and ib the dense action
    delta dS [W, B] in one launch that also evaluates UpdateWf's u on the
    chain-end rows (see pair_delta_ref); R [W, B, N, D] is read in place
    through its strides.  tab: the contiguous Chin table [3, M]; ib:
    contiguous long [B] or [W, B]."""
    if R.device.type == "cpu" or not (
            action_route(system) if tab is not None else pair_route(system)):
        return pair_delta_ref(system, R, xnew, xold, ip, with_force, tab, ib,
                              wf)
    out = _dense("pair_delta", system, R, xnew, xold, ip,
                 _RAW if tab is None else _ACTION, with_force, tab, ib, wf)
    pair_delta.launches += 1
    return (out[0], out[1]) if tab is None else out[0]


pair_delta.launches = 0


def pair_u(system, R, xnew, xold, ip):
    """Per row du of UpdateWf (see pair_u_ref), by the dense kernel's u
    mode; R [W, B, N, D] is read in place through its strides."""
    if R.device.type == "cpu" or not u_route(system):
        return pair_u_ref(system, R, xnew, xold, ip)
    out = _dense("pair_u", system, R, xnew, xold, ip, _U, False)
    pair_u.launches += 1
    return out[0]


pair_u.launches = 0


# ---------------------------------------------------------------------------
# Kernel 5
# ---------------------------------------------------------------------------

MAX_SLOTS = 64          # kMaxSlots in csrc/cascade.cu
CASCADE_BLOCK = 64      # kThreads in csrc/cascade.cu: threads per slot


def cascade_smem(L: int, N: int, D: int, esize: int, ngate: int = 5) -> int:
    """Kernel 5's shared memory per block (cascade_smem_elems in
    csrc/cascade.cu): the window's L+1 partner rows, the moved particle's
    old and proposed positions and the slot's gaussians, its ngate gate
    uniforms, and two sets of a gate's row sums."""
    buf = max(L // 2, CASCADE_BLOCK // 4)
    return ((L + 1) * N * D + 9 * (L + 1) + ngate + 2 * buf) * esize


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
    if paths.device.type == "cpu" or not cascade_route(system):
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
    smem = cascade_smem(L, N, D, paths.element_size(), G)
    if smem > SMEM_MAX:
        raise ValueError(f"cascade: a window of {L} links of {N} particles "
                         f"needs {smem} bytes of shared memory, more than "
                         f"{SMEM_MAX}")
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
    # one bulk copy per window where a window is one aligned contiguous slab
    bulk = slabs16(paths) and sM == N * D
    fn = getattr(kernels(), "pigs_cascade_" + _suffix(paths.dtype))
    err = fn(ctypes.byref(_params(system)), ctypes.byref(a),
             paths.data_ptr(), sW, sM, sN, rg.data_ptr(), ru.data_ptr(),
             act.data_ptr(), act.stride(0), act.stride(1), acc.data_ptr(),
             W, S, N, L, nlev, int(mode == "ends"), int(bulk),
             torch.cuda.current_stream(paths.device).cuda_stream)
    if err:
        raise RuntimeError(f"cascade: kernel launch failed, cudaError {err}")
    cascade.launches += 1
    return acc


cascade.launches = 0
