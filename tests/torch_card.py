"""Helpers of the card tests: liquid-like worldlines and window inputs,
each hand-written kernel held to its float64 plain form with its stated
tolerances, and one step replayed on the card against the CPU from
recorded draws.

The card tests (tests/test_torch_cuda*.py and the card tests of
tests/test_torch_bis_glue.py and tests/test_torch_pair_fold.py) import it,
and so does tools/torch_kernel_ab.py for its inputs.  It imports nothing
of JAX or of the reference package, so it runs on a machine with a card
and without JAX.
"""

import functools

import numpy as np
import torch



def _events_ms(fn, reps=20):
    """Device ms per call of fn(): reps calls queued behind a device sleep,
    so the events time the device's work and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)   # ~0.1 s of device cycles
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _close(name, got, ref, rtol, atol, plain=None, near_cut=None):
    """Max abs error of got against the float64 reference ref.

    float64 (plain is None): every value within atol + rtol |ref|.
    float32: atol grows by twice the plain float32 form's own error at the
    99.99th percentile of the block (32-bit rounding of row sums whose
    terms cancel); a value beyond that must belong to a row with a partner
    within 1e-5 of the cutoff (near_cut), where a 32-bit r^2 lands on the
    other side of the rcut mask than the 64-bit one: V(rcut) = -0.042 K
    for aziz2 at the flagship's box.  Returns (max abs err, rows excused
    by the cutoff)."""
    # non-finite values (a coincident partner of a soft or dipolar core,
    # an overflow of r^-12 in float32): got must be non-finite exactly
    # where the plain form in its own type is (the float64 form where
    # there is none); the finite values are compared
    fin = torch.isfinite(plain if plain is not None else ref)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"{name}: non-finite values differ from the "
                             f"plain form's ({int((~fin).sum())} there, "
                             f"{int((~torch.isfinite(got)).sum())} here)")
    if not bool(fin.all()):
        fin = fin & torch.isfinite(ref)
        got, ref = torch.where(fin, got, 0.0), torch.where(fin, ref, 0.0)
        if plain is not None:
            plain = torch.where(fin, plain, 0.0)
        if isinstance(atol, torch.Tensor):
            atol = torch.where(fin, atol, 0.0)
    err = (got.double() - ref).abs()
    if plain is not None:
        pe = (plain.double() - ref).abs().flatten()
        atol = atol + 2.0 * float(torch.quantile(pe, 0.9999))
    bad = ~(err <= atol + rtol * ref.abs())
    excused = 0
    if bool(bad.any()) and near_cut is not None:
        idx = bad.nonzero()
        cut = near_cut(idx)
        excused = int(cut.sum())
        bad[tuple(idx[cut].T)] = False
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(
            f"{name}: {int(bad.sum())} values beyond rtol={rtol} atol={atol}"
            f" (first: got {got.flatten()[i].item()!r}, "
            f"ref {ref.flatten()[i].item()!r})")
    return float(err.max()), excused


def _tol(dtype, name):
    """(rtol, atol).  float64 differs only by the summation order: rtol
    1e-11, atol 1e-9 for two potential sums that cancel and 1e-7 for the
    force terms, whose pair forces (~1e2 each) cancel to a net |F| and move
    |F|^2 by ~2 |F| eps sum|f_j| ~ 1e-9.  float32 takes the tolerances of
    tests/test_pallas_kernel.py (see _close)."""
    if dtype == torch.float64:
        return 1e-11, (1e-7 if name in ("df2", "f2") else 1e-9)
    return {"dpot": (2e-4, 1e-4), "du": (2e-4, 1e-4), "df2": (2e-4, 1e-3),
            "pot": (2e-4, 1e-3), "f2": (2e-4, 1e-2)}[name]


def _wrap(d, L):
    return torch.remainder(d + 0.5 * L, L) - 0.5 * L


def _near_cut_rows(system, R, xnew, xold, ip, rev):
    """For [k, 2] (w, b) row indices: whether the row has a partner within
    1e-5 of rcut^2 on either side (float64)."""
    L, rc2 = system.geo.Lbox[0], system.geo.rcut2

    def f(idx):
        w, b = idx[:, 0], idx[:, 1]
        br = R.shape[1] - 1 - b if rev else b
        P = R[w, br].double()                              # [k, N, D]
        if isinstance(ip, int):
            p = torch.full_like(w, ip)
        else:
            p = ip[w] if ip.dim() == 1 else ip.expand(R.shape[0], -1)[w, b]
        self_ = torch.arange(P.shape[1], device=P.device) == p[:, None]
        out = torch.zeros_like(w, dtype=torch.bool)
        for x in (xnew, xold):
            d2 = (_wrap(x[w, b].double()[:, None] - P, L) ** 2).sum(-1)
            near = ((d2 / rc2 - 1.0).abs() < 1e-5) & ~self_
            out |= near.any(-1)
        return out
    return f


def _near_cut_confs(system, R):
    """For [k, 2] (w, b) indices of configurations R: whether any pair lies
    within 1e-5 of rcut^2 (float64)."""
    L, rc2 = system.geo.Lbox[0], system.geo.rcut2

    def f(idx):
        P = R[idx[:, 0], idx[:, 1]].double()               # [k, N, D]
        d2 = (_wrap(P[:, :, None] - P[:, None], L) ** 2).sum(-1)
        return ((d2 / rc2 - 1.0).abs() < 1e-5).flatten(1).any(-1)
    return f


def _flagship_paths(cfg, W, dtype, device, seed, dmin=0.95):
    """Liquid-like worldlines: each walker's particles placed by random
    sequential addition with a minimum distance dmin (no lattice shell at
    the cutoff), then 0.03 of gaussian noise per bead."""
    x = _paths64(cfg.Np, cfg.dim, cfg.density, cfg.M, W, seed, dmin)
    return x.to(device=device, dtype=dtype, copy=True)


@functools.lru_cache(maxsize=16)
def _paths64(N, D, density, M, W, seed, dmin):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L = (N / density) ** (1.0 / D)
    X = torch.zeros(W, N, D, dtype=torch.float64)
    for i in range(N):
        todo = torch.ones(W, dtype=torch.bool)
        while bool(todo.any()):
            c = (torch.rand(W, D, generator=g, dtype=torch.float64) - 0.5) * L
            ok = todo.clone()
            if i:
                d2 = (_wrap(c[:, None] - X[:, :i], L) ** 2).sum(-1)
                ok &= d2.min(1).values > dmin * dmin
            X[ok, i] = c[ok]
            todo &= ~ok
    x = X[:, None] + 0.03 * torch.randn(W, M, N, D, generator=g,
                                        dtype=torch.float64)
    return _wrap(x, L)


def _rows_tol(sys64, dtype, R, xnew, xold, ip, ib, need_wf, need_f2, rev,
              rw, reduce):
    """Absolute tolerance of each value of kernel A's weighted output: each
    raw term's own (_tol: atol + rtol |term|, the term from the float64
    plain form) weighted as the term is, times |rw|, summed over the
    walker's rows with reduce."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    terms = K.pair_terms_ref(sys64, R.double(), xnew.double(), xold.double(),
                             ip, need_wf, need_f2, rev)
    w = chin_table(sys64)[:, ib]
    tol = 0.0
    for i, name in enumerate(("dpot", "df2", "du")):
        if terms[i] is not None:
            rtol, atol = _tol(dtype, name)
            tol = tol + w[i] * (atol + rtol * terms[i].abs())
    if rw is not None:
        tol = tol * rw.double().abs()
    return tol.sum(-1) if reduce else tol


def rows_parity(system, sys64, R, xnew, xold, ip, ib, rev, flags, label,
                rw=None, reduce=False):
    """Kernel A (kernels.pair_rows) against its float64 plain form on the
    same inputs, for each (need_wf, need_f2) of flags: float64 within the
    raw terms' tolerances of _tol, weighted as the terms; float32 also
    within twice the plain float32 form's own error (see _close).  Returns
    (max abs err, values excused by the cutoff, cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    f32 = system.dtype == torch.float32
    near = None
    if f32:
        rows_near = _near_cut_rows(system, R, xnew, xold, ip, rev)
        B = R.shape[1]

        def near(idx):
            if not reduce:
                return rows_near(idx)
            w = idx[:, 0].repeat_interleave(B)
            b = torch.arange(B, device=w.device).repeat(len(idx))
            return rows_near(torch.stack([w, b], 1)).view(-1, B).any(-1)
    rw64 = rw.double() if rw is not None else None
    err, excused = 0.0, 0
    for need_wf, need_f2 in flags:
        got = K.pair_rows(system, R, xnew, xold, ip, chin_table(system), ib,
                          need_wf, need_f2, rev, rw, reduce)
        ref = K.pair_rows_ref(sys64, R.double(), xnew.double(),
                              xold.double(), ip, chin_table(sys64), ib,
                              need_wf, need_f2, rev, rw64, reduce)
        plain = (K.pair_rows_ref(system, R, xnew, xold, ip,
                                 chin_table(system), ib, need_wf, need_f2,
                                 rev, rw, reduce) if f32 else None)
        tol = _rows_tol(sys64, system.dtype, R, xnew, xold, ip, ib, need_wf,
                        need_f2, rev, rw, reduce)
        e, n = _close(f"pair_rows {system.dtype} {label} rev={rev} "
                      f"reduce={reduce} wf={need_wf} "
                      f"f2={need_f2}", got, ref, 0.0, tol, plain, near)
        err, excused = max(err, e), excused + n
    return err, excused, len(flags)


def _window_ip(R, ip, g, sigma=0.05):
    """(xnew, xold) of the window R [W, B, N, D] for ip (int, [W], [W, B]
    or [1, B]): xold the moved particle's positions, xnew a gaussian step
    away, with one exactly coincident partner (the worm-pin case)."""
    W, B, N, D = R.shape
    if isinstance(ip, int):
        xold = R[:, :, ip]
    elif ip.dim() == 1:
        xold = R[torch.arange(W, device=R.device), :, ip]
    else:
        xold = R.gather(2, ip.expand(W, B)[:, :, None, None].expand(
            W, B, 1, D))[:, :, 0]
    xnew = xold + sigma * torch.randn(xold.shape, generator=g,
                                      device=R.device, dtype=R.dtype)
    p3 = ip if isinstance(ip, int) else int(
        ip[3] if ip.dim() == 1 else ip.expand(W, B)[3, B // 2])
    xnew[3, B // 2] = R[3, B // 2, (p3 + 1) % N]
    return xnew, xold


def lanes_walkers(G, B, N=64):
    """The fewest walkers at which kernel A's rule (kernels.rows_lanes)
    runs G lanes per row for windows of B rows."""
    from pathintegralgroundstate_torch.ops import kernels as K

    W = -(-K.ROWS_FILL // (G * B))
    if K.rows_lanes(W, B, N) != G:
        raise AssertionError(f"rows_lanes({W}, {B}, {N}) is not {G}")
    return W


def lanes_parity(cfg, dtype, seed=5, base=256):
    """Each lane-group width of kernel A against the plain form at B=1 and
    B=65 (the last B beads of liquid-like paths of `base` walkers, repeated
    to lanes_walkers(G, B) walkers), with ip scalar and [1, B], rows and
    walker sums.  Returns (max abs err, values excused by the cutoff,
    cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, dtype)
    sys64 = make_system(cfg, dev, torch.float64)
    paths = _flagship_paths(cfg, base, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    N, M = cfg.Np, cfg.M
    err, excused, n = 0.0, 0, 0
    for B in (1, 65):
        ib = torch.arange(M - B, M, device=dev)
        for G in K.ROWS_LANES:
            W = lanes_walkers(G, B, N)
            R = paths[:, M - B:].repeat(-(-W // base), 1, 1, 1)[:W]
            for ip in (7, torch.randint(0, N, (1, B), generator=g,
                                        device=dev)):
                xnew, xold = _window_ip(R, ip, g)
                for reduce in (False, True):
                    e, x, c = rows_parity(
                        system, sys64, R, xnew, xold, ip, ib, False,
                        [(True, True), (False, False)],
                        f"B={B} W={W} G={G} ip={ip}", reduce=reduce)
                    err, excused, n = max(err, e), excused + x, n + c
    return err, excused, n


def rows_case(cfg, W, B, seed=3):
    """Kernel A's inputs of an end move's window of B rows at W walkers,
    float32, ip scalar (5), both chain-end rows weighted: (system, window
    pairs for L2-cold rotation, ib).  The window is paths[:, :B] of
    liquid-like paths; for the L2-cold case, enough distinct windows [W,
    B, N, D] (contiguous copies) that more than 64 MB are read between two
    reads of one."""
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, torch.float32)
    paths = _flagship_paths(cfg, W, torch.float32, dev, seed)
    R = paths[:, :B]
    xold = R[:, :, 5]
    xnew = (xold + 0.05).contiguous()
    nbuf = 2 + (64 << 20) // _nbytes(R)
    cold = [(R.contiguous() if i == 0 else
             R.roll(i, 0).contiguous(), xnew.roll(i, 0), xold.roll(i, 0))
            for i in range(nbuf)]
    return system, (R, xnew, xold), cold, torch.arange(B, device=dev)


def _cascade_inputs(cfg, W, dtype, mode, seed):
    """(system, paths, slots, rg, ru, act) of one flagship-shaped cascade
    move on the card; about one slot in ten inactive."""
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    system = make_system(cfg, dev, dtype)
    paths = _flagship_paths(cfg, W, dtype, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, M = 2 ** cfg.Nlev, cfg.M
    if mode == "ends":
        slots = [(0, 1, 5), (M - 1, -1, 5)]
    else:
        slots = [(2 + k * L, 1, p * cfg.Np // 64)
                 for k, p in enumerate((7, 30, 61))]
    S, G = len(slots), cfg.Nlev + (mode == "ends")
    rg = torch.randn((W, S, L + 1, cfg.dim), generator=g, device=dev,
                     dtype=dtype)
    ru = torch.rand((W, S, G), generator=g, device=dev, dtype=dtype)
    act = torch.rand((W, S), generator=g, device=dev) < 0.9
    return system, paths, slots, rg, ru, act


def cascade_check(cfg, W, dtype, mode, seed=11, outcomes="both"):
    """Kernel 5 against cascade_ref (plain pair pass) on the same inputs.

    float64: accepts exactly equal, paths within rtol 1e-11 (atol 1e-12
    for coordinates near 0).  float32: decisions agree on more than 95 %
    of the slots, and where they agree the slot's window within rtol 2e-4 /
    atol 2e-5 (tests/test_cascade.py's criteria); every other bead exactly
    unchanged.  outcomes: 'both' (some active slots accepted and some
    not: the default), 'all' (every active slot accepted: the ideal gas,
    whose gates all see dS = 0) or 'any'.  Returns (agreement share, max
    abs err where agreeing, accepted slots)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref

    system, paths, slots, rg, ru, act = _cascade_inputs(cfg, W, dtype, mode,
                                                        seed)
    nlev, L = cfg.Nlev, 2 ** cfg.Nlev
    got, ref = paths.clone(), paths.clone()
    n = K.cascade.launches
    acc = K.cascade(system, mode, got, slots, rg, ru, act, nlev)
    acc_ref = cascade_ref(system, mode, ref, slots, rg, ru, act, nlev,
                          K.pair_rows_ref)
    torch.cuda.synchronize()
    if K.cascade.launches != n + 1:
        raise AssertionError("cascade did not count its launch")
    n_acc, n_act = int(acc.sum()), int(act.sum())
    if outcomes == "both" and not 0 < n_acc < n_act:
        raise AssertionError(f"cascade {mode}: {n_acc} of {n_act} active "
                             "slots accepted; the check needs both outcomes")
    if outcomes == "all" and n_acc != n_act:
        raise AssertionError(f"cascade {mode}: {n_acc} of {n_act} active "
                             "slots accepted; every gate sees dS = 0")
    if bool((acc & ~act).any()):
        raise AssertionError(f"cascade {mode}: an inactive slot accepted")
    agree = acc == acc_ref
    share = float(agree.double().mean())
    moved = torch.zeros(paths.shape[:3], dtype=torch.bool, device=paths.device)
    err = 0.0
    for s, (b0, step, ip) in enumerate(slots):
        beads = torch.arange(L + 1, device=paths.device) * step + b0
        moved[:, beads, ip] = True
        a = agree[:, s]
        wg, wr = got[a][:, beads, ip], ref[a][:, beads, ip]
        if dtype == torch.float64:
            torch.testing.assert_close(wg, wr, rtol=1e-11, atol=1e-12)
        else:
            torch.testing.assert_close(wg, wr, rtol=2e-4, atol=2e-5)
        err = max(err, float((wg - wr).abs().max()))
    if dtype == torch.float64 and share != 1.0:
        raise AssertionError(f"cascade {mode} float64: accepts differ on "
                             f"{int((~agree).sum())} slots")
    if share <= 0.95:
        raise AssertionError(f"cascade {mode} {dtype}: decisions agree on "
                             f"{share:.4f} of the slots, not > 0.95")
    if not (torch.equal(got[~moved], paths[~moved])
            and torch.equal(ref[~moved], paths[~moved])):
        raise AssertionError(f"cascade {mode}: a bead outside the slots' "
                             "windows moved")
    return share, err, n_acc


def layout_parity(cfg, W=256):
    """Kernels A and 5 where a row of partners is no multiple of 16 bytes,
    so that both stage the partners element by element: N=30 in float32
    (N*D*4 = 360 bytes) and N=31 in float64 (744 bytes), against the plain
    forms with the tolerances above.  Kernel A: windows of B=16 and 65 read
    in place, ip scalar, [W] and [W, B], forward and reversed, rows and
    walker sums; kernel 5: both modes (cascade_check).  Returns the cases."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    n, shares = 0, []
    for dtype, Np in ((torch.float32, 30), (torch.float64, 31)):
        c = cfg.replace(Np=Np)
        system = make_system(c, dev, dtype)
        sys64 = make_system(c, dev, torch.float64)
        paths = _flagship_paths(c, W, dtype, dev, seed=31)
        if K.slabs16(paths):
            raise AssertionError(f"N={Np} {dtype}: rows are 16-byte slabs")
        g = torch.Generator(device=dev).manual_seed(31)
        for B in (16, 65):
            R = paths[:, c.M - B:]
            ib = torch.arange(c.M - B, c.M, device=dev)
            ips = (7, torch.randint(0, Np, (W,), generator=g, device=dev),
                   torch.randint(0, Np, (W, B), generator=g, device=dev))
            for k, ip in enumerate(ips):
                xnew, xold = _window_ip(R, ip, g)
                for rev in (False, True):
                    n += rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                     rev, [(True, True), (False, False)],
                                     f"N={Np} B={B}",
                                     reduce=bool((k + rev) % 2))[2]
        for mode in ("ends", "interior"):
            shares.append(cascade_check(c, W, dtype, mode)[0])
            n += 1
    print(f"[layout] {n} parity cases of kernels A and 5 pass where the "
          f"partners are staged element by element (N=30 float32, N=31 "
          f"float64, W={W}); kernel 5 decisions agree on "
          + ", ".join(f"{s:.6f}" for s in shares) + " of the slots")
    return n


def _by_walkers(fn, R, chunk):
    """fn(R) of a plain form returning a tuple of [W, ...] tensors, computed
    on chunks of `chunk` walkers (the plain forms' [W, B, N, N, D] pair
    tensors of a whole W=1024, N=256 batch would take tens of GB)."""
    outs = [fn(R[i:i + chunk]) for i in range(0, R.shape[0], chunk)]
    return tuple(torch.cat(o) for o in zip(*outs))


def pot_check(system, sys64, R, label, chunk=256):
    """Kernel B (kernels.pair_pot) without and with force against its
    float64 plain form on the same inputs (_close with _tol: float32 also
    within twice the plain float32 form's own error); the plain forms run
    on `chunk` walkers at a time.  Returns (max abs err, values excused by
    the cutoff)."""
    from pathintegralgroundstate_torch.ops import kernels as K

    f32 = system.dtype == torch.float32
    near = _near_cut_confs(system, R) if f32 else None
    err, excused = 0.0, 0
    for wf in (False, True):
        got = K.pair_pot(system, R, wf)
        ref = _by_walkers(lambda r: K.pair_pot_ref(sys64, r.double(), wf),
                          R, chunk)
        plain = (_by_walkers(lambda r: K.pair_pot_ref(system, r, wf), R,
                             chunk) if f32 else (None, None))
        for i, name in enumerate(("pot", "f2")):
            e, n = _close(f"pair_pot {system.dtype} {label} force={wf} "
                          f"{name}", got[i], ref[i], *_tol(system.dtype, name),
                          plain[i], near)
            err, excused = max(err, e), excused + n
    return err, excused


def dense_wf(system, with_force):
    """The dense F^2 weight delta_action passes kernel 3."""
    dt = system.cfg.dt
    return (4.0 * dt / 3.0) * dt * dt / 6.0 if with_force else 0.0


def action_check(system, sys64, R, xnew, xold, ip, ib, with_force, label):
    """The dense action delta in one launch (kernels.pair_delta given the
    Chin table: kernel 3 with kernel 4's pass on the chain-end rows) against
    its float64 plain form on the same inputs: NaN or inf exactly where the
    plain form does; elsewhere within the raw terms' tolerances of _tol
    weighted as the terms, float32 also within twice the plain float32
    form's own error (see _close).  Returns (max abs err, values excused by
    the cutoff, non-finite rows)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.ops.pairwise import chin_table

    f32 = system.dtype == torch.float32
    wf = dense_wf(system, with_force)
    got = K.pair_delta(system, R, xnew, xold, ip, with_force,
                       chin_table(system), ib, wf)
    args64 = (R.double(), xnew.double(), xold.double(), ip)
    du64 = K.pair_u_ref(sys64, *args64)
    tab64 = chin_table(sys64)
    ref = K.pair_delta_ref(sys64, *args64, with_force, tab64, ib, wf)
    nf = ~torch.isfinite(ref)        # NaN (or inf) where the reference is
    torch.testing.assert_close(got[nf], ref[nf].to(got.dtype), rtol=0.0,
                               atol=0.0, equal_nan=True,
                               msg=f"pair_delta action {label}: "
                                   "non-finite rows differ")
    dpot, df2 = K.pair_delta_ref(sys64, *args64, with_force)
    w = tab64[:, ib]
    tol = 0.0
    for term, weight, name in ((dpot, w[0], "dpot"),
                               (df2, (w[1] > 0) * wf, "df2"),
                               (du64, (w[2] > 0).double(), "du")):
        rtol, atol = _tol(system.dtype, name)
        tol = tol + torch.where(weight != 0, weight * (atol + rtol
                                                       * term.abs()), 0.0)
    plain = None
    if f32:
        plain = K.pair_delta_ref(system, R, xnew, xold, ip, with_force,
                                 chin_table(system), ib, wf)
        plain = torch.where(nf, 0.0, plain)
    e, x = _close(f"pair_delta action {system.dtype} {label} "
                  f"force={with_force}",
                  torch.where(nf, 0.0, got), torch.where(nf, 0.0, ref), 0.0,
                  torch.where(nf, 1.0, tol), plain,
                  _near_cut_rows(system, R, xnew, xold, ip, False)
                  if f32 else None)
    return e, x, int(nf.sum())


def dense_raw_check(system, sys64, R, ip, g, label):
    """Kernel 3's raw mode (with and without force) and kernel 4's u mode
    against their float64 plain forms on the rows R [W, B, N, D] of the
    moved particle ip (int, [W] or [W, B]), moved by 0.05 gaussians from g
    (no coincident partner: the dense forms have no r^2 > 0 guard), with
    _close and _tol.  Returns (max abs err of pair_delta, of pair_u, values
    excused by the cutoff, cases)."""
    from pathintegralgroundstate_torch.ops import kernels as K

    W, B, _, D = R.shape
    dtype, f32 = system.dtype, system.dtype == torch.float32
    if isinstance(ip, int):
        xold = R[:, :, ip]
    else:
        ipb = ip[:, None].expand(W, B) if ip.dim() == 1 else ip
        xold = R.gather(2, ipb[:, :, None, None].expand(W, B, 1, D))[:, :, 0]
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g,
                                     device=R.device, dtype=dtype)
    near = _near_cut_rows(system, R, xnew, xold, ip, False) if f32 else None
    args64 = (R.double(), xnew.double(), xold.double(), ip)
    e_delta, excused = 0.0, 0
    for wf in (True, False):
        ref = K.pair_delta_ref(sys64, *args64, wf)
        plain = (K.pair_delta_ref(system, R, xnew, xold, ip, wf)
                 if f32 else (None, None))
        got = K.pair_delta(system, R, xnew, xold, ip, wf)
        for i, name in enumerate(("dpot", "df2")):
            e, n = _close(f"pair_delta {dtype} {label} force={wf} {name}",
                          got[i], ref[i], *_tol(dtype, name), plain[i], near)
            e_delta, excused = max(e_delta, e), excused + n
    ref = K.pair_u_ref(sys64, *args64)
    plain = K.pair_u_ref(system, R, xnew, xold, ip) if f32 else None
    got = K.pair_u(system, R, xnew, xold, ip)
    e_u, n = _close(f"pair_u {dtype} {label} du", got, ref,
                    *_tol(dtype, "du"), plain, near)
    return e_delta, e_u, excused + n, 3


def _fold_near_cut(system, R, xnew, xold, rev):
    """[W, B] rows (in xnew's order) with a partner whose float64 r^2 lies
    within 1e-5 of rcut^2 on either Metropolis side: a float32 r^2 may
    land on the other side of the cutoff in another order of operations
    (V(rcut) is not 0)."""
    from pathintegralgroundstate_torch.utils.pbc import wrap
    R = (R.flip(1) if rev else R).double()
    L, h, rc2 = system.L.double(), system.half.double(), system.geo.rcut2
    out = torch.zeros(R.shape[:2], dtype=torch.bool, device=R.device)
    for x in (xnew, xold):
        d = wrap(x.double()[:, :, None, :] - R, L, h)
        out |= ((d * d).sum(-1) / rc2 - 1.0).abs().lt(1e-5).any(-1)
    return out


def _fold_held(name, got, want, truth=None, excuse=None):
    """(max abs err, values excused) of the fold kernel's output got
    against the plain fold's want in the same type.  Non-finite values
    must sit where the plain form has them; the finite ones are compared:
    float64 within 1e-9 of the largest value; float32 against the float64
    plain fold of the same inputs (truth), within 8 times the plain
    float32 form's own largest error plus 1e-6 of the largest value.  The
    rows in `excuse` (_fold_near_cut) are left out."""
    fin = torch.isfinite(want)
    if not torch.equal(torch.isfinite(got), fin):
        raise AssertionError(f"[fold] {name}: non-finite values differ")
    got, want = torch.where(fin, got, 0.0), torch.where(fin, want, 0.0)
    if truth is not None:
        truth = torch.where(torch.isfinite(truth), truth, 0.0)
    n = 0
    if excuse is not None:
        n = int(excuse.sum())
        got, want = got[~excuse], want[~excuse]
        truth = truth[~excuse] if truth is not None else None
    if not got.numel():
        return 0.0, n
    scale = 1.0 + float(want.abs().max())
    if got.dtype == torch.float64:
        err = float((got - want).abs().max())
        if not err <= 1e-9 * scale:
            raise AssertionError(f"[fold] {name}: {err:.3e} from the plain "
                                 f"fold (scale {scale:.3e})")
        return err, n
    err = float((got.double() - truth).abs().max())
    perr = float((want.double() - truth).abs().max())
    if not err <= 8 * perr + 1e-6 * scale:
        raise AssertionError(f"[fold] {name}: {err:.3e} from float64, the "
                             f"plain float32 fold {perr:.3e}")
    return err, n


# the kernels that replace the JAX package's Pallas kernels, as the
# reference routes them; the glue kernels (bis_propose, bis_accept) have
# a route of their own (kernels.bis_route)
PAIR_KERNELS = ("pair_rows", "pair_pot", "cascade", "pair_delta", "pair_u")


def _kernel_fns():
    """{name: wrapper} of the eight kernels (PAIR_KERNELS, the glue
    kernels bis_propose, bis_accept and the exact-F^2 fold pair_fold); each
    wrapper's .launches counts its kernel's launches."""
    from pathintegralgroundstate_torch.ops import kernels as K
    return {"pair_rows": K.pair_rows, "pair_pot": K.pair_pot,
            "cascade": K.cascade, "pair_delta": K.pair_delta,
            "pair_u": K.pair_u, "bis_propose": K.bis_propose,
            "bis_accept": K.bis_accept, "pair_fold": K.pair_fold}


class _Recorder:
    """A draw source that records what another one returns."""

    def __init__(self, src):
        self.src, self.log = src, []

    def __getattr__(self, name):
        fn = getattr(self.src, name)

        def call(*a, **k):
            out = fn(*a, **k)
            if name != "begin_step":
                self.log.append(out)
            return out
        return call


class _Replayer:
    """Replays recorded draws on another device."""

    def __init__(self, log, device):
        self.log, self.device, self.i = list(log), device, 0

    def _move(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        if isinstance(x, tuple):
            return type(x)(*map(self._move, x)) if hasattr(x, "_fields") \
                else tuple(map(self._move, x))
        return x

    def __getattr__(self, name):
        def call(*a, **k):
            if name == "begin_step":
                return None
            out = self.log[self.i]
            self.i += 1
            return self._move(out)
        return call


def replay_check(cfg, label="flagship", cut=False):
    from pathintegralgroundstate_torch.state import (init_state,
                                                     state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import (Sweeper, stats_to_numpy,
                                                     zero_stats)
    from pathintegralgroundstate_torch.system import make_system

    cfg = cfg.replace(n_walkers=16, dtype="float64")
    if cut:
        # the CPU side of a replay runs the plain forms: the depth is cut
        # to one particle sweep and at most two worm rounds, and every move
        # site of the step still runs
        cfg = cfg.replace(Nstag=min(cfg.Nstag, 1), Nobdm=min(cfg.Nobdm, 2))
    out = []
    rec = start = None
    for dev in ("cpu", "cuda"):
        system = make_system(cfg, dev)
        sweeper = Sweeper(system)
        if dev == "cpu":
            state = init_state(system)
            start = state_to_numpy(state)
            src = rec = _Recorder(sweeper.draws(state))
        else:
            state = state_from_numpy(system, start)
            src = _Replayer(rec.log, torch.device("cuda"))
        state, stats = sweeper.step(state, zero_stats(system), src)
        out.append((state_to_numpy(state), stats_to_numpy(stats)))
    (s_cpu, t_cpu), (s_gpu, t_gpu) = out
    for k in s_cpu:
        if s_cpu[k].dtype.kind == "f":
            np.testing.assert_allclose(s_gpu[k], s_cpu[k], rtol=1e-9,
                                       atol=1e-11, err_msg=k)
        else:
            np.testing.assert_array_equal(s_gpu[k], s_cpu[k], err_msg=k)
    np.testing.assert_array_equal(t_gpu["counters"], t_cpu["counters"])
    for k in t_cpu:
        if k != "counters":
            np.testing.assert_allclose(t_gpu[k], t_cpu[k], rtol=1e-9,
                                       atol=1e-9, err_msg=k)
    print(f"[replay] {label} step at W=16 float64 (Nstag={cfg.Nstag}, "
          f"Nobdm={cfg.Nobdm}): card (kernels) == CPU (plain forms) on "
          f"{len(rec.log)} recorded draw sites; sumE {t_gpu['sumE']:.10g}")


# dims_case's geometries: a 1-D chain at 0.5 sigma^-1 and a 2-D He-4
# film at 0.26 sigma^-2 (about 0.04 A^-2), both under PBC with aziz2
DIMS = ((1, 0.5), (2, 0.26), (4, 0.365), (5, 0.1))


def dims_case(cfg, D, density, dtype, N, W=256):
    """Every kernel at dimension D (PBC, aziz2, mcmillan_c1) with N
    particles at `density`, in dtype, against its plain form with the
    tolerances above: kernel A over windows of
    B=16 and 65 read in place, ip int, [W], [W, B] and [1, B], forward and
    reversed, rows and walker sums, then at each lane-group width
    (lanes_parity); kernel B on both ThermEnergy views; the dense kernel's
    raw and u modes (the gate's row, B=16 with ip [W] and [W, B]) and its
    action mode (the gate's row and whole chains); kernel 5 'ends' and
    'interior' (cascade_check).  Returns (cases, whether kernels A and B
    stage with 16-byte copies, whether kernel 5 takes its bulk copy,
    kernel 5's decision agreement per mode)."""
    from pathintegralgroundstate_torch.ops import kernels as K
    from pathintegralgroundstate_torch.system import make_system

    dev = torch.device("cuda")
    c = cfg.replace(dim=D, Np=N, density=density)
    system = make_system(c, dev, dtype)
    sys64 = make_system(c, dev, torch.float64)
    paths = _flagship_paths(c, W, dtype, dev, seed=40 + N + D)
    g = torch.Generator(device=dev).manual_seed(41)
    M, n = c.M, 0
    for B in (16, 65):
        lo = (M - B) // 2
        R = paths[:, lo:lo + B]
        ib = torch.arange(lo, lo + B, device=dev)
        ips = (7 % N, torch.randint(0, N, (W,), generator=g, device=dev),
               torch.randint(0, N, (W, B), generator=g, device=dev),
               torch.randint(0, N, (1, B), generator=g, device=dev))
        for k, ip in enumerate(ips):
            xnew, xold = _window_ip(R, ip, g)
            for rev in (False, True):
                n += rows_parity(system, sys64, R, xnew, xold, ip, ib, rev,
                                 [(True, True), (False, False)],
                                 f"D={D} N={N} B={B}",
                                 reduce=bool((k + rev) % 2))[2]
    n += lanes_parity(c, dtype, seed=43)[2]
    for sl, view in ((slice(0, M - 1, 2), "even view"),
                     (slice(1, M - 1, 2), "odd view")):
        pot_check(system, sys64, paths[:, sl], f"D={D} N={N} {view}")
        n += 2
    lo = (M - 16) // 2
    Rw = paths[:, lo:lo + 16]
    for R, ip, label in (
            (paths[:, :1], 5, "gate bead 0"),
            (Rw, torch.randint(0, N, (W,), generator=g, device=dev),
             "B=16 ip[W]"),
            (Rw, torch.randint(0, N, (W, 16), generator=g, device=dev),
             "B=16 ip[W, B]")):
        n += dense_raw_check(system, sys64, R, ip, g,
                             f"D={D} N={N} {label}")[3]
    for R, ip, ib, label in (
            (paths[:, :1], 5, system.arange(0, 1), "gate"),
            (paths, torch.randint(0, N, (W,), generator=g, device=dev),
             system.arange(0, M), "whole chains")):
        xnew, xold = _window_ip(R, ip, g)
        for wf in (True, False):
            action_check(system, sys64, R, xnew, xold, ip, ib, wf,
                         f"D={D} N={N} {label}")
            n += 1
    shares = [cascade_check(c, W, dtype, mode, seed=45)[0]
              for mode in ("ends", "interior")]
    torch.cuda.synchronize()
    vec = K.slabs16(paths)
    return n + 2, vec, vec and paths.stride(1) == N * D, shares


# The 1-D harmonic oscillator with its exact trial wavefunction (the verify
# recipe's input): E = 0.5 with variance 0 in every block
HO_IN = """&system
 dim = 1, Np = 1, trap = T /
&samp
 resume = F, dt = 0.05d0, Nb = 8, seed = 1982, delta_cm = 0.5d0, CMFreq = 1,
 sampling = 'sta', Lstag = 8, Nlev = 2, Nstag = 2, Nblock = 2, Nstep = 10,
 Nbin = 50, Nk = 10 /
&obdm
 swapping = F, CWorm = 0.d0, Nobdm = 0, Npw = 0 /
&wavefun
 Nmax = 1000, wf_table = F, v_table = F /
&jastrow
 Rm = 1.20d0 /
&extpot
 a_ho = 1.0d0 /
&tpu
 n_walkers = 16, dtype = 'float64', potential = 'none' /
"""


def trap_replays():
    """The trap's card-vs-CPU replays at W=16 float64 (replay_check): the
    trapped worm flagship (dim 2: staging, worm, swaps, the density map)
    and the 1-D oscillator with the bisection sampler (Nlev=2).  The
    reference routes the trap away from its kernels, and so does the port:
    every kernel's launch count must stay 0 across both."""
    from pathintegralgroundstate_torch.config import load_namelist_config
    from pathintegralgroundstate_torch.flagship import trap_worm_cfg

    kern = _kernel_fns()
    for fn in kern.values():
        fn.launches = 0
    replay_check(trap_worm_cfg(), "trap worm (dim 2)")
    replay_check(load_namelist_config(HO_IN, is_text=True).replace(
        sampling="bis", Nlev=2), "1-D oscillator, bisection")
    launches = {k: fn.launches for k, fn in kern.items()}
    if any(launches.values()):
        raise AssertionError(f"trap replays launched kernels: {launches}")
    print(f"[trap] the trap replays launched no kernel: {launches}")
