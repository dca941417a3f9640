"""The exact-F^2 fold (ops/kernels.pair_fold, fold_route;
csrc/pair_fold.cu).

On the CPU: fold_route's truth table (on for the exact-F^2 He-4
configuration; off with use_pallas=False, the trap, either table, a tp mesh,
a plug-in potential and bfloat16); the brute form (f2_cache=False) never
calls the wrapper; delta_action_rows and delta_action_sum with a fold, which
now reach the fold through the wrapper, equal the composition they ran
before (kept below as `_old_fold_rows`) bit for bit, at every fold_sub,
every form of ip, forward and reversed windows, with and without the u
term and the row weights, in float64 and float32.

On the card (marked cuda, skipped without one): the kernel against the
plain fold (pairwise._fold_rows) for dS and dfield at D = 1..5, float32 and
float64, for six pair models, every fold_sub, every form of ip, forward and
reversed windows, rows and walker sums, walkers whose proposal is their old
position, partners exactly at rcut and at r^2 = 0; at the exact-F^2 cell's
shapes; one launch per fold call; and one whole exact-F^2 step with the
kernel against the same step on the plain fold from the same draws.  The
file imports no JAX, so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_pair_fold.py
"""

import pytest
import torch

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.models import potentials as tpot
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops import pairwise as P
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.pbc import wrap

torch.set_num_threads(1)

DENSITY = {1: 0.36, 2: 0.26, 3: 0.365, 4: 0.4, 5: 0.1}
FOLD_SUBS = ((0, 1), (0, 2), (1, 2))
IP_FORMS = ("int", "walker", "row", "window_row")
W, N, B = 6, 8, 9


def _cfg(W=W, N=N, dim=3, **kw):
    """The exact-F^2 He-4 flagship with the cache (the configuration of
    the benchmark's he4_exact_f2_n64) at N particles and dimension dim."""
    kw = {"exact_f2": True, "f2_cache": True, **kw}
    return flagship_cfg(W).replace(Np=N, dim=dim, density=DENSITY[dim], **kw)


def _system(dtype=torch.float64, device="cpu", **kw):
    return make_system(_cfg(**kw), device, dtype)


def _paths(system, W, seed, device="cpu"):
    """[W, M, N, D] worldlines on a jittered simple lattice of the box (one
    site per particle, a random offset per walker), wrapped."""
    cfg = system.cfg
    D, Np, M = cfg.dim, cfg.Np, system.M
    gen = torch.Generator().manual_seed(seed)
    L = system.L.cpu().double()
    n = -(-Np ** (1.0 / D) // 1)
    n = int(n) if int(n) ** D >= Np else int(n) + 1
    idx = torch.arange(Np)
    site = torch.stack([(idx // n ** k) % n for k in range(D)], -1)
    base = (site.double() + 0.5) / n * L - 0.5 * L
    off = (torch.rand((W, 1, 1, D), generator=gen, dtype=torch.float64)
           - 0.5) * L / n
    paths = base + off + 0.04 * torch.randn((W, M, Np, D), generator=gen,
                                            dtype=torch.float64)
    paths = wrap(paths, L, 0.5 * L)
    return paths.to(device, system.dtype)


def _ip(form, W, B, N, seed, device):
    gen = torch.Generator().manual_seed(seed)
    if form == "int":
        return 3
    shape = {"walker": (W,), "row": (W, B), "window_row": (1, B)}[form]
    return torch.randint(0, N, shape, generator=gen).to(device)


def _case(system, paths, fold_sub, ip_form, rev, seed=0):
    """(R, xnew, xold, ip, ib, fold) of one window of B rows: R a view of
    paths (read backwards with rev), the cache rows under its rows r0::s a
    view of the odd-bead field (a reversed copy with rev), xold the moved
    particle's old positions, xnew displaced by 0.05 sigma (a quarter of
    the walkers proposing their old position)."""
    Wp, M, Np, D = paths.shape
    dev = paths.device
    r0, s = fold_sub
    fodd = P.force_field(system, paths[:, 1::2])
    if fold_sub == (0, 1):
        # a window of odd beads only: the last level of a per-level move
        R = paths[:, 11:11 + 2 * B:2]
        beads = torch.arange(11, 11 + 2 * B, 2)
        fold = fodd[:, 5:5 + B]
    else:
        lo = 11 - r0                            # r0 = 1 on an even start
        R = paths[:, lo:lo + B]
        beads = torch.arange(lo, lo + B)
        k0 = (lo + r0) // 2                     # bead lo + r0 = 2 k0 + 1
        fold = fodd[:, k0:k0 + len(range(r0, B, s))]
    if rev:
        beads = beads.flip(0)
        fold = fold.flip(1)
    Rrow = R.flip(1) if rev else R            # row b of the rows' order
    ip = _ip(ip_form, Wp, B, Np, seed, dev)
    if isinstance(ip, int):
        xold = Rrow[:, :, ip]
    else:
        idx = ip.expand(Wp, B) if ip.dim() == 2 else ip[:, None].expand(Wp, B)
        xold = torch.gather(Rrow, 2, idx[:, :, None, None].expand(
            Wp, B, 1, D))[:, :, 0]
    gen = torch.Generator().manual_seed(seed + 1)
    step = 0.05 * torch.randn(xold.shape, generator=gen, dtype=torch.float64)
    step[::4] = 0.0
    xnew = wrap(xold + step.to(dev, xold.dtype), system.L, system.half)
    return R, xnew, xold.contiguous(), ip, beads.to(dev), fold


def _old_fold_rows(system, R, xnew, xold, ip, ib, fold, fold_sub, need_wf,
                   rev=False, row_weights=None, reduce=False):
    """The fold's rows and field increments as delta_action_rows and
    delta_action_sum composed them before the fold kernel: the window
    flipped for rev, both sides' pair pass with their pair forces
    (kernels.pair_side), the fold's algebra on the rows r0::s, the Chin
    weighting, then the row weights and the walker sums."""
    if rev:
        R = R.flip(1)
    wv, wf, wpsi = P.chin_weights(system, ib, xnew.dtype)
    R, notself = kernels.partners(system, R, ip)
    pot_n, F_n, fp_n, u_n = kernels.pair_side(system, xnew, R, notself, True,
                                              need_wf)
    pot_o, F_o, fp_o, u_o = kernels.pair_side(system, xold, R, notself, True,
                                              need_wf)
    r0, s = fold_sub
    rows = slice(r0, None, s)
    ip_o = ip if isinstance(ip, int) or ip.dim() < 2 else ip[..., rows]
    ns = kernels.self_mask(R.shape[-2], ip_o, R.device)
    Fn, Fo = F_n[..., rows, :], F_o[..., rows, :]
    dg = -(fp_n[..., rows, :, :] - fp_o[..., rows, :, :])
    part = (2.0 * fold * dg + dg * dg).sum((-1, -2))
    dfield = torch.where(~ns[..., None], (Fn - Fo)[..., None, :], dg)
    df2_o = (Fn * Fn).sum(-1) - (Fo * Fo).sum(-1) + part
    if (r0, s) == (0, 1):
        df2 = df2_o
    else:
        df2 = torch.zeros_like(pot_n)
        df2[..., rows] = df2_o
    dS = wv * (pot_n - pot_o) + wf * df2
    if need_wf:
        dS = dS - wpsi * (u_n - u_o)
    if row_weights is not None:
        dS = dS * row_weights
    return (dS.sum(-1) if reduce else dS), dfield


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_fold_route_is_on_for_the_exact_f2_configuration():
    assert kernels.fold_route(_system(torch.float32))
    assert kernels.fold_route(_system(torch.float64))


@pytest.mark.parametrize("off", ["use_pallas", "trap", "v_table", "wf_table",
                                 "tp", "plugin", "bfloat16"])
def test_fold_route_is_off(off):
    """use_pallas=False, the trap, either table, a tp mesh, a plug-in
    potential and bfloat16 run the plain fold, on every device."""
    dtype = torch.bfloat16 if off == "bfloat16" else torch.float32
    mesh = None
    kw = {}
    if off in ("use_pallas", "v_table", "wf_table"):
        kw[off] = off != "use_pallas"
    elif off == "trap":
        kw = dict(trap=True, a_ho=(1.0, 1.0, 1.0), potential="none",
                  jastrow="none")
    elif off == "plugin":
        soft = tpot.get_potential("soft")
        tpot.register("soft_fold_plugin", soft.v, soft.dvdr)
        kw = dict(potential="soft_fold_plugin")
    elif off == "tp":
        from pathintegralgroundstate_torch.parallel.mesh import Mesh
        mesh = Mesh(dp=1, tp=2, rank=0, backend="gloo")
    system = make_system(_cfg(**kw), "cpu", dtype, mesh=mesh)
    assert not kernels.fold_route(system)


def _refuse(*a, **k):
    raise AssertionError("the fold's wrapper was called")


@pytest.mark.parametrize("rev", [False, True])
def test_brute_form_never_calls_the_wrapper(rev, monkeypatch):
    """Without the cache (f2_cache=False) the window pass takes the brute
    whole-configuration difference: delta_action_rows and delta_action_sum
    never reach pair_fold, and neither does a whole step."""
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block
    monkeypatch.setattr(kernels, "pair_fold", _refuse)
    system = make_system(_cfg(W=2, f2_cache=False).replace(
        Nstag=1, Nobdm=1), "cpu", torch.float64)
    paths = _paths(system, 2, seed=1)
    R, xnew, xold, ip, ib, _ = _case(system, paths, (1, 2), "walker", rev)
    rows = P.delta_action_rows(system, R, xnew, xold, ip, ib, rev=rev)
    total = P.delta_action_sum(system, R, xnew, xold, ip, ib, rev=rev)
    assert rows.shape == (2, B) and total.shape == (2,)
    torch.testing.assert_close(total, rows.sum(-1), rtol=0, atol=1e-9)
    sweeper = Sweeper(system)
    run_block(sweeper, init_state(system), 1)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("need_wf", [True, False])
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ip_form", IP_FORMS)
@pytest.mark.parametrize("fold_sub", FOLD_SUBS, ids=str)
def test_rows_equal_the_old_composition_bitwise(fold_sub, ip_form, rev,
                                                need_wf, dtype):
    system = _system(dtype)
    paths = _paths(system, W, seed=sum(fold_sub) + 3 * rev)
    R, xnew, xold, ip, ib, fold = _case(system, paths, fold_sub, ip_form,
                                        rev, seed=7)
    n = kernels.pair_fold.launches
    dS, dfield = P.delta_action_rows(system, R, xnew, xold, ip, ib,
                                     need_wf=need_wf, rev=rev, fold=fold,
                                     fold_sub=fold_sub)
    want = _old_fold_rows(system, R, xnew, xold, ip, ib, fold, fold_sub,
                          need_wf, rev)
    assert torch.equal(dS, want[0]) and torch.equal(dfield, want[1])
    assert dS.shape == (W, B) and dfield.shape == fold.shape
    assert bool(torch.isfinite(dS).all()) and bool(dS.abs().max() > 0)
    assert kernels.pair_fold.launches == n


@pytest.mark.parametrize("row_weights", [False, True], ids=["", "rw"])
@pytest.mark.parametrize("rev", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("ip_form", IP_FORMS)
@pytest.mark.parametrize("fold_sub", FOLD_SUBS, ids=str)
def test_sum_equals_the_old_composition_bitwise(fold_sub, ip_form, rev,
                                                row_weights):
    """delta_action_sum with a fold (the worm centre's 1/2 on row 0 with
    row_weights), with ib per walker [W, B]."""
    system = _system(torch.float64)
    paths = _paths(system, W, seed=11 + sum(fold_sub))
    R, xnew, xold, ip, ib, fold = _case(system, paths, fold_sub, ip_form,
                                        rev, seed=13)
    ib = ib.expand(W, B).contiguous()
    rw = (torch.cat([torch.tensor([0.5]), torch.ones(B - 1)])
          .to(torch.float64) if row_weights else None)
    dS, dfield = P.delta_action_sum(system, R, xnew, xold, ip, ib,
                                    row_weights=rw, rev=rev, fold=fold,
                                    fold_sub=fold_sub)
    want = _old_fold_rows(system, R, xnew, xold, ip, ib, fold, fold_sub,
                          True, rev, rw, reduce=True)
    assert torch.equal(dS, want[0]) and torch.equal(dfield, want[1])
    assert dS.shape == (W,)


def test_wrapper_plain_form_is_the_fold_rows():
    """pair_fold on the CPU is pair_fold_ref, whose rows are _fold_rows'
    on the window in rows' order."""
    system = _system(torch.float64)
    paths = _paths(system, W, seed=5)
    R, xnew, xold, ip, ib, fold = _case(system, paths, (1, 2), "row", True)
    tab = P.chin_table(system)
    got = kernels.pair_fold(system, R, xnew, xold, ip, tab, ib, fold, (1, 2),
                            True, True)
    want = P._fold_rows(system, R.flip(1), xnew, xold, ip, ib, fold, (1, 2),
                        True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (potential, Jastrow): every potential of the kernels' selector, every
# Jastrow
MODELS = (("aziz2", "mcmillan_c1"), ("soft", "dipolar2d"),
          ("dipolar", "dipolar2d"), ("dipolar", "none"), ("none", "none"),
          ("none", "mcmillan_c1"))


def _check_case(system, sys64, R, xnew, xold, ip, ib, fold, fold_sub, rev,
                need_wf=True, rw=None, reduce=False, label=""):
    """One call of the kernel (one launch) against the plain fold on the
    same tensors; in float32 also both against the float64 plain fold of
    the same inputs, rows with a partner at rcut's rounding left out
    (torch_card._fold_held, _fold_near_cut)."""
    from torch_card import _fold_held, _fold_near_cut
    tab = P.chin_table(system)
    n = kernels.pair_fold.launches
    got = kernels.pair_fold(system, R, xnew, xold, ip, tab, ib, fold,
                            fold_sub, need_wf, rev, rw, reduce)
    assert kernels.pair_fold.launches == n + 1, label
    want = kernels.pair_fold_ref(system, R, xnew, xold, ip, tab, ib, fold,
                                 fold_sub, need_wf, rev, rw, reduce)
    truth, excuse, exf = (None, None), None, None
    if R.dtype == torch.float32:
        d = lambda t: t.double() if isinstance(t, torch.Tensor) and \
            t.is_floating_point() else t    # noqa: E731
        truth = kernels.pair_fold_ref(
            sys64, d(R), d(xnew), d(xold), ip, P.chin_table(sys64), ib,
            d(fold), fold_sub, need_wf, rev, d(rw), reduce)
        rows = _fold_near_cut(system, R, xnew, xold, rev)
        excuse = rows.any(-1) if reduce else rows
        r0, s = fold_sub
        exf = rows[:, r0::s]
    _fold_held(f"{label} dS", got[0], want[0], truth[0], excuse)
    _fold_held(f"{label} dfield", got[1], want[1], truth[1], exf)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", MODELS, ids="/".join)
@pytest.mark.parametrize("dim", [1, 2, 3, 4, 5])
def test_kernel_matches_plain_fold(cuda, dim, model, dtype):
    """Every fold_sub, ip form and window direction, rows and walker sums
    (with the worm centre's row weight), N = 8 and 31."""
    pot, jas = model
    for Np in (8, 31):
        system = _system(dtype, cuda, W=16, N=Np, dim=dim, potential=pot,
                         jastrow=jas)
        sys64 = _system(torch.float64, cuda, W=16, N=Np, dim=dim,
                        potential=pot, jastrow=jas)
        assert kernels.fold_route(system)
        paths = _paths(system, 16, seed=dim + Np, device=cuda)
        for fold_sub in FOLD_SUBS:
            for ip_form in IP_FORMS:
                for rev in (False, True):
                    R, xnew, xold, ip, ib, fold = _case(
                        system, paths, fold_sub, ip_form, rev, seed=Np)
                    label = f"D={dim} N={Np} {fold_sub} {ip_form} rev={rev}"
                    _check_case(system, sys64, R, xnew, xold, ip, ib, fold,
                                fold_sub, rev, need_wf=ip_form != "row",
                                label=label)
                    rw = torch.ones(B, dtype=dtype, device=cuda)
                    rw[0] = 0.5
                    _check_case(system, sys64, R, xnew, xold, ip,
                                ib.expand(16, B).contiguous(), fold, fold_sub,
                                rev, rw=rw, reduce=True,
                                label=label + " summed")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("model", MODELS[:3], ids="/".join)
def test_kernel_at_rcut_and_coincident_partners(cuda, model, dtype):
    """A partner exactly at rcut from the proposal (the mask includes r^2 =
    rc^2) and one coinciding with the old position (r^2 = 0: V there, no
    force and no u), on fold rows and even rows."""
    pot, jas = model
    system = _system(dtype, cuda, W=8, potential=pot, jastrow=jas)
    sys64 = _system(torch.float64, cuda, W=8, potential=pot, jastrow=jas)
    paths = _paths(system, 8, seed=3, device=cuda)
    R, xnew, xold, ip, ib, fold = _case(system, paths, (1, 2), "int", False)
    R = R.clone()
    rc = system.geo.rcut
    for b in (1, 2):
        xnew[0, b] = 0.0
        R[0, b, 5] = 0.0
        R[0, b, 5, 0] = rc
        R[1, b, 6] = xold[1, b]
    fold = fold.clone()
    dS, dfield = _check_case(system, sys64, R, xnew, xold, ip, ib, fold,
                             (1, 2), False, label="rcut / r^2 = 0")
    if pot == "aziz2":
        assert bool(torch.isfinite(dS).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_at_the_cells_shapes(cuda, dtype):
    """The exact-F^2 cell's calls at W=1024, N=64: an end window of 16 rows
    over 8 cache rows (the tail reversed), an interior window of 15 over 8,
    the CM move's whole chain of 65 rows over 32 (summed), a worm half of 31
    rows with ip [W] and the centre's row weight (summed)."""
    system = _system(dtype, cuda, W=1024, N=64)
    sys64 = _system(torch.float64, cuda, W=1024, N=64)
    paths = _paths(system, 1024, seed=9, device=cuda)
    M = system.M
    fodd = P.force_field(system, paths[:, 1::2])
    gen = torch.Generator(device=cuda).manual_seed(4)

    def prop(xold):
        return wrap(xold + 0.05 * torch.randn(xold.shape, generator=gen,
                                              device=cuda, dtype=dtype),
                    system.L, system.half)

    ipw = torch.randint(0, 64, (1024,), generator=gen, device=cuda)
    rows = torch.arange(1024, device=cuda)
    cases = []
    # head: beads 0..15, odd rows over cache rows 0..7
    xo = paths[:, :16, 7]
    cases.append(("end head", paths[:, :16], prop(xo), xo, 7,
                  torch.arange(16, device=cuda), fodd[:, :8], (1, 2), False,
                  None, False))
    # tail: beads M-16..M-1 read backwards, rows in head orientation
    xo = paths[:, M - 16:, 7].flip(1)
    cases.append(("end tail", paths[:, M - 16:], prop(xo), xo.contiguous(),
                  7, torch.arange(M - 1, M - 17, -1, device=cuda),
                  fodd[:, M // 2 - 8:].flip(1), (1, 2), True, None, False))
    # interior: beads 11..25 (odd start), cache rows 6..13
    xo = paths[:, 11:26, 7]
    cases.append(("interior", paths[:, 11:26], prop(xo), xo, 7,
                  torch.arange(11, 26, device=cuda), fodd[:, 5:13], (0, 2),
                  False, None, False))
    # CM: the whole chain, every odd bead's cache row
    xo = paths[rows, :, ipw]
    cases.append(("cm", paths, prop(xo), xo, ipw,
                  torch.arange(M, device=cuda), fodd, (1, 2), False, None,
                  True))
    # worm half: beads 32..62, ip [W], row 0 weighted 1/2
    xo = paths[rows, 32:63, ipw].contiguous()
    rw = torch.ones(31, dtype=dtype, device=cuda)
    rw[0] = 0.5
    cases.append(("worm half", paths[:, 32:63], prop(xo), xo, ipw,
                  torch.arange(32, 63, device=cuda), fodd[:, 16:31], (1, 2),
                  False, rw, True))
    for label, R, xn, xo, ip, ib, fold, sub, rev, rw, red in cases:
        _check_case(system, sys64, R, xn, xo, ip, ib, fold, sub, rev,
                    rw=rw, reduce=red, label=label)


@pytest.mark.cuda
def test_routed_calls_are_one_launch_each(cuda, monkeypatch):
    """delta_action_rows and delta_action_sum with a fold launch the fold
    kernel once and no other kernel; off the route (monkeypatched) they
    launch none and give the same values (float64)."""
    system = _system(torch.float64, cuda, W=16)
    paths = _paths(system, 16, seed=2, device=cuda)
    R, xnew, xold, ip, ib, fold = _case(system, paths, (0, 2), "walker",
                                        True)
    kw = dict(rev=True, fold=fold, fold_sub=(0, 2))
    counts = lambda: (kernels.pair_fold.launches,       # noqa: E731
                      kernels.pair_rows.launches, kernels.pair_pot.launches)
    n = counts()
    rows = P.delta_action_rows(system, R, xnew, xold, ip, ib, **kw)
    total = P.delta_action_sum(system, R, xnew, xold, ip, ib, **kw)
    assert counts() == (n[0] + 2, n[1], n[2])
    monkeypatch.setattr(kernels, "fold_route", lambda s: False)
    n = counts()
    rows_p = P.delta_action_rows(system, R, xnew, xold, ip, ib, **kw)
    total_p = P.delta_action_sum(system, R, xnew, xold, ip, ib, **kw)
    assert counts() == n
    for a, b in ((rows, rows_p), (total, total_p)):
        for x, y in zip(a, b):
            assert float((x - y).abs().max()) <= 1e-9 * (
                1 + float(y.abs().max()))


@pytest.mark.cuda
def test_fold_refuses_what_it_cannot_take(cuda):
    system = _system(torch.float64, cuda, W=16)
    paths = _paths(system, 16, seed=2, device=cuda)
    R, xnew, xold, ip, ib, fold = _case(system, paths, (1, 2), "walker",
                                        False)
    tab = P.chin_table(system)
    n = kernels.pair_fold.launches
    for bad in (dict(fold=fold[:, :-1]), dict(fold_sub=(1, 3)),
                dict(xnew=xnew.float()), dict(ib=ib[:-1]),
                dict(ib=ib.int()), dict(ip=ip.int())):
        args = dict(R=R, xnew=xnew, xold=xold, ip=ip, tab=tab, ib=ib,
                    fold=fold, fold_sub=(1, 2))
        args.update(bad)
        with pytest.raises(ValueError):
            kernels.pair_fold(system, **args)
    assert kernels.pair_fold.launches == n


@pytest.mark.cuda
def test_exact_f2_step_fold_kernel_matches_plain_fold(cuda, monkeypatch):
    """One whole exact-F^2 step with the cache (the flagship order, the
    worm included, float64, W=64) with the fold kernel on, against the same
    step on the plain fold from the same draws: one launch per fold call,
    every decision and counter equal, the paths and the force-field cache
    after the step within 1e-10."""
    import torch_card
    from pathintegralgroundstate_torch import sweep as sw
    from pathintegralgroundstate_torch.state import (init_state,
                                                     state_from_numpy,
                                                     state_to_numpy)
    cfg = _cfg(W=64, N=64).replace(dtype="float64", Nstag=1, Nobdm=2)
    system = make_system(cfg, cuda)
    sweeper = sw.Sweeper(system)
    state = init_state(system)
    start = state_to_numpy(state)
    caches, calls = [], [0]
    field, fold_rows = sw.force_field, P._fold_rows

    def kept(*a):
        caches.append(field(*a))
        return caches[-1]

    def counted(*a):
        calls[0] += 1
        return fold_rows(*a)

    monkeypatch.setattr(sw, "force_field", kept)
    rec = torch_card._Recorder(sweeper.draws(state))
    n = kernels.pair_fold.launches
    s1, t1 = sweeper.step(state, sw.zero_stats(system), rec)
    launched = kernels.pair_fold.launches - n
    monkeypatch.setattr(kernels, "fold_route", lambda s: False)
    monkeypatch.setattr(P, "_fold_rows", counted)
    s2, t2 = sweeper.step(state_from_numpy(system, start),
                          sw.zero_stats(system),
                          torch_card._Replayer(rec.log, cuda))
    assert kernels.pair_fold.launches == n + launched
    assert launched == calls[0] > 0
    d = wrap(s1.paths - s2.paths, system.L, system.half)
    assert float(d.abs().max()) <= 1e-10
    a, b = sw.stats_to_numpy(t1), sw.stats_to_numpy(t2)
    assert (a["counters"] == b["counters"]).all()
    for k in ("isopen", "iworm", "iperm"):
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k
    assert len(caches) == 2
    scale = 1 + float(caches[1].abs().max())
    assert float((caches[0] - caches[1]).abs().max()) <= 1e-10 * scale
