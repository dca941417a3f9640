"""The reference of the exact Chin F^2 term (reference/exact_f2.py, through
reference/moves.py) against the program's own forms of it, both in
float64 at a small size: the brute whole-configuration difference
(`pairwise._brute_rows`, `_brute_df2`) and the cached fold on a fresh
force field (`pairwise._fold_rows`, reached through `delta_action_rows`,
and `delta_pot_cached`), for a CM window, an interior bisection window
whose odd rows are its rows 0::2, and a reversed worm half-window, at
D = 1, 2, 3.  Without exact F^2 the reference's rows are the partial
ones, bit for bit."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from pigsbench.harness import manifest, window  # noqa: E402
from pigsbench.reference import exact_f2  # noqa: E402
from pigsbench.reference import moves as ref_mv  # noqa: E402
from pigsbench.reference.physics import (PairModel, chin_weights,  # noqa: E402
                                         geometry, wrap)

W, N, NB = 6, 8, 4
M = 2 * NB + 1
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module", params=[1, 2, 3])
def setup(request):
    D = request.param
    port = window.port_modules()
    wl = manifest.workload("he4_exact_f2.w1024")
    conf = manifest.config(wl["config"])
    fields = {**window.sim_fields({**wl, "walkers": W}, conf), "Np": N,
              "Nb": NB, "dim": D, "dtype": "float64"}
    system = port.system.make_system(port.config.SimConfig(**fields), "cpu")
    gen = torch.Generator().manual_seed(SEED + D)
    start = window.start_positions(fields, SEED + D, 0.1, "cpu",
                                   torch.float64)
    paths = start[:, None].expand(W, M, N, D) + 0.1 * torch.randn(
        (W, M, N, D), generator=gen, dtype=torch.float64)
    paths = wrap(paths, geometry(fields).L).contiguous()
    return port, fields, system, paths, gen


def _reference(fields, paths, p, beads, xnew, xold):
    """(dS [s, B], F^2 rows [B], dfield [s, B, N, D], unweighted dF2) of
    the reference."""
    geo, model = geometry(fields), PairModel(fields)
    dS, f2, dfield = ref_mv._rows_dS(fields, geo, model, paths, xnew, xold,
                                     p, beads)
    wf = chin_weights(M, fields["dt"], paths.dtype, paths.device)[1, beads]
    df2 = exact_f2.rows(geo, model, paths, p, beads, xnew, xold, wf)[0]
    return dS, f2, dfield, df2


def _close(a, b):
    torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-8)


def test_cm_window(setup):
    port, fields, system, paths, gen = setup
    pw, D = port.pairwise, paths.shape[-1]
    ip = 3
    ib = torch.arange(M)
    xold = paths[:, :, ip]
    xnew = wrap(xold + 0.3 * (2.0 * torch.rand(
        (W, 1, D), generator=gen, dtype=torch.float64) - 1.0),
        geometry(fields).L)
    fodd = pw.force_field(system, paths[:, 1::2])
    dS, dfield = pw._fold_rows(system, paths, xnew, xold, ip, ib, fodd,
                               (1, 2), True)
    p = torch.full((W,), ip)
    ref, f2, ref_df, df2 = _reference(fields, paths, p, ib, xnew, xold)
    assert f2.tolist() == [b % 2 == 1 and 0 < b < M - 1 for b in range(M)]
    _close(dS, ref)
    _close(dfield, ref_df[:, 1::2])
    _close(pw._brute_rows(system, paths, xnew, xold, ip, ib, True), ref)
    _close(pw._brute_df2(system, paths, xnew, ip)[:, f2], df2[:, f2])
    # the rows carry the term: the partial form differs
    part = ref_mv._rows_dS({**fields, "exact_f2": False}, geometry(fields),
                           PairModel(fields), paths, xnew, xold, p, ib)
    assert not torch.allclose(part, ref, rtol=1e-6, atol=0.0)


def test_bisection_window_of_odd_rows(setup):
    port, fields, system, paths, gen = setup
    pw, D = port.pairwise, paths.shape[-1]
    ip, ii, L = 5, 2, 4
    rows = torch.arange(ii + 1, ii + L)          # beads 3, 4, 5
    xold = paths[:, ii + 1:ii + L, ip]
    xnew = wrap(xold + 0.2 * torch.randn((W, L - 1, D), generator=gen,
                                         dtype=torch.float64),
                geometry(fields).L)
    fodd = pw.force_field(system, paths[:, 1::2])
    k0 = (ii + 1) // 2
    f_seg = fodd[:, k0:k0 + L // 2]              # the cache rows of 3 and 5
    dS, dfield = pw.delta_action_rows(system, paths[:, ii + 1:ii + L], xnew,
                                      xold, ip, rows, need_wf=False,
                                      fold=f_seg, fold_sub=(0, 2))
    p = torch.full((W,), ip)
    ref, f2, ref_df, df2 = _reference(fields, paths, p, rows, xnew, xold)
    assert f2.tolist() == [True, False, True]
    _close(dS, ref)
    _close(dfield, ref_df[:, 0::2])
    _close(pw._brute_rows(system, paths[:, ii + 1:ii + L], xnew, xold, ip,
                          rows, False), ref)
    odd = paths[:, ii + 1:ii + L:2]
    dpot, df2_c, df_c = pw.delta_pot_cached(system, odd, xnew[:, 0::2],
                                            xold[:, 0::2], ip, f_seg)
    _close(df2_c, df2[:, 0::2])
    _close(df_c, ref_df[:, 0::2])


def test_reversed_worm_half_window(setup):
    port, fields, system, paths, gen = setup
    pw, D = port.pairwise, paths.shape[-1]
    # the second half's beads Nb+1 .. M-1 read backwards, a particle per
    # walker (the worm's)
    lo, hi = NB + 1, M
    B = hi - lo
    ip = torch.randint(0, N, (W,), generator=gen)
    beads = torch.arange(hi - 1, lo - 1, -1)      # head orientation
    walk = torch.arange(W)[:, None]
    xold = paths[walk, beads[None, :], ip[:, None]]
    xnew = wrap(xold + 0.2 * torch.randn((W, B, D), generator=gen,
                                         dtype=torch.float64),
                geometry(fields).L)
    fodd = pw.force_field(system, paths[:, 1::2])
    f_seg, sub, _ = port.moves._codd_window_rev(fodd, hi - 1, B)
    dS, dfield = pw.delta_action_rows(system, paths[:, lo:hi], xnew, xold,
                                      ip, beads, need_wf=True, rev=True,
                                      fold=f_seg, fold_sub=sub)
    ref, f2, ref_df, df2 = _reference(fields, paths, ip, beads, xnew, xold)
    r0, step = sub
    assert f2.tolist()[r0::step] == [True] * f2[r0::step].numel()
    assert int(f2.sum()) == f2[r0::step].numel()
    _close(dS, ref)
    _close(dfield, ref_df[:, r0::step])
    _close(pw._brute_rows(system, paths[:, lo:hi].flip(1), xnew, xold, ip,
                          beads, True), ref)


@pytest.mark.parametrize("kind", ["cm", "bis", "bis_tail", "worm_cm"])
def test_without_exact_f2_the_rows_are_the_partial_ones(setup, kind):
    port, fields, system, paths, gen = setup
    fields = {**fields, "exact_f2": False}
    D, L = paths.shape[-1], 4
    act = torch.rand(W, generator=gen) < 0.8
    u = torch.rand((W, 3), generator=gen, dtype=torch.float64)
    g = torch.randn((W, L, D), generator=gen, dtype=torch.float64)
    u_dx = torch.rand((W, 1, D), generator=gen, dtype=torch.float64)
    if kind == "cm":
        a = dict(ip=2, active=act, u_dx=u_dx, u_acc=u[:, 0])
    elif kind == "worm_cm":
        a = dict(ip=torch.randint(0, N, (W,), generator=gen), half=2,
                 active=act, u_dx=u_dx, u_acc=u[:, 0])
    else:
        a = dict(ip=4, active=act, level=2, rand=(2, g, u))
    xend = paths[:, NB, :2].clone()
    slots = ref_mv.move(fields, kind, paths, a, xend)
    geo, model = geometry(fields), PairModel(fields)
    for sl in slots:
        assert "dfield" not in sl and "f2" not in sl
        rows = _partial_rows(fields, geo, model, paths, sl["xnew"],
                             sl["xold"], sl["p"], sl["beads"])
        want = rows.sum(-1)[:, None] if sl["dS"].shape[1] == 1 and \
            sl["beads"].numel() > 1 else rows
        assert torch.equal(sl["dS"], want)


def _partial_rows(cfg, geo, model, R, xnew, xold, p, beads):
    """The reference's rows as they were before exact F^2: the moved
    particle's own |F|^2 change (a frozen copy)."""
    Rb = R[:, beads]
    n = Rb.shape[2]
    self_ = (torch.arange(n)[None, :] == p[:, None])[:, None, :]

    def side(x):
        dx = wrap(x[:, :, None, :] - Rb, geo.L)
        r2 = (dx * dx).sum(-1)
        m = (r2 <= geo.rcut2) & ~self_
        mf = m & (r2 > 0)
        r = torch.sqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
        zero = torch.zeros_like(r)
        pot = torch.where(m, model.v(r), zero).sum(-1)
        F = (torch.where(mf, model.dv(r) / r, zero)[..., None] * dx).sum(-2)
        return pot, (F * F).sum(-1), torch.where(mf, model.u(r), zero).sum(-1)

    pn, fn, un = side(xnew)
    po, fo, uo = side(xold)
    w = chin_weights(R.shape[1], cfg["dt"], R.dtype, R.device)[:, beads]
    return w[0] * (pn - po) + w[1] * (fn - fo) - w[2] * (un - uo)
