"""The monoshot bisection glue (ops/kernels.bis_propose, bis_accept;
csrc/bis_glue.cu).

On the CPU: the moves bisection, move_head_bisection and
move_tail_bisection, whose glue now runs behind the two wrappers, equal
the composition the moves ran before (the construction, the accepts and
the write-back as separate PyTorch operations, kept below as
`_old_interior` and `_old_end`) bit for bit, at D = 1, 2, 3, under PBC and
the trap, in float64 and float32, with inactive walkers; and so does each
plain form on its own.  With the exact-F^2 cache: bis_accept_ref with the
cache's arguments equals the cached moves' composition (the accepts, the
window's write-back, ops/moves._cache_win_write; the tail's in head
orientation) bit for bit and leaves a rejected walker's cache rows as they
were; and the cached moves on the glue route (forced on the CPU, so its
plain forms run) equal the same moves on their PyTorch glue bit for bit.

On the card (marked cuda, skipped without one): each kernel against its
plain form for the three kinds of move, both types, D = 1..4 under PBC,
inactive walkers and rows that sit exactly on a gate; two launches per
routed move; the trap's moves on the plain glue (the route asks for PBC);
one whole flagship step (the unfused, reference order of moves) with the
kernels on against the same step with the plain glue, from the same draws.
With the cache: the routed moves against the same moves on their PyTorch
glue (the fold kernel in both), three launches a routed move (bis_propose,
pair_fold, bis_accept), and no glue launch under bfloat16, the tables or
the trap.
The file imports no JAX, so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_bis_glue.py
"""

import pytest
import torch

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.moves import (_cache_win_write,
                                                     _codd_window,
                                                     _codd_window_rev, _where,
                                                     _win_write, bead_index)
from pathintegralgroundstate_torch.ops.pairwise import (delta_action_rows,
                                                        force_field)
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.pbc import wrap

torch.set_num_threads(1)

DENSITY = {1: 0.36, 2: 0.26, 3: 0.365, 4: 0.4}
KINDS = ("interior", "head", "tail")
W = 16


def _system(dim, trap, dtype, device="cpu", W=W, **over):
    cfg = flagship_cfg(W).replace(dim=dim, Np=8, density=DENSITY[dim],
                                  **over)
    if trap:
        # ideal bosons in the trap, as the port's trapped configurations
        cfg = cfg.replace(trap=True, a_ho=(1.0,) * dim, potential="none",
                          jastrow="none")
    return make_system(cfg, device, dtype)


def _inputs(system, seed, device="cpu"):
    """(paths, ip, active, (start, g, u)) of one move at depth Nlev: smooth
    worldlines on random sites, a third of the walkers inactive, u = 0
    (accept unless exp(-dS) is 0) for a quarter of them and u = 1 (accept
    only where every group's dS < 0) for another quarter."""
    cfg = system.cfg
    M, N, D, L = system.M, cfg.Np, cfg.dim, 2 ** cfg.Nlev
    gen = torch.Generator().manual_seed(seed)
    dt = system.dtype
    box = system.L.cpu() if system.pbc else torch.full((D,), 2.0, dtype=dt)
    site = torch.rand((W, 1, N, D), generator=gen, dtype=dt) - 0.5
    paths = site * box + 0.05 * torch.randn((W, M, N, D), generator=gen,
                                            dtype=dt)
    if system.pbc:
        paths = wrap(paths, system.L.cpu(), system.half.cpu())
    g = torch.randn((W, L, D), generator=gen, dtype=dt)
    u = torch.rand((W, cfg.Nlev + 1), generator=gen, dtype=dt)
    u[0::4] = 0.0
    u[1::4] = 1.0
    active = torch.rand(W, generator=gen) > 1 / 3
    mv = lambda t: t.to(device)  # noqa: E731
    return mv(paths), 3, mv(active), (10, mv(g), mv(u))


def _old_interior(system, paths, ip, active, level, rand):
    """The interior monoshot move as it ran before the glue wrappers."""
    L = 2 ** level
    ii, g_rows, u_acc = rand
    R_seg = paths[:, ii:ii + L + 1]
    seg0 = R_seg[:, :, ip]
    seg = bis._construct_levels(system, seg0, level, L, g_rows)
    rows = delta_action_rows(system, R_seg[:, 1:L], seg[:, 1:L],
                             seg0[:, 1:L], ip, bead_index(system, ii, 1, L),
                             need_wf=False)
    alive = bis._monoshot_accept(system, active, rows, u_acc[:, 1:], level,
                                 False)
    _win_write(paths, ii, ip, _where(alive, seg, seg0))
    return paths, alive, seg


def _old_end(system, paths, ip, active, nlev, tail, rand):
    """An end monoshot move as it ran before the glue wrappers; the new
    window in head orientation."""
    M, L = system.M, 2 ** nlev
    _, g_rows, u_acc = rand
    seg0, _, _ = bis._end_window(system, paths, ip, nlev, tail)
    xnew0 = bis._end_guess(system, seg0, nlev, g_rows[:, 0])
    seg = bis._construct_levels(system, torch.cat([xnew0[:, None],
                                                   seg0[:, 1:]], 1),
                                nlev, L, g_rows)
    if tail:
        rows = delta_action_rows(system, paths[:, M - L:], seg[:, :L].flip(1),
                                 seg0[:, :L].flip(1), ip,
                                 system.arange(M - L, M))
    else:
        rows = delta_action_rows(system, paths[:, :L], seg[:, :L],
                                 seg0[:, :L], ip, system.arange(L))
    alive = bis._monoshot_accept(system, active, rows, u_acc, nlev, True,
                                 flip=tail)
    bis._end_write(system, paths, ip, nlev, tail, _where(alive, seg, seg0))
    return paths, alive, seg


def _move(kind, system, paths, ip, active, rand, fodd=None):
    """(paths, alive) of the move function of `kind`; fodd: the exact-F^2
    cache."""
    nlev = system.cfg.Nlev
    if kind == "interior":
        return bis.bisection(system, paths, ip, active, nlev, rand,
                             fodd=fodd)
    fn = bis.move_head_bisection if kind == "head" \
        else bis.move_tail_bisection
    return fn(system, paths, ip, active, nlev, rand, fodd=fodd)


def _window(kind, system):
    """(bead0, step, gate) of kind's window at depth Nlev, start 10."""
    return {"interior": (10, 1, False), "head": (0, 1, True),
            "tail": (system.M - 1, -1, True)}[kind]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("trap", [False, True], ids=["pbc", "trap"])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_moves_equal_the_old_composition_bitwise(kind, dim, trap, dtype):
    system = _system(dim, trap, dtype)
    paths, ip, active, rand = _inputs(system, seed=100 * dim + trap)
    nlev = system.cfg.Nlev
    old = paths.clone()
    if kind == "interior":
        old, acc_old, seg_old = _old_interior(system, old, ip, active, nlev,
                                              rand)
    else:
        old, acc_old, seg_old = _old_end(system, old, ip, active, nlev,
                                         kind == "tail", rand)
        if kind == "tail":
            seg_old = seg_old.flip(1)
    bead0, step, gate = _window(kind, system)
    seg = kernels.bis_propose(system, paths, ip, nlev, rand[1], bead0, step,
                              gate)
    assert torch.equal(seg, seg_old)
    n = kernels.bis_propose.launches, kernels.bis_accept.launches
    new, acc = _move(kind, system, paths, ip, active, rand)
    assert torch.equal(acc, acc_old) and torch.equal(new, old)
    assert 0 < int(acc.sum()) < int(active.sum()), "both outcomes exercised"
    assert (kernels.bis_propose.launches,
            kernels.bis_accept.launches) == n


@pytest.mark.parametrize("kind", KINDS)
def test_plain_accept_writes_only_the_accepted_windows(kind):
    """bis_accept_ref leaves a rejected or inactive walker's paths as they
    were and puts an accepted walker's displaced rows where its window
    lies (the tail's reversed)."""
    system = _system(3, False, torch.float64)
    paths, ip, active, rand = _inputs(system, seed=5)
    nlev, L, M = system.cfg.Nlev, 2 ** system.cfg.Nlev, system.M
    bead0, step, gate = _window(kind, system)
    seg = kernels.bis_propose_ref(system, paths, ip, nlev, rand[1], bead0,
                                  step, gate)
    lo = bead0 if step > 0 else bead0 - L
    B = L if gate else L - 1
    rows = torch.zeros((W, B), dtype=torch.float64)
    before = paths.clone()
    alive = kernels.bis_accept_ref(system, paths, ip, nlev, rows,
                                   torch.zeros_like(rand[2]), active, seg,
                                   bead0, step, gate)
    # rows of 0 and u = 0: every active walker passes
    assert torch.equal(alive, active)
    win = paths[:, lo:lo + L + 1, ip]
    assert torch.equal(win[alive], seg[alive])
    assert torch.equal(win[~alive], before[:, lo:lo + L + 1, ip][~alive])
    rest = torch.ones_like(paths, dtype=torch.bool)
    rest[:, lo:lo + L + 1, ip] = False
    assert torch.equal(paths[rest], before[rest])
    # the anchors never move: the window's far end, and the interior's
    # first bead
    assert torch.equal(paths[:, bead0 + step * L], before[:, bead0 + step * L])
    if not gate:
        assert torch.equal(paths[:, bead0], before[:, bead0])


# ---------------------------------------------------------------------------
# The exact-F^2 cache on the glue route
# ---------------------------------------------------------------------------

EXACT = dict(exact_f2=True, f2_cache=True)


def _cache(system, paths, seed):
    """A cache [W, Nb, N, D] of the odd beads' field, plus noise of its
    own size, so that no increment is lost against it."""
    f = force_field(system, paths[:, 1::2])
    gen = torch.Generator().manual_seed(seed)
    noise = torch.randn(f.shape, generator=gen, dtype=torch.float64)
    return f + (f.abs() + 1.0) * noise.to(f.device, f.dtype)


def _accept_case(kind, system, seed):
    """The arguments of one cached accept in the orientation of the cached
    moves' PyTorch glue (the tail's window, rows and increments in head
    orientation, its cache rows _codd_window_rev's reversed copy), with
    rows of multiples of 1/8 (their group sums exact in any order) and
    increments dfield of the cache's size: (paths, codd, ip, active, u,
    seg, rows, dfield, (f_seg, k0))."""
    paths, ip, active, (ii, g, u) = _inputs(system, seed)
    codd = _cache(system, paths, seed)
    nlev, L, M = system.cfg.Nlev, 2 ** system.cfg.Nlev, system.M
    N, D = system.cfg.Np, system.cfg.dim
    if kind == "interior":
        seg = bis._construct_levels(system, paths[:, ii:ii + L + 1, ip],
                                    nlev, L, g)
        f_seg, _, k0 = _codd_window(codd, ii, L, 0)
        B = L - 1
    else:
        seg0, _, _ = bis._end_window(system, paths, ip, nlev, kind == "tail")
        seg = bis._end_proposal(system, seg0, nlev, g)
        f_seg, k0 = bis._end_cache(system, codd, nlev, kind == "tail")
        B = L
    gen = torch.Generator().manual_seed(seed + 1)
    rows = (torch.randint(-4, 5, (W, B), generator=gen) / 8).double()
    dfield = torch.randn((W, L // 2, N, D), generator=gen,
                         dtype=torch.float64) * (codd.abs().amax() + 1.0)
    return paths, codd, ip, active, u, seg, rows, dfield, (f_seg, k0)


@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_accept_with_the_cache_equals_the_composition(kind, dim):
    """bis_accept_ref with the cache (codd, dfield, k0) equals, bit for
    bit in float64, the cached moves' composition: _monoshot_accept, the
    window's write-back (_where, _win_write / _end_write), then
    _cache_win_write; the tail handed its window, rows and increments in
    forward bead order and its cache rows as the forward view at row
    (M-L)/2, the composition taking them in head orientation."""
    system = _system(dim, False, torch.float64, **EXACT)
    paths, codd, ip, active, u, seg, rows, dfield, (f_seg, k0) = \
        _accept_case(kind, system, seed=20 + dim)
    nlev, L, M = system.cfg.Nlev, 2 ** system.cfg.Nlev, system.M
    old_p, old_c = paths.clone(), codd.clone()
    if kind == "interior":
        seg0 = old_p[:, 10:10 + L + 1, ip]
        acc_old = bis._monoshot_accept(system, active, rows, u[:, 1:], nlev,
                                       False)
        _win_write(old_p, 10, ip, _where(acc_old, seg, seg0))
        f_old, _, k_old = _codd_window(old_c, 10, L, 0)
    else:
        tail = kind == "tail"
        seg0, _, _ = bis._end_window(system, old_p, ip, nlev, tail)
        acc_old = bis._monoshot_accept(system, active, rows, u, nlev, True)
        bis._end_write(system, old_p, ip, nlev, tail,
                       _where(acc_old, seg, seg0))
        f_old, k_old = bis._end_cache(system, old_c, nlev, tail)
    _cache_win_write(old_c, f_old, dfield, acc_old, k_old,
                     reverse=kind == "tail")
    bead0, step, gate = _window(kind, system)
    if kind == "tail":
        # forward bead order: window row r at bead M-1-L+r, the rows and
        # the increments at beads M-L.., the cache rows a forward view
        seg, rows, dfield = seg.flip(1), rows.flip(1), dfield.flip(1)
        _, sub, k0 = _codd_window(codd, M - L, L)
        assert sub == (0, 2) and k0 == (M - L) // 2 == k_old
    alive = kernels.bis_accept_ref(system, paths, ip, nlev, rows, u, active,
                                   seg.contiguous(), bead0, step, gate, codd,
                                   dfield.contiguous(), k0)
    assert torch.equal(alive, acc_old)
    assert 0 < int(alive.sum()) < int(active.sum()), "both outcomes exercised"
    assert torch.equal(paths, old_p) and torch.equal(codd, old_c)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_accept_leaves_rejected_cache_rows(kind):
    """bis_accept_ref with the cache leaves a rejected or inactive
    walker's cache rows bit for bit as they were, and every row outside
    the window's for every walker; an accepted walker's window rows are the
    old rows plus its increments."""
    system = _system(3, False, torch.float64, **EXACT)
    paths, codd, ip, active, u, seg, rows, dfield, _ = \
        _accept_case(kind, system, seed=40)
    nlev, L, M = system.cfg.Nlev, 2 ** system.cfg.Nlev, system.M
    bead0, step, gate = _window(kind, system)
    k0 = {"interior": 5, "head": 0, "tail": (M - L) // 2}[kind]
    before = codd.clone()
    alive = kernels.bis_accept_ref(system, paths, ip, nlev, rows, u, active,
                                   seg, bead0, step, gate, codd, dfield, k0)
    assert 0 < int(alive.sum()) < int(active.sum()), "both outcomes exercised"
    rej = ~alive
    assert torch.equal(codd[rej].view(torch.int64),
                       before[rej].view(torch.int64))
    win = slice(k0, k0 + L // 2)
    outside = torch.ones(codd.shape[1], dtype=torch.bool)
    outside[win] = False
    assert torch.equal(codd[:, outside], before[:, outside])
    assert torch.equal(codd[alive, win], before[alive, win] + dfield[alive])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_cached_moves_on_the_route_equal_their_pytorch_glue(kind, dim, dtype,
                                                           monkeypatch):
    """The cached moves with the glue route forced on the CPU (the glue
    wrappers and the fold through their plain forms; the tail's window,
    rows and cache rows in forward bead order) equal the same moves on the
    cached moves' PyTorch glue (the tail in head orientation) bit for bit:
    decisions, paths and cache; each routed move calls each glue wrapper
    once."""
    system = _system(dim, False, dtype, **EXACT)
    paths, ip, active, rand = _inputs(system, seed=60 + dim)
    codd = _cache(system, paths, seed=60 + dim)
    ref_p, ref_c = paths.clone(), codd.clone()
    _, acc_ref = _move(kind, system, ref_p, ip, active, rand, ref_c)
    calls = []
    for name in ("bis_propose", "bis_accept"):
        fn = getattr(kernels, name)
        monkeypatch.setattr(kernels, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    monkeypatch.setattr(bis, "_glue_cache", lambda s, p: True)
    _, acc = _move(kind, system, paths, ip, active, rand, codd)
    assert calls == ["bis_propose", "bis_accept"]
    assert torch.equal(acc, acc_ref)
    assert 0 < int(acc.sum()) < int(active.sum()), "both outcomes exercised"
    assert torch.equal(paths, ref_p) and torch.equal(codd, ref_c)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(a, b, system, what):
    """a == b within the type's rounding, positions compared through the
    minimum image (a coordinate at the box's edge may wrap either way)."""
    d = a - b
    if system.pbc:
        d = wrap(d, system.L, system.half)
    tol = 1e-12 if a.dtype == torch.float64 else 2e-5
    assert float(d.abs().max()) <= tol, what


def _close_rel(a, b, what):
    """a == b within _close's tolerance relative to b's size (at least 1):
    the cache's fields reach far beyond the box."""
    tol = 1e-12 if a.dtype == torch.float64 else 2e-5
    d = (a - b).abs() / b.abs().clamp(min=1.0)
    assert float(d.max()) <= tol, what


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_glue_kernels_match_plain(cuda, kind, dim, dtype):
    system = _system(dim, False, dtype, cuda)
    assert kernels.bis_route(system)
    paths, ip, active, (_, g, u) = _inputs(system, seed=7 * dim, device=cuda)
    nlev, L = system.cfg.Nlev, 2 ** system.cfg.Nlev
    bead0, step, gate = _window(kind, system)
    n = kernels.bis_propose.launches, kernels.bis_accept.launches
    seg = kernels.bis_propose(system, paths, ip, nlev, g, bead0, step, gate)
    ref = kernels.bis_propose_ref(system, paths, ip, nlev, g, bead0, step,
                                  gate)
    _close(seg, ref, system, "proposal")
    # rows that sit exactly on a gate: sums exact in either order, and u
    # = exp(-sum) (rejected, u < exp(-dS) being strict) on some walkers,
    # one ulp below (accepted) on others
    B = L if gate else L - 1
    gen = torch.Generator().manual_seed(dim)
    rows = (torch.randint(-4, 5, (W, B), generator=gen) / 8).to(cuda, dtype)
    A = torch.as_tensor(bis._level_assign(nlev, gate)[::-1].copy()
                        if step < 0 else bis._level_assign(nlev, gate),
                        dtype=dtype, device=cuda)
    sums = rows @ A
    edge = torch.exp(-sums)
    u = u.clone()
    cols = slice(0, nlev + 1) if gate else slice(1, nlev + 1)
    u[0::4, cols] = edge[0::4]
    u[1::4, cols] = torch.nextafter(edge[1::4], torch.zeros_like(edge[1::4]))
    p_ref = paths.clone()
    alive = kernels.bis_accept(system, paths, ip, nlev, rows, u, active, seg,
                               bead0, step, gate)
    acc_ref = kernels.bis_accept_ref(system, p_ref, ip, nlev, rows, u,
                                     active, seg, bead0, step, gate)
    assert torch.equal(alive, acc_ref)
    assert not alive[0::4].any() and torch.equal(alive[1::4], active[1::4])
    assert torch.equal(paths, p_ref)
    assert (kernels.bis_propose.launches - n[0],
            kernels.bis_accept.launches - n[1]) == (1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_routed_move_is_two_glue_launches(cuda, kind, monkeypatch):
    """A routed move on the card launches each glue kernel once and kernel
    A once, and equals the same move through the plain glue (float64)."""
    system = _system(3, False, torch.float64, cuda)
    assert kernels.bis_route(system)
    paths, ip, active, rand = _inputs(system, seed=3, device=cuda)
    ref = paths.clone()
    n = (kernels.bis_propose.launches, kernels.bis_accept.launches,
         kernels.pair_rows.launches)
    _, acc = _move(kind, system, paths, ip, active, rand)
    assert (kernels.bis_propose.launches - n[0],
            kernels.bis_accept.launches - n[1],
            kernels.pair_rows.launches - n[2]) == (1, 1, 1)
    monkeypatch.setattr(kernels, "bis_route", lambda s: False)
    _, acc_ref = _move(kind, system, ref, ip, active, rand)
    assert torch.equal(acc, acc_ref)
    _close(paths, ref, system, "paths")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_trap_moves_take_the_plain_glue_on_the_card(cuda, kind):
    """The trap (no PBC) is off bis_route: its moves on the card launch no
    glue kernel and equal the same moves on the CPU (float64)."""
    system = _system(2, True, torch.float64, cuda)
    assert not kernels.bis_route(system)
    paths, ip, active, rand = _inputs(system, seed=4, device=cuda)
    n = kernels.bis_propose.launches, kernels.bis_accept.launches
    _, acc = _move(kind, system, paths, ip, active, rand)
    assert (kernels.bis_propose.launches,
            kernels.bis_accept.launches) == n
    cpu = _system(2, True, torch.float64)
    p_cpu, _, a_cpu, r_cpu = _inputs(cpu, seed=4)
    _, acc_cpu = _move(kind, cpu, p_cpu, ip, a_cpu, r_cpu)
    assert torch.equal(acc.cpu(), acc_cpu)
    assert float((paths.cpu() - p_cpu).abs().max()) <= 1e-12


@pytest.mark.cuda
def test_glue_refuses_what_it_cannot_take(cuda):
    system = _system(3, False, torch.float64, cuda)
    paths, ip, active, (_, g, u) = _inputs(system, seed=9, device=cuda)
    nlev, M = system.cfg.Nlev, system.M
    n = kernels.bis_propose.launches
    for bad_g, bead0, bad_ip in ((g.float(), 10, ip), (g[:, :-1], 10, ip),
                                 (g.transpose(0, 1).contiguous()
                                  .transpose(0, 1), 10, ip),
                                 (g, M - 8, ip), (g, 10, 99)):
        with pytest.raises(ValueError):
            kernels.bis_propose(system, paths, bad_ip, nlev, bad_g, bead0, 1,
                                False)
    assert kernels.bis_propose.launches == n
    seg = kernels.bis_propose(system, paths, ip, nlev, g, 10, 1, False)
    rows = torch.zeros((W, 2 ** nlev - 1), dtype=paths.dtype, device=cuda)
    n = kernels.bis_accept.launches
    for bad in ((rows[:, :-1], u, active, seg), (rows, u.float(), active, seg),
                (rows, u, active.int(), seg), (rows, u, active, seg[:, :-1])):
        with pytest.raises(ValueError):
            kernels.bis_accept(system, paths, ip, nlev, *bad, 10, 1, False)
    for bead0, bad_ip in ((M - 8, ip), (10, 99)):
        with pytest.raises(ValueError):
            kernels.bis_accept(system, paths, bad_ip, nlev, rows, u, active,
                               seg, bead0, 1, False)
    # the cache: its particles, a strided dfield, rows past its end
    codd = _cache(system, paths, 9)
    mo = 2 ** nlev // 2
    df = torch.zeros((W, mo) + codd.shape[2:], dtype=paths.dtype,
                     device=cuda)
    for bad_c, bad_df, k0 in ((codd[:, :, :-1], df[:, :, :-1], 5),
                              (codd, df.transpose(0, 1).contiguous()
                               .transpose(0, 1), 5),
                              (codd, df, codd.shape[1] - mo + 1),
                              (codd, df.float(), 5)):
        with pytest.raises(ValueError):
            kernels.bis_accept(system, paths, ip, nlev, rows, u, active, seg,
                               10, 1, False, bad_c, bad_df, k0)
    assert kernels.bis_accept.launches == n


@pytest.mark.cuda
def test_flagship_step_glue_kernels_match_plain_glue(cuda, monkeypatch):
    """One whole flagship step in the unfused (reference) order of moves
    on the card, the glue kernels on, against the same step with the plain
    glue from the same draws (float64, W=64): positions within 1e-12
    through the minimum image, every counter and decision equal; two glue
    launches per move (a head, a tail and an interior move per particle
    visit)."""
    import torch_card
    from pathintegralgroundstate_torch.state import (init_state,
                                                     state_from_numpy,
                                                     state_to_numpy)
    from pathintegralgroundstate_torch.sweep import (Sweeper, stats_to_numpy,
                                                     zero_stats)
    cfg = flagship_cfg(64).replace(dtype="float64", Nstag=1, Nobdm=2)
    system = make_system(cfg, cuda)
    sweeper = Sweeper(system)
    state = init_state(system)
    start = state_to_numpy(state)
    rec = torch_card._Recorder(sweeper.draws(state))
    n = kernels.bis_propose.launches, kernels.bis_accept.launches
    s1, t1 = sweeper.step(state, zero_stats(system), rec)
    visits = cfg.Nstag * cfg.Np
    assert (kernels.bis_propose.launches - n[0],
            kernels.bis_accept.launches - n[1]) == (3 * visits, 3 * visits)
    monkeypatch.setattr(kernels, "bis_route", lambda s: False)
    m = kernels.bis_propose.launches
    s2, t2 = sweeper.step(state_from_numpy(system, start), zero_stats(system),
                          torch_card._Replayer(rec.log, cuda))
    assert kernels.bis_propose.launches == m
    _close(s1.paths, s2.paths, system, "paths")
    a, b = stats_to_numpy(t1), stats_to_numpy(t2)
    assert (a["counters"] == b["counters"]).all()
    for k in ("isopen", "iworm", "iperm"):
        assert torch.equal(getattr(s1, k), getattr(s2, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [1, 2, 3])
@pytest.mark.parametrize("kind", KINDS)
def test_cached_moves_on_the_route_match_their_pytorch_glue(
        cuda, kind, dim, dtype, monkeypatch):
    """With the exact-F^2 cache on the card: the moves on the glue route
    (bis_propose, the fold kernel, bis_accept writing the cache back)
    against the same moves on their PyTorch glue (the fold kernel there
    too), from the same inputs: decisions equal, both outcomes exercised,
    the paths through the minimum image and the cache relative to its size
    within test_glue_kernels_match_plain's tolerances."""
    system = _system(dim, False, dtype, cuda, **EXACT)
    paths, ip, active, rand = _inputs(system, seed=80 + dim, device=cuda)
    assert bis._glue_cache(system, paths)
    codd = _cache(system, paths, seed=80 + dim)
    ref_p, ref_c = paths.clone(), codd.clone()
    n = kernels.bis_accept.launches
    _, acc = _move(kind, system, paths, ip, active, rand, codd)
    assert kernels.bis_accept.launches == n + 1
    monkeypatch.setattr(bis, "_glue_cache", lambda s, p: False)
    _, acc_ref = _move(kind, system, ref_p, ip, active, rand, ref_c)
    assert kernels.bis_accept.launches == n + 1
    assert torch.equal(acc, acc_ref)
    assert 0 < int(acc.sum()) < int(active.sum()), "both outcomes exercised"
    _close(paths, ref_p, system, "paths")
    _close_rel(codd, ref_c, "cache")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_routed_cached_move_is_three_launches(cuda, kind):
    """A cached move on the glue route is one bis_propose, one pair_fold
    and one bis_accept launch, and no kernel-A launch (float64, D = 3)."""
    system = _system(3, False, torch.float64, cuda, **EXACT)
    paths, ip, active, rand = _inputs(system, seed=3, device=cuda)
    codd = _cache(system, paths, 3)
    fns = (kernels.bis_propose, kernels.pair_fold, kernels.bis_accept,
           kernels.pair_rows)
    n = [fn.launches for fn in fns]
    _move(kind, system, paths, ip, active, rand, codd)
    assert [fn.launches - k for fn, k in zip(fns, n)] == [1, 1, 1, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bfloat16", "tables", "trap"])
def test_cached_moves_off_the_route_launch_no_glue(cuda, case):
    """bfloat16 (off bis_route and fold_route), the tables and the trap
    (off fold_route) keep the cached moves' PyTorch glue on the card: no
    glue kernel launches over a head, a tail and an interior move."""
    system = {
        "bfloat16": lambda: _system(3, False, torch.bfloat16, cuda, **EXACT),
        "tables": lambda: _system(3, False, torch.float64, cuda,
                                  v_table=True, wf_table=True, **EXACT),
        "trap": lambda: _system(2, True, torch.float64, cuda, **EXACT)}[case]()
    paths, ip, active, rand = _inputs(system, seed=6, device=cuda)
    assert not bis._glue_cache(system, paths)
    codd = _cache(system, paths, 6)
    n = kernels.bis_propose.launches, kernels.bis_accept.launches
    for kind in KINDS:
        _move(kind, system, paths, ip, active, rand, codd)
    assert (kernels.bis_propose.launches,
            kernels.bis_accept.launches) == n
