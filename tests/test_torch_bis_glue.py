"""The monoshot bisection glue (ops/kernels.bis_propose, bis_accept;
csrc/bis_glue.cu).

On the CPU: the moves bisection, move_head_bisection and
move_tail_bisection, whose glue now runs behind the two wrappers, equal
the composition the moves ran before (the construction, the accepts and
the write-back as separate PyTorch operations, kept below as
`_old_interior` and `_old_end`) bit for bit, at D = 1, 2, 3, under PBC and
the trap, in float64 and float32, with inactive walkers; and so does each
plain form on its own.

On the card (marked cuda, skipped without one): each kernel against its
plain form for the three kinds of move, both types, D = 1..4 under PBC,
inactive walkers and rows that sit exactly on a gate; two launches per
routed move; the trap's moves on the plain glue (the route asks for PBC);
one whole flagship step (the unfused, reference order of moves) with the
kernels on against the same step with the plain glue, from the same draws.
The file imports no JAX, so on a machine with a card it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_bis_glue.py
"""

import pytest
import torch

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.moves import (_where, _win_write,
                                                     bead_index)
from pathintegralgroundstate_torch.ops.pairwise import delta_action_rows
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.pbc import wrap

torch.set_num_threads(1)

DENSITY = {1: 0.36, 2: 0.26, 3: 0.365, 4: 0.4}
KINDS = ("interior", "head", "tail")
W = 16


def _system(dim, trap, dtype, device="cpu", W=W):
    cfg = flagship_cfg(W).replace(dim=dim, Np=8, density=DENSITY[dim])
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


def _move(kind, system, paths, ip, active, rand):
    """(paths, alive) of the move function of `kind`."""
    nlev = system.cfg.Nlev
    if kind == "interior":
        return bis.bisection(system, paths, ip, active, nlev, rand)
    fn = bis.move_head_bisection if kind == "head" \
        else bis.move_tail_bisection
    return fn(system, paths, ip, active, nlev, rand)


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
