"""The hand-written kernels on a CUDA device: each against its plain
PyTorch form (in 3-D and at D = 1, 2, 4 and 5; every potential and
Jastrow; bfloat16 by utils/bf16's bound; the exact-F^2 brute windows and
composed forms), and whole steps on the card (the flagship, the fused
sweep with cascade off and on, the reference-order step, the staging
sampler with the scan, the fused sweep in per-level form, a 2-D film, the
trap) against the same steps on the CPU from the same draws; the trap
launches no kernel.  The helpers and their tolerances are
tests/torch_card.py's.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch
import torch_card

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import kernels
from pathintegralgroundstate_torch.ops.pairwise import chin_table
from pathintegralgroundstate_torch.system import make_system

pytestmark = pytest.mark.cuda

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _window(cfg, ip_form, W, seed, coincident=True):
    """(R, xnew, xold, ip) on the CPU, float64: liquid-like worldlines,
    with coincident: one row with an exactly coincident partner."""
    paths = torch_card._flagship_paths(cfg, W, torch.float64, "cpu", seed)
    g = torch.Generator().manual_seed(seed)
    N, B = cfg.Np, cfg.M
    if ip_form == "scalar":
        ip, xold, p1 = 3, paths[:, :, 3], 3
    elif ip_form == "walker":
        ip = torch.randint(0, N, (W,), generator=g)
        xold, p1 = paths[torch.arange(W), :, ip], int(ip[1])
    else:
        ip = torch.randint(0, N, (W, B), generator=g)
        xold = paths.gather(2, ip[:, :, None, None].expand(W, B, 1, 3))[:, :,
                                                                        0]
        p1 = int(ip[1, 2])
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g,
                                     dtype=torch.float64)
    if coincident:
        xnew[1, 2] = paths[1, 2, (p1 + 1) % N]
    return paths, xnew, xold, ip


@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_pair_rows_matches_plain(cuda, ip_form):
    """The weighted rows and the walker sums (with the worm centre's row
    weight 1/2), forward and reversed, ib [B] and [W, B].  float64: only
    the summation order differs (rtol 1e-11; atol 1e-9, as the force
    terms' 1e-7 weighted by 2 dt^3 / 9)."""
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R, xnew, xold, ip = _window(cfg, ip_form, 64, seed=13)
    R, xn, xo = R.to(cuda), xnew.to(cuda), xold.to(cuda)
    ip = ip if isinstance(ip, int) else ip.to(cuda)
    tab, M = chin_table(system), cfg.M
    rw = torch.ones(M, dtype=torch.float64, device=cuda)
    rw[0] = 0.5
    ibs = (torch.arange(M, device=cuda),
           torch.randint(0, M, (64, M), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(13)))
    n = kernels.pair_rows.launches
    for rev in (False, True):
        for ib in ibs:
            for need_wf, need_f2 in ((True, True), (False, False)):
                for kw in ({}, {"row_weights": rw, "reduce": True}):
                    args = (system, R, xn, xo, ip, tab, ib, need_wf,
                            need_f2, rev)
                    torch.testing.assert_close(
                        kernels.pair_rows(*args, **kw),
                        kernels.pair_rows_ref(*args, **kw), rtol=1e-11,
                        atol=1e-9)
    assert kernels.pair_rows.launches == n + 16


@pytest.mark.parametrize("B", [1, 65])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes", kernels.ROWS_LANES)
def test_pair_rows_lanes_match_plain(cuda, lanes, dtype, B):
    """Kernel A at one lane-group width, the B=1 end gate and the B=65
    whole chain at the walker count where the wrapper's rule picks that
    width (torch_card.lanes_walkers), ip scalar and [1, B], rows and walker
    sums, against the float64 plain form (torch_card.rows_parity: float64
    within the terms' tolerances, float32 within
    tests/test_pallas_kernel.py's plus twice the plain float32 form's own
    error)."""
    cfg = flagship_cfg(128)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    W = torch_card.lanes_walkers(lanes, B)
    paths = torch_card._flagship_paths(cfg, 128, dtype, cuda, seed=41)
    g = torch.Generator(device=cuda).manual_seed(41)
    R = paths[:, cfg.M - B:].repeat(-(-W // 128), 1, 1, 1)[:W]
    ib = torch.arange(cfg.M - B, cfg.M, device=cuda)
    for ip in (7, torch.randint(0, 64, (1, B), generator=g, device=cuda)):
        xnew, xold = torch_card._window_ip(R, ip, g)
        for reduce in (False, True):
            torch_card.rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                   B > 1, [(True, True), (False, False)],
                                   f"B={B}", reduce=reduce)


def test_layouts_without_16_byte_rows_match_plain(cuda):
    """Kernels A and 5 at N=30 in float32 and N=31 in float64, where a row
    of partners is no multiple of 16 bytes and both kernels stage it
    element by element (torch_card.layout_parity)."""
    torch_card.layout_parity(flagship_cfg(256))


def test_pair_rows_unaligned_and_strided_windows_match_plain(cuda):
    """Kernel A on a window whose start is 8 bytes past 16-byte alignment
    and on one whose particle axis is strided (partners staged element by
    element), float64, rows and walker sums."""
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R, xnew, xold, ip = _window(cfg, "row", 64, seed=43)
    n = R.numel()
    flat = torch.zeros(n + 1, dtype=torch.float64, device=cuda)
    flat[1:] = R.flatten().to(cuda)
    wide = torch.zeros(64, 65, 128, 3, dtype=torch.float64, device=cuda)
    wide[:, :, ::2] = R.to(cuda)
    args = (xnew.to(cuda), xold.to(cuda), ip.to(cuda), chin_table(system),
            torch.arange(cfg.M, device=cuda))
    for Rv in (flat[1:].view(R.shape), wide[:, :, ::2]):
        assert not kernels.slabs16(Rv)
        for kw in ({}, {"reduce": True}):
            torch.testing.assert_close(
                kernels.pair_rows(system, Rv, *args, **kw),
                kernels.pair_rows_ref(system, Rv, *args, **kw), rtol=1e-11,
                atol=1e-9)


def test_pair_rows_span_matches_plain(cuda):
    """The fused interior span of bisection_multi: K=3 slots of L=16 links
    read in place as one window of B=47 rows, ip [1, B] per window row; the
    unmoved slot-boundary rows give exactly 0."""
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R = _window(cfg, "scalar", 64, seed=19)[0].to(cuda)[:, 3:50]
    ip = torch.cat([torch.full((16,), p, dtype=torch.long, device=cuda)
                    for p in (7, 30, 61)])[None, 1:]
    xold = R.gather(2, ip[:, :, None, None].expand(64, 47, 1, 3))[:, :, 0]
    g = torch.Generator(device=cuda).manual_seed(19)
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g, device=cuda,
                                     dtype=torch.float64)
    xnew[:, 15::16] = xold[:, 15::16]
    args = (system, R, xnew, xold, ip, chin_table(system),
            torch.arange(4, 51, device=cuda), False, True)
    got = kernels.pair_rows(*args)
    torch.testing.assert_close(got, kernels.pair_rows_ref(*args),
                               rtol=1e-11, atol=1e-9)
    assert not bool(got[:, 15::16].any())


@pytest.mark.parametrize("with_force", [False, True])
def test_pair_pot_matches_plain(cuda, with_force):
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R = _window(cfg, "scalar", 64, seed=17)[0].to(cuda)[:, 1::2]
    for g, r in zip(kernels.pair_pot(system, R, with_force),
                    kernels.pair_pot_ref(system, R, with_force)):
        torch.testing.assert_close(g, r, rtol=1e-11, atol=1e-7)


def _pot_paths(Np, W, dtype, cuda, seed, dmin=0.7):
    """(system, float64 system, paths) of N=Np liquid-like worldlines with
    pairs down to dmin (closer than the flagship's 0.95, so that even N=2
    has pairs inside the cutoff)."""
    cfg = flagship_cfg(W).replace(Np=Np)
    return (make_system(cfg, cuda, dtype), make_system(cfg, cuda,
                                                       torch.float64),
            torch_card._flagship_paths(cfg, W, dtype, cuda, seed, dmin))


@pytest.mark.parametrize("Np,dtype,W", [
    (2, torch.float64, 64), (30, torch.float32, 64), (31, torch.float64, 64),
    (64, torch.float32, 64), (65, torch.float64, 64),
    (1024, torch.float64, 1)])
def test_pair_pot_particle_counts_match_plain(cuda, Np, dtype, W):
    """Kernel B without and with force on both ThermEnergy views, from one
    chunk of 32 particles (N=2, 30, 31) to 32 (N=1024: rows of 1024
    threads, 49.7 KB of shared memory in float64, past the 48 KB default),
    rows that are 16-byte slabs or not: float64 within rtol 1e-11, atol
    1e-9 (1e-7 on f2); float32 within torch_card._close's rule."""
    system, sys64, paths = _pot_paths(Np, W, dtype, cuda, seed=Np)
    M = system.M
    for sl in (slice(0, M - 1, 2), slice(1, M - 1, 2)):
        torch_card.pot_check(system, sys64, paths[:, sl], f"N={Np}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_pot_views_match_plain(cuda, dtype):
    """Both ThermEnergy views read in place (16-byte slabs at N=64), and
    the odd view of a copy that starts one element past 16-byte alignment
    (staged element by element)."""
    system, sys64, paths = _pot_paths(64, 64, dtype, cuda, seed=67)
    M = system.M
    flat = torch.empty(paths.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = paths.flatten()
    views = (paths[:, 0:M - 1:2], paths[:, 1:M - 1:2],
             flat[1:].view(paths.shape)[:, 1:M - 1:2])
    assert [kernels.slabs16(R) for R in views] == [True, True, False]
    n = kernels.pair_pot.launches
    for R in views:
        torch_card.pot_check(system, sys64, R, "view")
    assert kernels.pair_pot.launches == n + 6


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_pot_coincident_pair_gives_nonfinite_f2(cuda, dtype):
    """Two exactly coincident particles: no r^2 > 0 guard, so f2 of that
    row is non-finite from the kernel and the plain form alike, its pot
    finite; every other row agrees."""
    system, _, paths = _pot_paths(64, 16, dtype, cuda, seed=71)
    R = paths[:, 1:system.M - 1:2].clone()
    R[3, 5, 7] = R[3, 5, 40]
    got = kernels.pair_pot(system, R, True)
    ref = kernels.pair_pot_ref(system, R, True)
    for f2 in (got[1], ref[1]):
        assert not bool(torch.isfinite(f2[3, 5]))
        assert int(torch.isfinite(f2).sum()) == f2.numel() - 1
    assert bool(torch.isfinite(got[0]).all())
    if dtype == torch.float64:
        torch.testing.assert_close(got[0], ref[0], rtol=1e-11, atol=1e-9)
        keep = torch.isfinite(ref[1])
        torch.testing.assert_close(got[1][keep], ref[1][keep], rtol=1e-11,
                                   atol=1e-7)


@pytest.mark.parametrize("with_force", [False, True])
def test_pair_pot_two_launches_bitwise_equal(cuda, with_force):
    """Each unordered pair once, the reactions and the row sums added in a
    fixed order: two launches on the same input give the same bits."""
    system, _, paths = _pot_paths(64, 256, torch.float32, cuda, seed=73)
    R = paths[:, int(with_force):system.M - 1:2]
    a = kernels.pair_pot(system, R, with_force)
    b = kernels.pair_pot(system, R, with_force)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert with_force or not bool(a[1].any())


def test_pair_rows_refuses_what_it_cannot_read(cuda):
    """Wrong layouts, types, index and weight tables and rows beyond the
    shared memory all raise; none launches."""
    system = make_system(flagship_cfg(4), cuda, torch.float64)
    R = torch.zeros(4, 5, 64, 3, dtype=torch.float64, device=cuda)
    x = torch.zeros(4, 5, 3, dtype=torch.float64, device=cuda)
    tab, ib = chin_table(system), torch.arange(5, device=cuda)
    huge = torch.zeros(1, 1, 10_000, 3, dtype=torch.float64, device=cuda)
    xh = torch.zeros(1, 1, 3, dtype=torch.float64, device=cuda)
    n = kernels.pair_rows.launches
    for bad in ((R.transpose(2, 3), x, x, 0, tab, ib),
                (R, x.float(), x, 0, tab, ib),
                (R, x, x, 0, tab, ib.int()),
                (R, x, x, 0, tab[:2], ib),
                (R, x, x, 0, tab, ib[:4]),
                (huge, xh, xh, 0, tab, ib[:1])):
        with pytest.raises(ValueError):
            kernels.pair_rows(system, *bad)
    assert kernels.pair_rows.launches == n


def _dense_case(cuda, ip_form, seed):
    """Kernels 3 and 4's inputs on the card, no coincident partner: the
    dense forms have no r^2 > 0 guard (as the reference)."""
    cfg = flagship_cfg(64)
    R, xnew, xold, ip = _window(cfg, ip_form, 64, seed, coincident=False)
    ip = ip if isinstance(ip, int) else ip.to(cuda)
    return (make_system(cfg, cuda, torch.float64), R.to(cuda), xnew.to(cuda),
            xold.to(cuda), ip)


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_pair_delta_matches_plain(cuda, ip_form, with_force):
    """Kernel 3's raw mode, float64: rtol 1e-11, atol 1e-7 (the force
    terms)."""
    system, R, xn, xo, ip = _dense_case(cuda, ip_form, 29)
    n = kernels.pair_delta.launches
    ref = kernels.pair_delta_ref(system, R, xn, xo, ip, with_force)
    got = kernels.pair_delta(system, R, xn, xo, ip, with_force)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-11, atol=1e-7)
    assert with_force or not bool(got[1].any())
    assert kernels.pair_delta.launches == n + 1


@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_pair_u_matches_plain(cuda, ip_form):
    """Kernel 4's u mode of the dense kernel, float64, on the whole chain
    and on the end gate's row view of bead 0."""
    system, R, xn, xo, ip = _dense_case(cuda, ip_form, 31)
    n = kernels.pair_u.launches
    for sl in (slice(None), slice(0, 1)):
        ipx = ip if isinstance(ip, int) or ip.dim() == 1 \
            else ip[:, sl].contiguous()
        args = (system, R[:, sl], xn[:, sl], xo[:, sl], ipx)
        torch.testing.assert_close(kernels.pair_u(*args),
                                   kernels.pair_u_ref(*args),
                                   rtol=1e-11, atol=1e-9)
    assert kernels.pair_u.launches == n + 2


def _action_cases(cfg, system, paths, ib_form, g):
    """(R, ip, ib, label) of the dense action's epilogue: the end gate's row
    views of beads 0 and M-1, and whole chains (end, odd and even interior
    rows), with ib [B] or [W, B]."""
    W, M, N = paths.shape[0], cfg.M, cfg.Np
    dev = paths.device
    if ib_form == "B":
        return [(paths[:, :1], 5, system.arange(0, 1), "bead 0"),
                (paths, torch.randint(0, N, (W,), generator=g, device=dev),
                 system.arange(0, M), "chains")]
    return [(paths[:, M - 1:], 5,
             torch.full((W, 1), M - 1, dtype=torch.long, device=dev),
             "bead M-1"),
            (paths, torch.randint(0, N, (W, M), generator=g, device=dev),
             torch.randint(0, M, (W, M), generator=g, device=dev), "chains")]


@pytest.mark.parametrize("with_force", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ib_form", ["B", "WB"])
def test_dense_action_epilogue_matches_plain(cuda, ib_form, dtype,
                                             with_force):
    """Kernels 3 and 4 in one launch closing the dense action delta
    (torch_card.action_check): float64 within the raw terms' tolerances
    (rtol 1e-11) weighted as the terms, float32 within _close's rule; one
    coincident partner per case, non-finite exactly where the plain form
    is (NaN with force)."""
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    paths = torch_card._flagship_paths(cfg, 64, dtype, cuda, seed=59)
    g = torch.Generator(device=cuda).manual_seed(59)
    n = kernels.pair_delta.launches, kernels.pair_u.launches
    nonfinite = 0
    for R, ip, ib, label in _action_cases(cfg, system, paths, ib_form, g):
        xnew, xold = torch_card._window_ip(R, ip, g)
        nonfinite += torch_card.action_check(system, sys64, R, xnew, xold,
                                             ip, ib, with_force, label)[2]
    assert nonfinite >= 1
    assert (kernels.pair_delta.launches, kernels.pair_u.launches) == (
        n[0] + 2, n[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_action_at_full_width_matches_plain(cuda, dtype):
    """The one-launch dense action at the end gate's rows (beads 0 and
    M-1, 1024 walkers: a whole wave) and over whole chains (end, odd and
    even interior rows), with and without force, one coincident partner per
    case (torch_card.action_check)."""
    cfg = flagship_cfg(1024)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    paths = torch_card._flagship_paths(cfg, 1024, dtype, cuda, seed=83)
    g = torch.Generator(device=cuda).manual_seed(83)
    nonfinite = 0
    for ib_form in ("B", "WB"):
        for R, ip, ib, label in _action_cases(cfg, system, paths, ib_form, g):
            xnew, xold = torch_card._window_ip(R, ip, g)
            for with_force in (True, False):
                nonfinite += torch_card.action_check(
                    system, sys64, R, xnew, xold, ip, ib, with_force,
                    label)[2]
    assert nonfinite >= 4


@pytest.mark.parametrize("with_force", [True, False])
def test_dense_action_epilogue_at_a_coincident_end_row(cuda, with_force):
    """The end gate's row with an exactly coincident partner, float64: the
    reference gives NaN with force (0 * NaN df2) and +inf without (-du of
    u = -inf); the kernel gives the same, every other row within rtol
    1e-11."""
    from pathintegralgroundstate_torch.ops.pairwise import delta_action
    system, R, xn, xo, _ = _dense_case(cuda, "scalar", 79)
    R1, xo1 = R[:, :1], xo[:, :1]
    xn1 = xn[:, :1].clone()
    xn1[3, 0] = R1[3, 0, 9]
    ib = system.arange(0, 1)
    got = delta_action(system, R1, xn1, xo1, 3, ib, with_force)
    cpu = make_system(system.cfg, "cpu", torch.float64)
    want = delta_action(cpu, R1.cpu(), xn1.cpu(), xo1.cpu(), 3, ib.cpu(),
                        with_force)
    assert bool(want[3, 0].isnan()) if with_force else \
        float(want[3, 0]) == float("inf")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-11, atol=1e-9,
                               equal_nan=True)


def test_dense_delta_action_is_one_launch(cuda):
    """On the card delta_action issues exactly one kernel, kernel 3 with
    kernel 4's pass and the epilogue, and nothing after it
    (torch.profiler); pair_u does not launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathintegralgroundstate_torch.ops.pairwise import delta_action
    system, R, xn, xo, _ = _dense_case(cuda, "scalar", 61)
    args = (system, R[:, :1], xn[:, :1], xo[:, :1], 3, system.arange(0, 1))
    want = delta_action(*args)       # builds the kernels, caches the table
    torch.cuda.synchronize()
    n = kernels.pair_delta.launches, kernels.pair_u.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = delta_action(*args)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in kern) == 1, [e.key for e in kern]
    assert any("pair_delta_kernel" in e.key for e in kern)
    assert (kernels.pair_delta.launches, kernels.pair_u.launches) == (
        n[0] + 1, n[1])
    assert torch.equal(got, want)


def test_dense_kernels_refuse_what_they_cannot_read(cuda):
    system, R, xn, xo, _ = _dense_case(cuda, "scalar", 37)
    ip_t = torch.zeros(64, 65, dtype=torch.long, device=cuda)
    for fn in (kernels.pair_delta, kernels.pair_u):
        with pytest.raises(ValueError):
            fn(system, R, xn, xo, ip_t.T.contiguous().T)
        with pytest.raises(ValueError):
            fn(system, R, xn, xo, ip_t.int())
        with pytest.raises(ValueError):
            fn(system, R, xn[:, :3], xo, 0)
    tab, ib = chin_table(system), torch.arange(65, device=cuda)
    n = kernels.pair_delta.launches
    for bad in ((tab[:2], ib), (tab.float(), ib), (tab.T.contiguous().T, ib),
                (tab, ib.int()), (tab, ib[:3])):
        with pytest.raises(ValueError):
            kernels.pair_delta(system, R, xn, xo, 0, True, *bad)
    assert kernels.pair_delta.launches == n


def test_flagship_step_on_card_matches_cpu(cuda):
    torch_card.replay_check(flagship_cfg(16).replace(Nstag=1, Nobdm=2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["ends", "interior"])
def test_cascade_matches_plain(cuda, mode, dtype):
    """Kernel 5 against cascade_ref (plain pair pass), some slots inactive:
    float64 accepts exactly equal and windows within rtol 1e-11; float32
    decisions agree on more than 95 % of the slots and windows agree within
    rtol 2e-4 / atol 2e-5 where they do (torch_card.cascade_check)."""
    share, err, n_acc = torch_card.cascade_check(flagship_cfg(256), 256,
                                                 dtype, mode)
    print(f"cascade {mode} {dtype}: decisions agree on {share:.6f}, max abs "
          f"err {err:.3e}, {n_acc} accepted")


@pytest.mark.parametrize("mode", ["ends", "interior"])
def test_cascade_strided_paths_match_plain(cuda, mode):
    """Kernel 5 on paths whose particle axis is strided (a view of every
    other particle of a wider array), which it stages element by element:
    float64 accepts and every bead equal to the plain form's within rtol
    1e-11, the particles between untouched."""
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref
    cfg = flagship_cfg(128)
    system, paths, slots, rg, ru, act = torch_card._cascade_inputs(
        cfg, 128, torch.float64, mode, seed=47)
    wide = torch.zeros(128, cfg.M, 128, 3, dtype=torch.float64, device=cuda)
    wide[:, :, ::2] = paths
    ref = paths.clone()
    n = kernels.cascade.launches
    acc = kernels.cascade(system, mode, wide[:, :, ::2], slots, rg, ru, act,
                          cfg.Nlev)
    acc_ref = cascade_ref(system, mode, ref, slots, rg, ru, act, cfg.Nlev,
                          kernels.pair_rows_ref)
    assert kernels.cascade.launches == n + 1
    assert torch.equal(acc, acc_ref) and bool(acc.any())
    torch.testing.assert_close(wide[:, :, ::2], ref, rtol=1e-11, atol=1e-12)
    assert not bool(wide[:, :, 1::2].any())


def test_cascade_refuses_what_it_cannot_run(cuda):
    system = make_system(flagship_cfg(4), cuda, torch.float64)
    paths = torch.zeros(4, 65, 64, 3, dtype=torch.float64, device=cuda)
    rg = torch.zeros(4, 2, 17, 3, dtype=torch.float64, device=cuda)
    ru = torch.zeros(4, 2, 5, dtype=torch.float64, device=cuda)
    act = torch.ones(4, 2, dtype=torch.bool, device=cuda)
    slots = [(0, 1, 0), (64, -1, 0)]
    with pytest.raises(ValueError):
        kernels.cascade(system, "rigid", paths, slots, rg, ru, act, 4)
    with pytest.raises(ValueError):
        kernels.cascade(system, "ends", paths, [(60, 1, 0), (64, -1, 0)], rg,
                        ru, act, 4)
    with pytest.raises(ValueError):
        kernels.cascade(system, "ends", paths, slots, rg, ru[:, :, :4], act, 4)
    n = kernels.cascade.launches
    kernels.cascade(system, "ends", paths, slots, rg, ru, act, 4)
    assert kernels.cascade.launches == n + 1


def test_cascade_beyond_48k_shared_memory_matches_plain(cuda):
    """A window of 200 particles in float64 (82 KB) needs the kernel's
    opt-in to more than 48 KB of dynamic shared memory; it runs and matches
    the plain form."""
    assert kernels.cascade_smem(16, 200, 3, 8) > 48 * 1024
    torch_card.cascade_check(flagship_cfg(64).replace(Np=200), 64,
                             torch.float64, "ends")


def test_cascade_shared_memory_limit_raises(cuda):
    """A window beyond the block's shared memory (17 rows of 600 particles
    in float64: 245 KB) raises before any launch, and no plain form runs in
    its place: paths stay as they were."""
    system = make_system(flagship_cfg(4), cuda, torch.float64)
    assert kernels.cascade_smem(16, 600, 3, 8) > kernels.SMEM_MAX
    paths = torch.randn(2, 65, 600, 3, dtype=torch.float64, device=cuda)
    before = paths.clone()
    rg = torch.zeros(2, 2, 17, 3, dtype=torch.float64, device=cuda)
    ru = torch.zeros(2, 2, 5, dtype=torch.float64, device=cuda)
    act = torch.ones(2, 2, dtype=torch.bool, device=cuda)
    n = kernels.cascade.launches
    with pytest.raises(ValueError, match="shared memory"):
        kernels.cascade(system, "ends", paths, [(0, 1, 0), (64, -1, 0)], rg,
                        ru, act, 4)
    assert kernels.cascade.launches == n and torch.equal(paths, before)


def test_fused_step_on_card_matches_cpu(cuda):
    torch_card.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, fused_sweep=True), "fused")


def test_fused_cascade_step_on_card_matches_cpu(cuda):
    torch_card.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, fused_sweep=True, cascade=True), "fused+cascade")


@pytest.mark.parametrize("label,overrides", [
    ("reference order", dict(bis_monoshot=False, bis_end_random_depth=True)),
    ("staging + scan", dict(sampling="sta", regrow="scan", Lstag=16)),
    ("fused per level", dict(fused_sweep=True, bis_monoshot=False)),
])
def test_per_level_and_staging_steps_on_card_match_cpu(cuda, label,
                                                       overrides):
    torch_card.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, **overrides), label)


@pytest.mark.parametrize("N", [31, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [1, 2])
def test_kernels_at_dims_1_and_2_match_plain(cuda, dim, dtype, N):
    """Kernels A, B, 3/4 and 5 at D = 1 (a chain) and D = 2 (a He-4 film)
    under PBC against their plain forms (torch_card.dims_case)."""
    density = dict(torch_card.DIMS)[dim]
    n, vec, bulk, shares = torch_card.dims_case(flagship_cfg(64), dim,
                                                density, dtype, N, W=64)
    print(f"D={dim} N={N} {dtype}: {n} cases, 16-byte copies {vec}, bulk "
          f"{bulk}, kernel 5 agreement {shares}")


def test_2d_film_step_on_card_matches_cpu(cuda):
    torch_card.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, dim=2, density=0.26), "2-D film")


def test_trap_steps_launch_no_kernel(cuda):
    """The trapped worm flagship and the 1-D oscillator with bisection on
    the card equal the CPU, and launch no kernel (torch_card.trap_replays):
    the trap runs the plain forms, as the reference routes it."""
    torch_card.trap_replays()


@pytest.mark.parametrize("N", [30, 31, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [4, 5])
def test_kernels_at_dims_4_and_5_match_plain(cuda, dim, dtype, N):
    """Kernels A, B, 3/4 and 5 at D = 4 (the flagship's density) and D = 5
    (0.1: the box of D = 4 at N = 64), where each thread holds its vectors
    in shared memory, against their plain forms (torch_card.dims_case);
    at these N the 16-byte staging and kernel 5's bulk copy flip with D and
    the type."""
    density = dict(torch_card.DIMS)[dim]
    n, vec, bulk, shares = torch_card.dims_case(flagship_cfg(64), dim,
                                                density, dtype, N)
    print(f"D={dim} N={N} {dtype}: {n} cases, 16-byte copies {vec}, bulk "
          f"{bulk}, kernel 5 agreement {shares}")


# (potential, Jastrow): every potential on every kernel and every Jastrow
# on every kernel that carries u
VARIANTS = (("aziz2", "mcmillan_c1"), ("soft", "dipolar2d"),
            ("dipolar", "dipolar2d"), ("dipolar", "none"), ("none", "none"),
            ("none", "mcmillan_c1"))


def _overflow_rows(R, xnew, ip, d=1e-4):
    """xnew with walker 5's row 1 at d from a partner: soft's r^-12
    overflows float32 there (and not float64)."""
    xn = xnew.clone()
    j = (int(ip[5, 1]) + 1) % R.shape[2]
    xn[5, 1] = R[5, 1, j]
    xn[5, 1, 0] += d
    return xn


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("pot,jas", VARIANTS)
@pytest.mark.parametrize("shape", ["flagship", "dipolar"])
def test_pair_models_match_plain(cuda, shape, pot, jas, dtype, W=256):
    """Every kernel against its plain form for one pair model and type, on
    liquid-like paths of the flagship's 3-D N=64 or the dipolar gas's 2-D
    N=256 shape: kernel A over a window of 8 rows with ip [W, B] and one
    coincident partner, forward (rows) and reversed (walker sums), f2 and
    u and neither; kernel B on both ThermEnergy views; kernel 3's raw and
    kernel 4's u mode at the gate's row and at 16 rows; the action mode at
    the gate's row and over whole chains, with and without force; kernel 5
    'ends' and 'interior' (every active slot accepted for the ideal gas).
    Non-finite values, from a coincident partner of the soft or the
    dipolar core, must be exactly where the plain form has them
    (torch_card._close, action_check).  For soft in float32 also a row and
    a configuration with a pair 1e-4 apart, where r^-12 overflows.  Each of
    the five pair kernels launches."""
    from pathintegralgroundstate_torch.flagship import dipolar_cfg
    base = flagship_cfg(256) if shape == "flagship" else dipolar_cfg(256)
    cfg = base.replace(potential=pot, jastrow=jas)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    kern = torch_card._kernel_fns()
    before = {k: fn.launches for k, fn in kern.items()}
    paths = torch_card._flagship_paths(cfg, W, dtype, cuda, seed=50)
    g = torch.Generator(device=cuda).manual_seed(51)
    N, M, B = cfg.Np, cfg.M, 8
    label = f"{pot}/{jas} D={cfg.dim} N={N}"
    lo = (M - B) // 2
    R = paths[:, lo:lo + B]
    ib = torch.arange(lo, lo + B, device=cuda)
    ip = torch.randint(0, N, (W, B), generator=g, device=cuda)
    xnew, xold = torch_card._window_ip(R, ip, g)
    for rev in (False, True):
        torch_card.rows_parity(system, sys64, R, xnew, xold, ip, ib, rev,
                               [(True, True), (False, False)], label,
                               reduce=rev)
    for sl, view in ((slice(0, M - 1, 2), "even view"),
                     (slice(1, M - 1, 2), "odd view")):
        torch_card.pot_check(system, sys64, paths[:, sl], f"{label} {view}")
    w0 = (M - 16) // 2
    for Rr, ipr, lab in (
            (paths[:, :1], 5, "gate bead 0"),
            (paths[:, w0:w0 + 16],
             torch.randint(0, N, (W, 16), generator=g, device=cuda),
             "16 rows ip[W, B]")):
        torch_card.dense_raw_check(system, sys64, Rr, ipr, g,
                                   f"{label} {lab}")
    for Rr, ipr, ibr, lab in (
            (paths[:, :1], 5, system.arange(0, 1), "gate"),
            (paths, torch.randint(0, N, (W,), generator=g, device=cuda),
             system.arange(0, M), "whole chains")):
        xn, xo = torch_card._window_ip(Rr, ipr, g)
        for wf in (True, False):
            torch_card.action_check(system, sys64, Rr, xn, xo, ipr, ibr, wf,
                                    f"{label} {lab}")
    ideal = pot == "none" and jas == "none"
    for mode in ("ends", "interior"):
        torch_card.cascade_check(cfg, W, dtype, mode, seed=52,
                                 outcomes="all" if ideal else "any")
    if pot == "soft" and dtype == torch.float32:
        xo_ = _overflow_rows(R, xnew, ip)
        plain = kernels.pair_rows_ref(system, R, xo_, xold, ip,
                                      chin_table(system), ib, True, True)
        assert bool(torch.isinf(plain[5, 1]) | torch.isnan(plain[5, 1])), \
            "the plain float32 form did not overflow at r = 1e-4"
        torch_card.rows_parity(system, sys64, R, xo_, xold, ip, ib, False,
                               [(True, True), (False, False)],
                               f"{label} overflow")
        P = paths[:, 1:M - 1:2].clone()
        P[5, 2, 7] = P[5, 2, 8]
        P[5, 2, 7, 0] += 1e-4
        torch_card.pot_check(system, sys64, P, f"{label} overflow pair")
    ran = {k: fn.launches - before[k] for k, fn in kern.items()}
    assert all(ran[k] for k in torch_card.PAIR_KERNELS), ran


def test_dipolar_step_kernel_calls_match_plain(cuda):
    """Kernels A and B against their plain forms on the calls the dipolar
    path makes: one step of flagship.dipolar_cfg(1024) (float64) during
    which the first call of each form of kernel A (window rows B, ip scalar
    or [1, B], reversed, walker sums, f2 and u) and of kernel B is checked
    on its own arguments before it runs, with rows_parity and pot_check, in
    float64 and on the same inputs cast to float32.  At W=1024 the lane
    rule (kernels.rows_lanes) gives the CM chains (B=17, walker sums) G=4,
    the end windows (B=4) G=16 and the fused interior span (B=11) G=8:
    every G the path launches is held here."""
    from pathintegralgroundstate_torch.flagship import dipolar_cfg
    from pathintegralgroundstate_torch.state import init_state
    from pathintegralgroundstate_torch.sweep import Sweeper, run_block

    cfg = dipolar_cfg(1024)
    sys64 = make_system(cfg, cuda)
    sys32 = make_system(cfg, cuda, torch.float32)
    N = cfg.Np
    rows, pot = kernels.pair_rows, kernels.pair_pot
    seen, lanes = set(), set()

    def f32(t):
        return t.float() if torch.is_tensor(t) and t.is_floating_point() \
            else t

    def check_rows(system, R, xnew, xold, ip, tab, ib, need_wf=True,
                   need_f2=True, rev=False, row_weights=None, reduce=False):
        B = R.shape[1]
        form = (B, "scalar" if isinstance(ip, int) else tuple(ip.shape),
                need_wf, need_f2, rev, row_weights is not None, reduce)
        if form not in seen:
            seen.add(form)
            lanes.add(kernels.rows_lanes(R.shape[0], B, N))
            for s, args in ((sys64, (R, xnew, xold, ip, ib)),
                            (sys32, tuple(map(f32, (R, xnew, xold, ip,
                                                    ib))))):
                torch_card.rows_parity(s, sys64, *args, rev,
                                       [(need_wf, need_f2)],
                                       f"dipolar path {form}",
                                       f32(row_weights) if s is sys32
                                       else row_weights, reduce)
        return rows(system, R, xnew, xold, ip, tab, ib, need_wf, need_f2,
                    rev, row_weights, reduce)

    def check_pot(system, R, with_force=False):
        form = ("B",) + tuple(R.shape)
        if form not in seen:
            seen.add(form)
            for s, Rs in ((sys64, R), (sys32, R.float())):
                torch_card.pot_check(s, sys64, Rs, f"dipolar path {form}",
                                     chunk=128)
        return pot(system, R, with_force)

    # each wrapper counts its launches on its own attributes, which it
    # reaches through the module's name: share them
    check_rows.__dict__, check_pot.__dict__ = rows.__dict__, pot.__dict__
    sweeper = Sweeper(sys64)
    state = init_state(sys64)
    kernels.pair_rows, kernels.pair_pot = check_rows, check_pot
    try:
        run_block(sweeper, state, 1)
    finally:
        kernels.pair_rows, kernels.pair_pot = rows, pot
    torch.cuda.synchronize()
    assert lanes == {4, 8, 16}, sorted(lanes)
    assert any(f[0] == "B" for f in seen)


# (D, density) of the bfloat16 cases: a 1-D chain, a 2-D He-4 film and the
# flagship's density at D = 3 and 4
BF16_DIMS = ((1, 0.5), (2, 0.26), (3, 0.365), (4, 0.365))


@pytest.mark.parametrize("N", [30, 31, 64])
@pytest.mark.parametrize("D,density", BF16_DIMS)
def test_kernels_in_bfloat16_within_the_bound(cuda, D, density, N, W=128):
    """Every kernel in bfloat16 at dimension D with N particles, held with
    its bfloat16 plain form to float64 truth (the plain form in float64 on
    the same bfloat16 inputs) by the bound of utils/bf16: |x - x64| <= C
    2^-8 sum|terms|, non-finite exactly where the truth is.  Kernel A over
    windows of B=16 and 65 (ip int, [W], [W, B], [1, B], forward and
    reversed, rows and walker sums), kernel B on both ThermEnergy views,
    the dense kernel's raw, u and action modes at the gate's row and at
    B=16 (one exactly coincident partner per block), kernel 5 'ends' and
    'interior' against float64 truth (decisions agree on more than 90 % of
    the slots; where both accept, each position within C 2^-8 (|x64| +
    |xold| + sqrt(L dt) max|g|)).  At N = 30, 31 and 64 (rows of partners
    of 60 to 512 bytes) the 16-byte rule of kernels A and B and kernel 5's
    bulk copy flip with N and D."""
    import math

    from pathintegralgroundstate_torch.ops.cascade import cascade_ref
    from pathintegralgroundstate_torch.utils import bf16 as BB

    bf = torch.bfloat16
    c = flagship_cfg(64).replace(dim=D, Np=N, density=density)
    system = make_system(c, cuda, bf)
    sys64 = make_system(c, cuda, torch.float64)
    paths = torch_card._flagship_paths(c, W, bf, cuda, seed=70 + N + D)
    g = torch.Generator(device=cuda).manual_seed(71)
    M, tab, tab64 = c.M, chin_table(system), chin_table(sys64)
    K = kernels

    def hold(name, label, got, truth, scale):
        r = BB.ratio(got, truth, scale)
        assert r <= BB.C, (f"{name} D={D} N={N} {label}: |x - x64| reaches "
                           f"{r:.3f} x 2^-8 sum|terms|, above C = {BB.C}")

    for B in (16, 65):
        lo = (M - B) // 2
        R = paths[:, lo:lo + B]
        ib = torch.arange(lo, lo + B, device=cuda)
        ips = (7 % N, torch.randint(0, N, (W,), generator=g, device=cuda),
               torch.randint(0, N, (W, B), generator=g, device=cuda),
               torch.randint(0, N, (1, B), generator=g, device=cuda))
        for k, ip in enumerate(ips):
            xnew, xold = torch_card._window_ip(R, ip, g)
            a64 = (R.double(), xnew.double(), xold.double(), ip)
            for rev in (False, True):
                red = bool((k + rev) % 2)
                for wf, f2 in ((True, True), (False, False)):
                    hold("pair_rows", f"B={B} ip#{k} rev={rev} wf={wf}",
                         K.pair_rows(system, R, xnew, xold, ip, tab, ib, wf,
                                     f2, rev, None, red),
                         K.pair_rows_ref(sys64, *a64, tab64, ib, wf, f2, rev,
                                         None, red),
                         BB.rows_scale(sys64, *a64, tab64, ib, wf, f2, rev,
                                       None, red))
    for sl, view in ((slice(0, M - 1, 2), "even view"),
                     (slice(1, M - 1, 2), "odd view")):
        R = paths[:, sl]
        for wf in (False, True):
            got = K.pair_pot(system, R, wf)
            truth = K.pair_pot_ref(sys64, R.double(), wf)
            scale = BB.pot_scale(sys64, R.double(), wf)
            for i in range(1 + wf):
                hold("pair_pot", f"{view} force={wf} out{i}", got[i],
                     truth[i], scale[i])
    lo = (M - 16) // 2
    for R, ip, ib, label in (
            (paths[:, :1], 5, system.arange(0, 1), "gate row"),
            (paths[:, lo:lo + 16],
             torch.randint(0, N, (W,), generator=g, device=cuda),
             system.arange(lo, lo + 16), "B=16 ip[W]")):
        xnew, xold = torch_card._window_ip(R, ip, g)
        a = (R, xnew, xold, ip)
        a64 = (R.double(), xnew.double(), xold.double(), ip)
        for wf in (True, False):
            got = K.pair_delta(system, *a, wf)
            truth = K.pair_delta_ref(sys64, *a64, wf)
            scale = BB.dense_scale(sys64, *a64, wf)
            for i in range(1 + wf):
                hold("pair_delta", f"{label} raw force={wf} out{i}", got[i],
                     truth[i], scale[i])
            w = torch_card.dense_wf(system, wf)
            hold("pair_delta", f"{label} action force={wf}",
                 K.pair_delta(system, *a, wf, tab, ib, w),
                 K.pair_delta_ref(sys64, *a64, wf, tab64, ib, w),
                 BB.dense_scale(sys64, *a64, wf, tab64, ib, w))
        hold("pair_u", label, K.pair_u(system, *a), K.pair_u_ref(sys64, *a64),
             BB.u_scale(sys64, *a64))
    L, nlev = 2 ** c.Nlev, c.Nlev
    for mode in ("ends", "interior"):
        sysb, p, slots, rg, ru, act = torch_card._cascade_inputs(
            c, W, bf, mode, 72)
        got, ref = p.clone(), p.double()
        acc = K.cascade(sysb, mode, got, slots, rg, ru, act, nlev)
        acc64 = cascade_ref(sys64, mode, ref, slots, rg.double(), ru.double(),
                            act, nlev, K.pair_rows_ref)
        assert not bool((acc & ~act).any())
        assert 0 < int(acc.sum()) < int(act.sum()), (
            f"cascade {mode}: {int(acc.sum())} of {int(act.sum())} active "
            "slots accepted")
        agree = acc == acc64
        share = float(agree.double().mean())
        assert share > 0.9, (f"cascade {mode}: decisions agree with float64 "
                             f"truth on {share:.4f} of the slots")
        sig = math.sqrt(L * c.dt) * float(rg.double().abs().max())
        for s, (b0, step, ip) in enumerate(slots):
            beads = torch.arange(L + 1, device=cuda) * step + b0
            both = agree[:, s] & acc[:, s]
            x64 = ref[both][:, beads, ip]
            # a position that rounds across the box's edge is the same
            # point: its difference is taken by the minimum image
            x = x64 + torch_card._wrap(
                got[both][:, beads, ip].double() - x64, sys64.geo.Lbox[0])
            xo = p[both][:, beads, ip].double()
            hold("cascade", f"{mode} slot {s} positions", x, x64,
                 x64.abs() + xo.abs() + sig)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernels_at_the_exact_f2_brute_windows_match_plain(cuda, dtype):
    """The kernels of the brute exact-F^2 path at its window shape [W, 16,
    64, 3]: kernel B on head and tail windows as they are and with the
    moved particle at its proposal (F^2(R) and F^2(R')), kernel 3's raw
    mode and kernel 4's u mode on the same rows (torch_card.pot_check,
    dense_raw_check)."""
    from pathintegralgroundstate_torch.ops import pairwise as P

    ex = flagship_cfg(64).replace(exact_f2=True, f2_cache=False)
    system = make_system(ex, cuda, dtype)
    sys64 = make_system(ex, cuda, torch.float64)
    paths = torch_card._flagship_paths(ex, 64, dtype, cuda, seed=43)
    g = torch.Generator(device=cuda).manual_seed(41)
    for lo, label in ((0, "head rows"), (ex.M - 16, "tail rows")):
        R = paths[:, lo:lo + 16]
        xnew = R[:, :, 5] + 0.05 * torch.randn(
            R[:, :, 5].shape, generator=g, device=cuda, dtype=dtype)
        for RR, what in ((R, "R"), (P._moved(R, xnew, 5), "R'")):
            torch_card.pot_check(system, sys64, RR, f"{label} {what}")
        torch_card.dense_raw_check(system, sys64, R, 5, g, label)


@pytest.mark.parametrize("name", ["dense delta_action", "brute rows",
                                  "brute rows reversed"])
def test_exact_f2_forms_on_card_match_cpu(cuda, name):
    """The composed exact-F^2 forms on the card against the same forms on
    the CPU (plain forms), float64 at [64, 65, 64, 3]: the dense
    delta_action (one launch of kernel 3 raw, two of B, one of 4) and the
    brute window rows forward and reversed (two launches of B, none of A),
    within rtol 1e-9, atol 1e-9."""
    from pathintegralgroundstate_torch.ops import pairwise as P

    fn, kw, want = {
        "dense delta_action": (P.delta_action, {},
                               dict(pair_delta=1, pair_pot=2, pair_u=1)),
        "brute rows": (P.delta_action_rows, {}, dict(pair_pot=2)),
        "brute rows reversed": (P.delta_action_rows, dict(rev=True),
                                dict(pair_pot=2))}[name]
    ex = flagship_cfg(64).replace(exact_f2=True, f2_cache=False)
    card = make_system(ex, cuda, torch.float64)
    cpu = make_system(ex, "cpu", torch.float64)
    g = torch.Generator(device=cuda).manual_seed(41)
    paths = torch_card._flagship_paths(ex, 64, torch.float64, cuda, seed=47)
    ip = torch.randint(0, ex.Np, (64,), generator=g, device=cuda)
    xold = paths[torch.arange(64, device=cuda), :, ip]
    xnew = xold + 0.05 * torch.randn(xold.shape, generator=g, device=cuda,
                                     dtype=torch.float64)
    ib = card.arange(ex.M)
    kern = torch_card._kernel_fns()
    for f in kern.values():
        f.launches = 0
    got = fn(card, paths, xnew, xold, ip, ib, **kw)
    assert {k: f.launches for k, f in kern.items()} == {
        k: want.get(k, 0) for k in kern}
    ref = fn(cpu, paths.cpu(), xnew.cpu(), xold.cpu(), ip.cpu(), ib.cpu(),
             **kw)
    torch_card._close(f"exact {name} card vs CPU float64", got.cpu(), ref,
                      1e-9, 1e-9)
