"""The hand-written kernels on a CUDA device: each against its plain
PyTorch form (in 3-D, and at D = 1 and 2), and whole steps on the card
(the flagship, the fused sweep with cascade off and on, the reference-order
step, the staging sampler with the scan, the fused sweep in per-level
form, a 2-D film, the trap) against the same steps on the CPU from the
same draws; the trap launches no kernel.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

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
    import chip_smoke
    paths = chip_smoke._flagship_paths(cfg, W, torch.float64, "cpu", seed)
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
    width (chip_smoke.lanes_walkers), ip scalar and [1, B], rows and walker
    sums, against the float64 plain form (chip_smoke.rows_parity: float64
    within the terms' tolerances, float32 within
    tests/test_pallas_kernel.py's plus twice the plain float32 form's own
    error)."""
    import chip_smoke
    cfg = flagship_cfg(128)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    W = chip_smoke.lanes_walkers(lanes, B)
    paths = chip_smoke._flagship_paths(cfg, 128, dtype, cuda, seed=41)
    g = torch.Generator(device=cuda).manual_seed(41)
    R = paths[:, cfg.M - B:].repeat(-(-W // 128), 1, 1, 1)[:W]
    ib = torch.arange(cfg.M - B, cfg.M, device=cuda)
    for ip in (7, torch.randint(0, 64, (1, B), generator=g, device=cuda)):
        xnew, xold = chip_smoke._window_ip(R, ip, g)
        for reduce in (False, True):
            chip_smoke.rows_parity(system, sys64, R, xnew, xold, ip, ib,
                                   B > 1, [(True, True), (False, False)],
                                   f"B={B}", reduce=reduce)


def test_layouts_without_16_byte_rows_match_plain(cuda):
    """Kernels A and 5 at N=30 in float32 and N=31 in float64, where a row
    of partners is no multiple of 16 bytes and both kernels stage it
    element by element (chip_smoke.layout_parity)."""
    import chip_smoke
    chip_smoke.layout_parity(flagship_cfg(256))


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
    import chip_smoke
    cfg = flagship_cfg(W).replace(Np=Np)
    return (make_system(cfg, cuda, dtype), make_system(cfg, cuda,
                                                       torch.float64),
            chip_smoke._flagship_paths(cfg, W, dtype, cuda, seed, dmin))


@pytest.mark.parametrize("Np,dtype,W", [
    (2, torch.float64, 64), (30, torch.float32, 64), (31, torch.float64, 64),
    (64, torch.float32, 64), (65, torch.float64, 64),
    (1024, torch.float64, 1)])
def test_pair_pot_particle_counts_match_plain(cuda, Np, dtype, W):
    """Kernel B without and with force on both ThermEnergy views, from one
    chunk of 32 particles (N=2, 30, 31) to 32 (N=1024: rows of 1024
    threads, 49.7 KB of shared memory in float64, past the 48 KB default),
    rows that are 16-byte slabs or not: float64 within rtol 1e-11, atol
    1e-9 (1e-7 on f2); float32 within chip_smoke._close's rule."""
    import chip_smoke
    system, sys64, paths = _pot_paths(Np, W, dtype, cuda, seed=Np)
    M = system.M
    for sl in (slice(0, M - 1, 2), slice(1, M - 1, 2)):
        chip_smoke.pot_check(system, sys64, paths[:, sl], f"N={Np}")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pair_pot_views_match_plain(cuda, dtype):
    """Both ThermEnergy views read in place (16-byte slabs at N=64), and
    the odd view of a copy that starts one element past 16-byte alignment
    (staged element by element)."""
    import chip_smoke
    system, sys64, paths = _pot_paths(64, 64, dtype, cuda, seed=67)
    M = system.M
    flat = torch.empty(paths.numel() + 1, dtype=dtype, device=cuda)
    flat[1:] = paths.flatten()
    views = (paths[:, 0:M - 1:2], paths[:, 1:M - 1:2],
             flat[1:].view(paths.shape)[:, 1:M - 1:2])
    assert [kernels.slabs16(R) for R in views] == [True, True, False]
    n = kernels.pair_pot.launches
    for R in views:
        chip_smoke.pot_check(system, sys64, R, "view")
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
    (chip_smoke.action_check): float64 within the raw terms' tolerances
    (rtol 1e-11) weighted as the terms, float32 within _close's rule; one
    coincident partner per case, non-finite exactly where the plain form
    is (NaN with force)."""
    import chip_smoke
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    paths = chip_smoke._flagship_paths(cfg, 64, dtype, cuda, seed=59)
    g = torch.Generator(device=cuda).manual_seed(59)
    n = kernels.pair_delta.launches, kernels.pair_u.launches
    nonfinite = 0
    for R, ip, ib, label in _action_cases(cfg, system, paths, ib_form, g):
        xnew, xold = chip_smoke._window_ip(R, ip, g)
        nonfinite += chip_smoke.action_check(system, sys64, R, xnew, xold,
                                             ip, ib, with_force, label)[2]
    assert nonfinite >= 1
    assert (kernels.pair_delta.launches, kernels.pair_u.launches) == (
        n[0] + 2, n[1])


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dense_action_at_full_width_matches_plain(cuda, dtype):
    """The one-launch dense action at the end gate's rows (beads 0 and
    M-1, 1024 walkers: a whole wave) and over whole chains (end, odd and
    even interior rows), with and without force, one coincident partner per
    case (chip_smoke.action_check)."""
    import chip_smoke
    cfg = flagship_cfg(1024)
    system = make_system(cfg, cuda, dtype)
    sys64 = make_system(cfg, cuda, torch.float64)
    paths = chip_smoke._flagship_paths(cfg, 1024, dtype, cuda, seed=83)
    g = torch.Generator(device=cuda).manual_seed(83)
    nonfinite = 0
    for ib_form in ("B", "WB"):
        for R, ip, ib, label in _action_cases(cfg, system, paths, ib_form, g):
            xnew, xold = chip_smoke._window_ip(R, ip, g)
            for with_force in (True, False):
                nonfinite += chip_smoke.action_check(
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
    import chip_smoke
    chip_smoke.replay_check(flagship_cfg(16).replace(Nstag=1, Nobdm=2))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", ["ends", "interior"])
def test_cascade_matches_plain(cuda, mode, dtype):
    """Kernel 5 against cascade_ref (plain pair pass), some slots inactive:
    float64 accepts exactly equal and windows within rtol 1e-11; float32
    decisions agree on more than 95 % of the slots and windows agree within
    rtol 2e-4 / atol 2e-5 where they do (chip_smoke.cascade_check)."""
    import chip_smoke
    share, err, n_acc = chip_smoke.cascade_check(flagship_cfg(256), 256,
                                                 dtype, mode)
    print(f"cascade {mode} {dtype}: decisions agree on {share:.6f}, max abs "
          f"err {err:.3e}, {n_acc} accepted")


@pytest.mark.parametrize("mode", ["ends", "interior"])
def test_cascade_strided_paths_match_plain(cuda, mode):
    """Kernel 5 on paths whose particle axis is strided (a view of every
    other particle of a wider array), which it stages element by element:
    float64 accepts and every bead equal to the plain form's within rtol
    1e-11, the particles between untouched."""
    import chip_smoke
    from pathintegralgroundstate_torch.ops.cascade import cascade_ref
    cfg = flagship_cfg(128)
    system, paths, slots, rg, ru, act = chip_smoke._cascade_inputs(
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
    import chip_smoke
    assert kernels.cascade_smem(16, 200, 3, 8) > 48 * 1024
    chip_smoke.cascade_check(flagship_cfg(64).replace(Np=200), 64,
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
    import chip_smoke
    chip_smoke.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, fused_sweep=True), "fused")


def test_fused_cascade_step_on_card_matches_cpu(cuda):
    import chip_smoke
    chip_smoke.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, fused_sweep=True, cascade=True), "fused+cascade")


@pytest.mark.parametrize("label,overrides", [
    ("reference order", dict(bis_monoshot=False, bis_end_random_depth=True)),
    ("staging + scan", dict(sampling="sta", regrow="scan", Lstag=16)),
    ("fused per level", dict(fused_sweep=True, bis_monoshot=False)),
])
def test_per_level_and_staging_steps_on_card_match_cpu(cuda, label,
                                                       overrides):
    import chip_smoke
    chip_smoke.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, **overrides), label)


@pytest.mark.parametrize("N", [31, 64])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("dim", [1, 2])
def test_kernels_at_dims_1_and_2_match_plain(cuda, dim, dtype, N):
    """Kernels A, B, 3/4 and 5 at D = 1 (a chain) and D = 2 (a He-4 film)
    under PBC against their plain forms (chip_smoke.dims_case)."""
    import chip_smoke
    density = dict(chip_smoke.DIMS)[dim]
    n, vec, bulk, shares = chip_smoke.dims_case(flagship_cfg(64), dim,
                                                density, dtype, N, W=64)
    print(f"D={dim} N={N} {dtype}: {n} cases, 16-byte copies {vec}, bulk "
          f"{bulk}, kernel 5 agreement {shares}")


def test_2d_film_step_on_card_matches_cpu(cuda):
    import chip_smoke
    chip_smoke.replay_check(flagship_cfg(16).replace(
        Nstag=1, Nobdm=2, dim=2, density=0.26), "2-D film")


def test_trap_steps_launch_no_kernel(cuda):
    """The trapped worm flagship and the 1-D oscillator with bisection on
    the card equal the CPU, and launch no kernel (chip_smoke.trap_replays):
    the trap runs the plain forms, as the reference routes it."""
    import chip_smoke
    chip_smoke.trap_replays()
