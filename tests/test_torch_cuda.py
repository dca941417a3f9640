"""The hand-written kernels on a CUDA device: each against its plain
PyTorch form, and whole steps on the card (the flagship, the fused sweep
with cascade off and on, the reference-order step, the staging sampler
with the scan, the fused sweep in per-level form) against the same steps
on the CPU from the same draws.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so on a machine with a card but without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from pathintegralgroundstate_torch.flagship import flagship_cfg
from pathintegralgroundstate_torch.ops import kernels
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
    """float64: only the summation order differs (rtol 1e-11; atol 1e-7
    for the force terms, whose pair forces cancel to a net |F|)."""
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R, xnew, xold, ip = _window(cfg, ip_form, 64, seed=13)
    R, xn, xo = R.to(cuda), xnew.to(cuda), xold.to(cuda)
    ip = ip if isinstance(ip, int) else ip.to(cuda)
    n = kernels.pair_rows.launches
    for rev in (False, True):
        for need_wf, need_f2 in ((True, True), (False, False)):
            got = kernels.pair_rows(system, R, xn, xo, ip, need_wf, need_f2,
                                    rev)
            ref = kernels.pair_rows_ref(system, R, xn, xo, ip, need_wf,
                                        need_f2, rev)
            for g, r in zip(got, ref):
                if r is not None:
                    torch.testing.assert_close(g, r, rtol=1e-11, atol=1e-7)
    assert kernels.pair_rows.launches == n + 4


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
    got = kernels.pair_rows(system, R, xnew, xold, ip, False, True)
    ref = kernels.pair_rows_ref(system, R, xnew, xold, ip, False, True)
    for g_, r in zip(got[:2], ref[:2]):
        torch.testing.assert_close(g_, r, rtol=1e-11, atol=1e-7)
        assert not bool(g_[:, 15::16].any())
    assert got[2] is None


@pytest.mark.parametrize("with_force", [False, True])
def test_pair_pot_matches_plain(cuda, with_force):
    cfg = flagship_cfg(64)
    system = make_system(cfg, cuda, torch.float64)
    R = _window(cfg, "scalar", 64, seed=17)[0].to(cuda)[:, 1::2]
    for g, r in zip(kernels.pair_pot(system, R, with_force),
                    kernels.pair_pot_ref(system, R, with_force)):
        torch.testing.assert_close(g, r, rtol=1e-11, atol=1e-7)


def test_pair_rows_refuses_what_it_cannot_read(cuda):
    system = make_system(flagship_cfg(4), cuda, torch.float64)
    R = torch.zeros(4, 5, 64, 3, dtype=torch.float64, device=cuda)
    x = torch.zeros(4, 5, 3, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        kernels.pair_rows(system, R.transpose(2, 3), x, x, 0)
    with pytest.raises(ValueError):
        kernels.pair_rows(system, R, x.float(), x, 0)


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
    """Kernel 3, float64: rtol 1e-11, atol 1e-7 (the force terms)."""
    system, R, xn, xo, ip = _dense_case(cuda, ip_form, 29)
    n = kernels.pair_delta.launches
    got = kernels.pair_delta(system, R, xn, xo, ip, with_force)
    ref = kernels.pair_delta_ref(system, R, xn, xo, ip, with_force)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-11, atol=1e-7)
    assert with_force or not bool(got[1].any())
    assert kernels.pair_delta.launches == n + 1


@pytest.mark.parametrize("ip_form", ["scalar", "walker", "row"])
def test_pair_u_matches_plain(cuda, ip_form):
    """Kernel 4, float64, on the whole chain and on the end gate's row
    view of bead 0."""
    system, R, xn, xo, ip = _dense_case(cuda, ip_form, 31)
    n = kernels.pair_u.launches
    for sl in (slice(None), slice(0, 1)):
        ipx = ip if isinstance(ip, int) or ip.dim() == 1 \
            else ip[:, sl].contiguous()
        torch.testing.assert_close(
            kernels.pair_u(system, R[:, sl], xn[:, sl], xo[:, sl], ipx),
            kernels.pair_u_ref(system, R[:, sl], xn[:, sl], xo[:, sl], ipx),
            rtol=1e-11, atol=1e-9)
    assert kernels.pair_u.launches == n + 2


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
    print(f"cascade {mode} {dtype}: decisions agree on {share:.6f}, "
          f"max abs err {err:.3e}, {n_acc} accepted")


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
