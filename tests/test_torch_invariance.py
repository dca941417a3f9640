"""Detailed-balance / distribution-invariance tests of the torch moves, one
per move class, on the port's own draws.

The harness of tests/test_invariance.py re-pointed at the port: a 1-D
harmonic trap, Np=1, no pair potential, the exact trial WF.  The Chin-action
path measure is then an exactly known multivariate GAUSSIAN over the bead
coordinates, so we

  1. sample it exactly (Cholesky of the precision matrix, a copy of the
     reference test's, built from the same weights),
  2. run ONE move class alone NITER times on W walkers, its randoms drawn
     by utils/draws.DeviceDraws on a CPU generator at the site Sweeper.step
     draws them from,
  3. KS-test that the bead marginals are unchanged (ALPHA per test).

This holds the law of the chain the card runs: its moves and its draw
source together, where the parity tests feed the port the reference's
draws.  A flipped sign in the accept, a wrong Chin weight or a wrong bridge
sigma moves the bead variance within a few sweeps and fails the gate.
The reference's batched-randoms variants call the same torch functions as
the plain ones; their places here hold the per-level forms instead
(bis_monoshot=False, the Fortran order, with the dense end gate).  The
cascade composites run through cascade_ref, the form the card holds
kernel 5 against.  MALA (smart MC, ops/smartmc.py) targets exp(-S) with
the full action, which is this Gaussian too.  No JAX here.
"""

import numpy as np
import pytest
import torch
from scipy import stats as sps

from pathintegralgroundstate_torch.config import SimConfig
from pathintegralgroundstate_torch.ops import bisection as bis
from pathintegralgroundstate_torch.ops import cascade as cas
from pathintegralgroundstate_torch.ops import moves as mv
from pathintegralgroundstate_torch.ops.smartmc import mala_move
from pathintegralgroundstate_torch.system import make_system
from pathintegralgroundstate_torch.utils.draws import DeviceDraws

torch.set_num_threads(1)

W = 4096          # independent walkers = independent KS samples
NB = 8            # M = 17 beads
M = 2 * NB + 1
DT = 0.2
NITER = 64        # move applications per class
ALPHA = 1e-3      # per-test KS significance (failure modes are gross)
NLEV = 2
L = 2 ** NLEV
ACTIVE = torch.ones(W, dtype=torch.bool)


def _cfg(**kw):
    base = dict(dim=1, Np=1, trap=True, a_ho=(1.0,), potential="none",
                dt=DT, Nb=NB, n_walkers=W, dtype="float64",
                sampling="sta", Lstag=8, Nlev=NLEV, seed=11)
    base.update(kw)
    return SimConfig(**base)


def _precision_matrix(M, dt):
    """Exact precision matrix of the engine's Gaussian path measure (a copy
    of tests/test_invariance.py's).

    S(x) = x0^2/2 + xM^2/2                      (end caps, -log psi, a=1)
         + sum_links (x_i - x_{i+1})^2 / (2 dt)  (free-particle springs)
         + sum_i w_i * x_i^2/2                   (Chin V weights, opt=0)
         + sum_odd (2 dt^3/9) * x_i^2            (Chin F^2 term, F = x)
    with w = dt/3 (ends), 2dt/3 (even interior), 4dt/3 (odd).
    Returns Q with S = x^T Q x / 2.
    """
    Q = np.zeros((M, M))
    for i in range(M - 1):  # springs
        Q[i, i] += 1.0 / dt
        Q[i + 1, i + 1] += 1.0 / dt
        Q[i, i + 1] -= 1.0 / dt
        Q[i + 1, i] -= 1.0 / dt
    for i in range(M):      # Chin-weighted trap potential V = x^2/2
        interior = 0 < i < M - 1
        odd = interior and i % 2 == 1
        w = (4.0 * dt / 3.0) if odd else (2.0 * dt / 3.0 if interior
                                          else dt / 3.0)
        Q[i, i] += w
        if odd:             # F^2 = x^2 with weight 2 dt^3/9
            Q[i, i] += 2.0 * (2.0 * dt ** 3 / 9.0)
    Q[0, 0] += 1.0          # end caps
    Q[M - 1, M - 1] += 1.0
    return Q


def _exact_samples(M, dt, n, seed):
    Q = _precision_matrix(M, dt)
    Lc = np.linalg.cholesky(Q)
    z = np.random.default_rng(seed).standard_normal((M, n))
    x = np.linalg.solve(Lc.T, z)  # cov = Q^{-1}
    return x.T  # [n, M]


SIGMA = np.linalg.inv(_precision_matrix(M, DT))


def _paths(seeds):
    """Exact samples of len(seeds) independent particles: [W, M, N, 1]."""
    x = np.stack([_exact_samples(M, DT, W, seed=s) for s in seeds], axis=2)
    return torch.from_numpy(x)[..., None]


def _iterate(move, paths, system, seed):
    """Apply move(paths, src, it) NITER times, in place, with the draws of
    a DeviceDraws on a seeded CPU generator; returns x [W, M, N]."""
    gen = torch.Generator().manual_seed(seed)
    host = torch.Generator().manual_seed(seed + 1)
    src = DeviceDraws(system, gen, host)
    for it in range(NITER):
        src.begin_step()
        move(paths, src, it)
    return paths[..., 0].numpy()


def _check_invariant(x_fin, beads):
    """KS-test bead marginals against the exact N(0, Sigma_bb) laws."""
    for b in beads:
        sd = np.sqrt(SIGMA[b, b])
        d, p = sps.kstest(x_fin[:, b] / sd, "norm")
        assert p > ALPHA, (
            f"bead {b}: KS p={p:.2e} (D={d:.4f}); "
            f"sample sd={x_fin[:, b].std():.4f} vs exact {sd:.4f}")


def _system(**kw):
    return make_system(_cfg(**kw), "cpu")


def _run_single(system, move, seed, beads):
    """One particle's exact paths through `move`, then the KS gate."""
    x = _iterate(move, _paths([7]), system, seed)
    _check_invariant(x[:, :, 0], beads)


def test_exact_sampler_is_calibrated():
    """The Cholesky start itself passes the KS gate (null calibration)."""
    _check_invariant(_paths([7])[:, :, 0, 0].numpy(), beads=[0, NB, 2 * NB])


def test_translate_chain_invariance():
    system = _system()

    def move(p, src, it):
        mv.translate_chain(system, p, 0, ACTIVE, 0.5,
                           *src.translate(10, 0, W))
    _run_single(system, move, 100, [0, NB, 2 * NB])


def test_staging_invariance():
    system = _system()
    n_sta = (M - 1 - 8) // 2 + 1

    def move(p, src, it):
        mv.staging_move(system, p, 0, ACTIVE, 8,
                        *src.staging_half(22, it, W, n_sta, 8))
    _run_single(system, move, 101, [2, NB, 2 * NB - 2])


def test_move_head_invariance():
    system = _system()

    def move(p, src, it):
        mv.move_head(system, p, 0, ACTIVE, 8, *src.regrow_half(20, it, W, 8))
    _run_single(system, move, 102, [0, 2, 6])


def test_move_tail_invariance():
    system = _system()

    def move(p, src, it):
        mv.move_tail(system, p, 0, ACTIVE, 8, *src.regrow_half(21, it, W, 8))
    _run_single(system, move, 103, [2 * NB, 2 * NB - 2, 2 * NB - 6])


BIS_FORMS = {"monoshot": True, "per_level": False}


@pytest.mark.parametrize("form", BIS_FORMS)
def test_bisection_invariance(form):
    """Interior bisection; per level takes the place of the reference's
    batched-randoms variant."""
    system = _system(bis_monoshot=BIS_FORMS[form])
    n_bis = (M - 1 - L) // 2 + 1
    per_level = not BIS_FORMS[form]

    def move(p, src, it):
        bis.bisection(system, p, 0, ACTIVE, NLEV,
                      src.bisect_keyed(22, it, W, NLEV, n_bis, per_level))
    beads = [1, NB - 1, NB, NB + 1] if per_level else [2, NB, 2 * NB - 2]
    _run_single(system, move, 104 + 100 * per_level, beads)


def test_head_bisection_invariance():
    system = _system()

    def move(p, src, it):
        bis.move_head_bisection(system, p, 0, ACTIVE, NLEV,
                                src.bisect(25, it, W, NLEV))
    _run_single(system, move, 105, [0, 2, NB])


def test_tail_bisection_invariance():
    system = _system()

    def move(p, src, it):
        bis.move_tail_bisection(system, p, 0, ACTIVE, NLEV,
                                src.bisect(26, it, W, NLEV))
    _run_single(system, move, 106, [2 * NB, 2 * NB - 2, NB])


def test_end_bisection_per_level_invariance():
    """The per-level end bisections with the dense gate (the reference's
    form without batched randoms, at the end move's own site), head then
    tail, in the place of the reference's batched-randoms end test."""
    system = _system(bis_monoshot=False)

    def head(p, src, it):
        depth, rand = src.end_bisect(20, it, W, NLEV, True, False)
        bis.move_head_bisection(system, p, 0, ACTIVE, depth, rand, True)

    def tail(p, src, it):
        depth, rand = src.end_bisect(21, it, W, NLEV, True, False)
        bis.move_tail_bisection(system, p, 0, ACTIVE, depth, rand, True)

    _run_single(system, head, 205, [0, 1, 2, 3])
    _run_single(system, tail, 206, [2 * NB, 2 * NB - 1, 2 * NB - 3])


@pytest.mark.parametrize("form", BIS_FORMS)
def test_fused_end_bisections_invariance(form):
    """Composite head+tail bisection: the two end windows are disjoint and
    non-adjacent, so the product kernel must preserve the path measure
    exactly like the sequential pair of moves."""
    system = _system(bis_monoshot=BIS_FORMS[form])
    per_level = not BIS_FORMS[form]

    def move(p, src, it):
        bis.fused_end_bisections(system, p, 0, ACTIVE, NLEV,
                                 src.fused_ends_keyed(it, W, NLEV, per_level))
    _run_single(system, move, 108 + 100 * per_level,
                [0, 2, NB, 2 * NB - 2, 2 * NB])


def test_fused_end_stagings_invariance():
    """Composite head+tail staging: one walker-doubled bridge regrow of
    both end windows (their anchors fixed)."""
    system = _system()

    def move(p, src, it):
        mv.fused_end_stagings(system, p, 0, ACTIVE, 8,
                              *src.end_stagings(it, W, 8))
    _run_single(system, move, 110, [0, 2, NB, 2 * NB - 2, 2 * NB])


def _run_three(move, seed, beads, **kw):
    """Three non-interacting particles (jastrow 'none', no pair potential)
    through `move`; each particle's Gaussian path measure must stay."""
    system = _system(Np=3, jastrow="none", **kw)
    x = _iterate(lambda p, src, it: move(system, p, src, it),
                 _paths([71, 72, 73]), system, seed)
    for n in range(3):
        _check_invariant(x[:, :, n], beads)


K = 3
N_SHIFT = (M - 1 - K * L) // 2 + 1


@pytest.mark.parametrize("form", BIS_FORMS)
def test_bisection_multi_invariance(form):
    """Composite K-particle interior bisection in disjoint window slots."""
    per_level = not BIS_FORMS[form]

    def move(system, p, src, it):
        bis.bisection_multi(system, p, [0, 1, 2], ACTIVE, NLEV,
                            src.bisect_multi_keyed(it, W, K, NLEV, N_SHIFT,
                                                   per_level))
    _run_three(move, 109 + 100 * per_level, [2, NB, 2 * NB - 2],
               bis_monoshot=BIS_FORMS[form])


def test_ends_cascade_invariance():
    """The ends cascade (kernel 5's mode 'ends') through cascade_ref."""
    system = _system(fused_sweep=True, cascade=True)

    def move(p, src, it):
        cas.fused_ends_cascade(system, p, 0, ACTIVE, NLEV,
                               *src.cascade_ends(it, W, NLEV))
    _run_single(system, move, 111, [0, 2, NB, 2 * NB - 2, 2 * NB])


def test_interior_cascade_invariance():
    """The interior cascade (kernel 5's mode 'interior') of three particles
    in disjoint slots through cascade_ref."""
    def move(system, p, src, it):
        cas.interior_cascade(system, p, [0, 1, 2], ACTIVE, NLEV,
                             *src.cascade_interior(it, W, K, NLEV, N_SHIFT))
    _run_three(move, 112, [2, NB, 2 * NB - 2], fused_sweep=True,
               cascade=True)


def test_rigid_cascade_invariance():
    system = _system(cascade=True)

    def move(p, src, it):
        cas.rigid_cascade(system, p, 0, ACTIVE, 0.5, *src.translate(10, 0, W))
    _run_single(system, move, 113, [0, NB, 2 * NB])


def test_mala_invariance():
    """tests/test_invariance.py:236 on the port: the gradient-drifted MALA
    kernel (torch.autograd drift) targets exp(-total_action), the Gaussian
    above, and leaves it invariant at a healthy acceptance."""
    system = _system(exact_f2=True, smart_mc=0.05)

    def move(p, src, it):
        mala_move(system, p, ACTIVE, 0.05, *src.mala(p.shape))
    _run_single(system, move, 114, [0, 2, NB, 2 * NB])
    gen = torch.Generator().manual_seed(9)
    _, acc = mala_move(system, _paths([7]), ACTIVE, 0.05, *DeviceDraws(
        system, gen, torch.Generator()).mala((W, M, 1, 1)))
    rate = float(acc.double().mean())
    assert 0.2 < rate <= 1.0, f"MALA acceptance {rate}"


def test_a_flipped_accept_fails_the_gate(monkeypatch):
    """The gate has teeth: the staging move with exp(+dS) in place of
    exp(-dS) leaves the measure, and the KS test says so."""
    system = _system()
    n_sta = (M - 1 - 8) // 2 + 1
    monkeypatch.setattr(mv, "metropolis_u",
                        lambda u, dS: u < torch.exp(dS))

    def move(p, src, it):
        mv.staging_move(system, p, 0, ACTIVE, 8,
                        *src.staging_half(22, it, W, n_sta, 8))
    with pytest.raises(AssertionError, match="KS p="):
        _run_single(system, move, 101, [2, NB, 2 * NB - 2])
