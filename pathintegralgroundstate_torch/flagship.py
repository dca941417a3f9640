"""The port's named configurations: the flagship workload (He-4, N=64,
Chin action; the reference's vpi.in), the trapped worm flagship
(tools/trap_worm.py's ideal bosons in a 2-D trap) and the 2-D dipolar Bose
gas (tools/dipolar2d.py, BASELINE configuration #5), and what the physics
tools share: the He-4 ladder rung and the Aziz-II tail correction."""

from .config import SimConfig


def flagship_cfg(n_walkers: int = 64) -> SimConfig:
    """He-4 N=64 Chin-action PIGS with a walker ensemble.

    A copy of `__graft_entry__._flagship_cfg` (that module imports JAX);
    tests/test_torch_import.py holds the two equal."""
    return SimConfig(
        dim=3, Np=64, density=0.365, trap=False,
        dt=5e-3, Nb=32, sampling="bis", Lstag=32, Nlev=4, Nstag=5,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=True, CWorm=0.5, Nobdm=10, Npw=0,
        n_walkers=n_walkers, dtype="float32", potential="aziz2",
        jastrow="mcmillan_c1",
        fused_sweep=False,
    )


def trap_worm_cfg(nblocks: int = 30, n_walkers: int = 256) -> SimConfig:
    """The trapped worm flagship: N=8 ideal bosons (potential and Jastrow
    'none') in an isotropic 2-D trap, a = 1, the staging sampler, worm with
    swaps, the density map, float64.  A copy of tools/trap_worm.py's
    configuration (trap_worm.py:51-57), whose exact answers are the
    end-to-end sigma^2 = 4 a^2, the density sigma^2 = a^2 and E/N = 1."""
    a = 1.0
    return SimConfig(
        dim=2, Np=8, trap=True, a_ho=(a, a), dt=0.05, Nb=10,
        sampling="sta", Lstag=8, Nstag=2, CMFreq=1, delta_cm=0.4,
        swapping=True, CWorm=0.5, Nobdm=5, Npw=2, Nbin=150,
        potential="none", jastrow="none", Rm=1.2,
        n_walkers=n_walkers, dtype="float64", seed=17,
        Nstep=20, Nblock=nblocks, density_map=True)


def dipolar_cfg(n_walkers: int = 1024, nblocks: int = 3) -> SimConfig:
    """The 2-D dipolar Bose gas at N=256 (BASELINE configuration #5):
    potential Cdd/r^3 with the zero-energy dipolar Jastrow, density 0.25,
    the fused bisection sweep (Nb 8, Nlev 2, Nstag 1), float64.  A copy of
    tools/dipolar2d.py's build_cfg (dipolar2d.py:47-63) without its device
    mesh and with use_pallas left on, so that this path runs the kernels;
    build_cfg's use_pallas=False (the plain forms on every device, which
    the port honours: ops/kernels.py) is `.replace(use_pallas=False)`."""
    return SimConfig(
        dim=2, Np=256, density=0.25, trap=False,
        dt=1e-3, Nb=8, sampling="bis", Lstag=8, Nlev=2, Nstag=1,
        CMFreq=1, delta_cm=0.12, Rm=1.0,
        potential="dipolar", jastrow="dipolar2d",
        n_walkers=n_walkers, dtype="float64", seed=11,
        Nstep=5, Nblock=nblocks, Nbin=50, Nk=20)


# the reference's energy unit in Kelvin (system_mod.f90:163)
KELVIN = 1.85505


def he4_rung_cfg(Nb: int, dt: float, n_walkers: int, nstep: int,
                 nblock: int, Np: int = 64, jastrow: str = "mcmillan_c1",
                 seed=None) -> SimConfig:
    """One rung of the He-4 projection-time ladder: the flagship's
    diagonal workload (N=64 at 0.365 sigma^-3, Chin action, bisection
    Nlev=4, Nstag=5, no worm) at Nb beads and time step dt, in SimConfig's
    default sweep (the fused composites), float32.  A copy of
    tools/tau_ladder.rung_cfg (that module imports JAX) with the walker
    count, the block length and Np as arguments; seed defaults to
    1982 + Nb, as there."""
    return SimConfig(
        dim=3, Np=Np, density=0.365, trap=False,
        dt=dt, Nb=Nb, sampling="bis", Lstag=32, Nlev=4, Nstag=5,
        CMFreq=1, delta_cm=0.12, Rm=1.2,
        swapping=False, CWorm=0.0, Nobdm=0, Npw=0,
        n_walkers=n_walkers, dtype="float32", potential="aziz2",
        jastrow=jastrow, Nstep=nstep, Nblock=nblock,
        seed=1982 + Nb if seed is None else seed)


def tail_correction(density: float, rcut: float) -> float:
    """The Aziz-II potential's tail correction per atom in configuration
    units, dV/N = 2 pi rho int_rcut^inf V(r) r^2 dr (g(r) = 1 beyond rcut),
    which the literature's He-4 energies include and the reference does
    not apply.  A copy of tools/tau_ladder.tail_correction on the port's
    own aziz2: to 10 rcut on a 4001-point log grid, the trapezoid rule."""
    import math

    import numpy as np
    import torch

    from .models.potentials import get_potential

    r = np.geomspace(rcut, 10.0 * rcut, 4001)
    vr = get_potential("aziz2").v(torch.from_numpy(r)).numpy()
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return 2.0 * math.pi * density * trapezoid(vr * r * r, r)

