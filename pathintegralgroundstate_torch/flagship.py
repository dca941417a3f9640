"""The port's named configurations: the flagship workload (He-4, N=64,
Chin action; the reference's vpi.in), the trapped worm flagship
(tools/trap_worm.py's ideal bosons in a 2-D trap) and the 2-D dipolar Bose
gas (tools/dipolar2d.py, BASELINE configuration #5)."""

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
    mesh; the reference's use_pallas=False exists for that mesh's
    tensor-parallel axis, and the port routes by physics."""
    return SimConfig(
        dim=2, Np=256, density=0.25, trap=False,
        dt=1e-3, Nb=8, sampling="bis", Lstag=8, Nlev=2, Nstag=1,
        CMFreq=1, delta_cm=0.12, Rm=1.0,
        potential="dipolar", jastrow="dipolar2d",
        n_walkers=n_walkers, dtype="float64", seed=11,
        Nstep=5, Nblock=nblocks, Nbin=50, Nk=20)
