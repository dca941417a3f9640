"""The flagship workload: He-4, N=64, Chin action (the reference's vpi.in)."""

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
