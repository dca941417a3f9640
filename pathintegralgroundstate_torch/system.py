"""System bundle: config + geometry + model, with an explicit device/dtype.

The torch counterpart of pathintegralgroundstate_tpu/system.py.  It also
holds the device copies of the host-built constant tables (bridge and
dyadic matrices, Chin weights, index ranges), made once per System so the
Monte Carlo step never copies from the host.

The constructor refuses every configuration outside the ported slice with
NotImplementedError naming the ROADMAP item it waits for.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Geometry, SimConfig, geometry

from .models import jastrow as jas
from .models.potentials import Potential, get_potential

_JASTROWS = ("mcmillan", "mcmillan_c1", "none")


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for options the port does not run yet."""
    waits = [
        (not cfg.shared_windows, "shared_windows=False",
         "slice 11 (per-walker windows)"),
        (cfg.v_table or cfg.wf_table, "v_table/wf_table",
         "slice 2 (table mode)"),
        (max(cfg.mesh_walkers, cfg.mesh_pairs, cfg.mesh_beads) > 1,
         "mesh_*>1", "slice 14 (multi-device)"),
        (cfg.distributed, "distributed=True", "slice 14 (multi-device)"),
        (cfg.crystal, "crystal=True",
         "slice 12 (item 10: the crystal start and config_ini.in)"),
        (cfg.jastrow not in _JASTROWS, f"jastrow={cfg.jastrow!r}",
         "slice 12 (geometry and model variants)"),
        # the kernels' pair chain is Aziz and McMillan (csrc/pigs_pair.cuh):
        # the ideal-gas forms run only where the trap routes the plain forms
        (not cfg.trap and "none" in (cfg.potential, cfg.jastrow),
         f"potential={cfg.potential!r}, jastrow={cfg.jastrow!r} under PBC",
         "slice 12 (item 10: the kernels' pair-chain selector)"),
        (cfg.dtype not in ("float32", "float64"), f"dtype={cfg.dtype!r}",
         "no slice (float32 and float64 only)"),
        (cfg.dim > 3, f"dim={cfg.dim}", "no slice (the kernels take D <= 3)"),
    ]
    for bad, what, item in waits:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to torch yet: ROADMAP queue 1, {item}")
    get_potential(cfg.potential)  # raises for all but aziz2, aziz1, none


@dataclasses.dataclass(eq=False)
class System:
    """The constants of one configuration on one device; built through
    make_system, which refuses what the port does not support."""
    cfg: SimConfig
    geo: Geometry
    device: torch.device
    dtype: torch.dtype

    def __post_init__(self):
        self.potential: Potential = get_potential(self.cfg.potential)
        kw = dict(dtype=self.dtype, device=self.device)
        self.L = torch.tensor(self.geo.Lbox, **kw)
        self.half = 0.5 * self.L
        rc = self.geo.rcut
        Rm = self.cfg.Rm
        # the C1 shift applies under PBC only (system.py:93, 108); its
        # constants in Python floats, as the reference folds them
        self.c1 = self.cfg.jastrow == "mcmillan_c1" and self.pbc
        self.u_rc = jas.mcmillan_u(Rm, rc) if self.c1 else 0.0
        self.du_rc = jas.mcmillan_du(Rm, rc) if self.c1 else 0.0
        # the trap lengths [D], read by the one-body terms
        self.a_ho = (torch.tensor(self.cfg.a_ho, **kw) if self.cfg.trap
                     else None)
        self._consts: dict = {}

    @property
    def M(self) -> int:
        return self.cfg.M

    @property
    def pbc(self) -> bool:
        return not self.cfg.trap

    def u(self, r):
        """Two-body log-Jastrow; 'mcmillan_c1' is C1-matched at rcut under
        PBC, 'none' is u = 0 (the ideal gas)."""
        if self.cfg.jastrow == "none":
            return torch.zeros_like(r)
        u = jas.mcmillan_u(self.cfg.Rm, r)
        if self.c1:
            u = u - self.u_rc - self.du_rc * (r - self.geo.rcut)
        return u

    def du(self, r):
        if self.cfg.jastrow == "none":
            return torch.zeros_like(r)
        du = jas.mcmillan_du(self.cfg.Rm, r)
        if self.c1:
            du = du - self.du_rc
        return du

    def d2u(self, r):
        if self.cfg.jastrow == "none":
            return torch.zeros_like(r)
        return jas.mcmillan_d2u(self.cfg.Rm, r)

    # -- device constants ----------------------------------------------------

    def const(self, key, make, dtype=None):
        """Device copy of the numpy array make(), built once per key."""
        t = self._consts.get(key)
        if t is None:
            t = torch.as_tensor(np.asarray(make()), device=self.device,
                                dtype=dtype or self.dtype)
            self._consts[key] = t
        return t

    def arange(self, lo: int, hi: int = None, step: int = 1):
        """Cached device index range (torch.long)."""
        if hi is None:
            lo, hi = 0, lo
        return self.const(("arange", lo, hi, step),
                          lambda: np.arange(lo, hi, step), torch.long)


def make_system(cfg: SimConfig, device=None, dtype=None) -> System:
    """System on `device` in `dtype` (default cfg.dtype).

    The default device is the card ("cuda"); without one it raises rather
    than run on the CPU.  device="cpu" runs the plain forms."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_system: no CUDA device is present; pass "
                               "device='cpu' to run the plain forms on the "
                               "CPU")
        device = "cuda"
    check_supported(cfg)   # before geometry(), which needs crystal_Lbox
    device = torch.device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    return System(cfg=cfg, geo=geometry(cfg), device=device, dtype=dtype)
