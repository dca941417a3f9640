"""System bundle: config + geometry + model, with an explicit device/dtype.

The torch counterpart of pathintegralgroundstate_tpu/system.py.  It also
holds the device copies of the host-built constant tables (bridge and
dyadic matrices, Chin weights, index ranges), made once per System so the
Monte Carlo step never copies from the host, and the optional lookup
tables of table mode (`make_tables`).

Its pair functions v, dv, v_dv, u, du and d2u are the one seam every plain
form calls: each takes the table exactly where the reference's
_v_of_r / _dv_of_r / _v_dv_of_r / _u_of_r (pairwise.py:102-128) and
_du_of_r / _d2u_of_r (estimators.py:38-47) take it, and the closed form
otherwise.

A System may carry its rank's place in a dp x tp mesh or an sp ring
(`mesh`, parallel/mesh.Mesh): `tp` is that mesh where it shards the
partner axis, and every kernel route (ops/kernels.py) is then off, as the
reference routes its kernels off under a tp mesh.

The constructor refuses only what no slice ports (a dtype other than
float32 and float64, dim > 3) with NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .config import Geometry, SimConfig, geometry

from .models import jastrow as jas
from .models.potentials import Potential, get_potential
from .utils.interpolate import build_table, interpolate

# enum JasKind in csrc/pigs_pair.cuh
JAS_MCMILLAN, JAS_DIPOLAR, JAS_NONE = 0, 1, 2
_JASTROWS = {"mcmillan": JAS_MCMILLAN, "mcmillan_c1": JAS_MCMILLAN,
             "dipolar2d": JAS_DIPOLAR, "none": JAS_NONE}


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for options the port does not run yet."""
    waits = [
        (cfg.dtype not in ("float32", "float64"), f"dtype={cfg.dtype!r}",
         "no slice (float32 and float64 only)"),
        (cfg.dim > 3, f"dim={cfg.dim}", "no slice (the kernels take D <= 3)"),
    ]
    for bad, what, item in waits:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to torch yet: ROADMAP queue 1, {item}")
    if cfg.jastrow not in _JASTROWS:
        raise ValueError(f"unknown jastrow {cfg.jastrow!r}; known: "
                         f"{sorted(_JASTROWS)}")
    get_potential(cfg.potential)  # KeyError for an unknown name


class Tables(NamedTuple):
    """The optional lookup tables of table mode (vpi_mod.f90:84-145):
    logwf [Nmax+2] the tabulated log-Jastrow, vtab [Nmax+2] the tabulated
    potential; None where the closed form runs."""
    logwf: Optional[torch.Tensor]
    vtab: Optional[torch.Tensor]


@dataclasses.dataclass(eq=False)
class System:
    """The constants of one configuration on one device; built through
    make_system, which refuses what the port does not support."""
    cfg: SimConfig
    geo: Geometry
    device: torch.device
    dtype: torch.dtype
    mesh: Optional[object] = None   # parallel/mesh.Mesh of a sharded run

    def __post_init__(self):
        self.potential: Potential = get_potential(self.cfg.potential)
        kw = dict(dtype=self.dtype, device=self.device)
        self.L = torch.tensor(self.geo.Lbox, **kw)
        self.half = 0.5 * self.L
        rc = self.geo.rcut
        Rm = self.cfg.Rm
        self.jas_kind = _JASTROWS[self.cfg.jastrow]
        # the C1 shift's constants, in Python floats as the reference folds
        # them: the kernels' parameters
        self.c1 = jas.c1_shifted(self.cfg.jastrow, self.pbc)
        self.u_rc = self.du_rc = 0.0
        if self.c1:
            u0, du0, _ = jas.FAMILIES[self.cfg.jastrow]
            self.u_rc, self.du_rc = u0(Rm, rc), du0(Rm, rc)
        # the trap lengths [D], read by the one-body terms
        self.a_ho = (torch.tensor(self.cfg.a_ho, **kw) if self.cfg.trap
                     else None)
        self._consts: dict = {}
        self.tables: Tables = make_tables(self)

    @property
    def M(self) -> int:
        return self.cfg.M

    @property
    def pbc(self) -> bool:
        return not self.cfg.trap

    @property
    def tp(self):
        """The mesh where it shards the partner axis (tp > 1), else None."""
        return self.mesh if self.mesh is not None and self.mesh.tp > 1 \
            else None

    # -- the closed forms ----------------------------------------------------

    def u_closed(self, r):
        """Two-body log-Jastrow in closed form (models/jastrow.two_body_u):
        'mcmillan' bare, 'mcmillan_c1' and 'dipolar2d' C1-matched at rcut
        under PBC, 'none' u = 0 (the ideal gas)."""
        return jas.two_body_u(self.cfg.jastrow, self.cfg.Rm, r,
                              self.geo.rcut, self.pbc)

    def du_closed(self, r):
        return jas.two_body_du(self.cfg.jastrow, self.cfg.Rm, r,
                               self.geo.rcut, self.pbc)

    def d2u_closed(self, r):
        """u'' (never shifted)."""
        return jas.two_body_d2u(self.cfg.jastrow, self.cfg.Rm, r)

    # -- the pair functions of the plain forms --------------------------------

    def v(self, r):
        """V(r): the table under v_table, else the closed form."""
        if self.tables.vtab is not None:
            return interpolate(0, self.geo.dr, self.tables.vtab, r)
        return self.potential.v(r)

    def dv(self, r):
        """dV/dr(r): the table's first difference under v_table."""
        if self.tables.vtab is not None:
            return interpolate(1, self.geo.dr, self.tables.vtab, r)
        return self.potential.dvdr(r)

    def v_dv(self, r, rinv=None):
        """(V, dV/dr): the table under v_table, else the fused closed form
        (Aziz from r and 1/r, the others from r alone)."""
        if self.tables.vtab is not None:
            return self.v(r), self.dv(r)
        return self.potential.v_dv(r, rinv)

    def u(self, r):
        """u(r): the table under wf_table, else u_closed."""
        if self.tables.logwf is not None:
            return interpolate(0, self.geo.dr, self.tables.logwf, r)
        return self.u_closed(r)

    def du(self, r):
        if self.tables.logwf is not None:
            return interpolate(1, self.geo.dr, self.tables.logwf, r)
        return self.du_closed(r)

    def d2u(self, r):
        if self.tables.logwf is not None:
            return interpolate(2, self.geo.dr, self.tables.logwf, r)
        return self.d2u_closed(r)

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


def make_tables(system: System) -> Tables:
    """The optional tables on the reference grid (system.py:124-137):
    JastrowTable and PotentialTable (vpi_mod.f90:84-145), Nmax points on
    [0, rcut] with ghost cells at both ends, tabulated in the System's
    dtype on its device."""
    cfg, geo = system.cfg, system.geo
    logwf = vtab = None
    if cfg.wf_table:
        logwf, _ = build_table(system.u_closed, geo.rcut, cfg.Nmax,
                               system.dtype, system.device)
    if cfg.v_table:
        vtab, _ = build_table(system.potential.v, geo.rcut, cfg.Nmax,
                              system.dtype, system.device)
    return Tables(logwf=logwf, vtab=vtab)


def make_system(cfg: SimConfig, device=None, dtype=None, mesh=None) -> System:
    """System on `device` in `dtype` (default cfg.dtype).

    The default device is the card ("cuda"); without one it raises rather
    than run on the CPU.  device="cpu" runs the plain forms.  mesh: this
    rank's parallel/mesh.Mesh in a sharded run (the Driver builds it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_system: no CUDA device is present; pass "
                               "device='cpu' to run the plain forms on the "
                               "CPU")
        device = "cuda"
    check_supported(cfg)   # before geometry(), which needs crystal_Lbox
    device = torch.device(device)
    dtype = dtype or getattr(torch, cfg.dtype)
    return System(cfg=cfg, geo=geometry(cfg), device=device, dtype=dtype,
                  mesh=mesh)
