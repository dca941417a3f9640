"""Simulation configuration of the PyTorch port.

A copy of the reference's configuration module
(pathintegralgroundstate_tpu/config.py), unchanged in behaviour, so that
the port imports nothing of the JAX package.  tests/test_torch_config.py
holds the two equal: the same fields and defaults in the same order, the
same geometry and the same namelist parsing.

Mirrors every key of the reference's Fortran namelists 1:1
(`/system/ /samp/ /obdm/ /wavefun/` at vpi_mod.f90:28-32 with defaults at
vpi_mod.f90:39-61; `/jastrow/ /extpot/` at system_mod.f90:21-22) and adds the
TPU-native extension keys (walker-ensemble size, mesh shape, dtype, kernel
selection).  `load_namelist_config` parses the reference's own `vpi.in`
input files directly, so existing reference configurations run unchanged.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full simulation configuration (hashable => usable as a jit static arg).

    Reference-namelist keys keep the reference's spelling and defaults
    (vpi_mod.f90:39-61, vpi.in:1-37).
    """

    # --- /system/ ---
    dim: int = 3
    Np: int = 64
    density: float = 0.365
    crystal: bool = False
    trap: bool = False

    # --- /samp/ ---
    resume: bool = False
    dt: float = 5.0e-3
    Nb: int = 32
    seed: int = 1982
    delta_cm: float = 0.12
    CMFreq: int = 1
    sampling: str = "bis"  # "sta" (staging) or "bis" (bisection)
    Lstag: int = 2
    Nlev: int = 1
    Nstag: int = 1
    Nblock: int = 10
    Nstep: int = 100
    Nbin: int = 100
    Nk: int = 50

    # --- /obdm/ ---
    swapping: bool = False
    CWorm: float = 0.0
    Nobdm: int = 0
    Npw: int = 0

    # --- /wavefun/ ---
    Nmax: int = 10000
    wf_table: bool = False
    v_table: bool = False

    # --- /jastrow/ ---
    Rm: float = 1.20

    # --- /extpot/ (harmonic trap lengths, one per dimension) ---
    a_ho: Tuple[float, ...] = ()

    # --- crystal start (config_ini.in replacement; vpi.f90:101-107) ---
    crystal_Lbox: Tuple[float, ...] = ()
    crystal_positions_file: str = "config_ini.in"

    # --- TPU-native extensions (absent in the reference) ---
    n_walkers: int = 64          # W: walker-ensemble size (ref: 1, vpi.f90:134)
    dtype: str = "float32"       # compute dtype on device ("float64" for CPU parity)
    potential: str = "aziz2"     # aziz2 | aziz1 | soft | dipolar | none
    use_pallas: bool = True      # fused Pallas pair_pot kernel for the
                                 # O(N^2 M) estimator sweeps (auto-gated:
                                 # TPU backend + PBC + closed forms; falls
                                 # back to the bead-chunked jnp path)
    pallas_rows: bool = False    # Pallas rows kernel for the MOVE deltas.
                                 # Off by default: re-measured SLOWER than
                                 # the fused jnp window pass in round 5
                                 # for every layout tried — [rows, N]
                                 # channel-split planes (2x window copies),
                                 # [TR, D, N] blocks (5.3x VMEM padding),
                                 # and [TR, D*N] with one transpose (the
                                 # (N, D)-minor layout cannot feed
                                 # lane-major tiles without a relayout;
                                 # docs/VALIDATION.md round-5 levers)
    mesh_walkers: int = 1        # data-parallel shards of the walker axis
    mesh_pairs: int = 1          # tensor-parallel shards of the pair/partner
                                 # axis: >1 annotates the pair kernels'
                                 # partner-axis intermediates onto the mesh's
                                 # 'tp' axis (GSPMD partitions the O(Np)
                                 # partner loops + O(Np^2) pair sums with
                                 # psum collectives); requires Np % tp == 0,
                                 # disables the Pallas pair kernels, and is
                                 # worthwhile for large Np (>= ~256)
    mesh_beads: int = 1          # sequence-parallel shards of the BEAD
                                 # (imaginary-time) axis (SURVEY.md §2.3 SP
                                 # row): >1 routes the interior staging
                                 # sweep through the ppermute ring-halo
                                 # kernel (parallel/beadshard), regrowing
                                 # one window PER SHARD per call (a valid
                                 # product kernel).  STATUS (round 4):
                                 # kept as a bitwise-tested CORRECTNESS
                                 # DEMO of the ring-halo pattern and
                                 # formally DESCOPED as a production mode
                                 # — walker DP dominates at every
                                 # practically reachable M (measured
                                 # M=257: 62% of the M=65 single-chip
                                 # rate, zero comm; the bead axis fits
                                 # one chip to M ~ 16k; see
                                 # docs/VALIDATION.md).  Requires
                                 # sampling='sta', CWorm=0, exact_f2=F,
                                 # mesh_walkers=mesh_pairs=1, (M-1) %
                                 # mesh_beads == 0 with even per-shard
                                 # bead counts
    distributed: bool = False    # call jax.distributed.initialize() (multi-host)
    debug: bool = False          # debug mode: jax_debug_nans, per-step
                                 # dispatch (NaNs localize to one MC step),
                                 # acceptance-collapse alarm; optionally
                                 # PIGS_DISABLE_JIT=1 for eager execution
    jastrow: str = "mcmillan"    # trial-wavefunction family
    regrow: str = "bridge"       # staging reconstruction: "bridge" (one
                                 # Brownian-bridge matmul, TPU fast path) or
                                 # "scan" (the reference's sequential
                                 # recursion; same distribution, for parity)
    measure_every: int = 1       # estimator stride (1 = reference behaviour)
    density_map: bool = False    # accumulate the 2-D (x, y) density map
                                 # (DensityProfile/PrintDensity,
                                 # sample_mod.f90:598-652 — commented out
                                 # in the reference, first-class here);
                                 # writes density_vpi.out
    smart_mc: float = 0.0        # MALA step size eps (>0 adds one gradient-
                                 # drifted whole-path move per step to
                                 # diagonal walkers; see ops/smartmc.py)
    fused_sweep: bool = True     # composite diagonal sweep: head+tail
                                 # bisections merged per particle and K
                                 # disjoint interior windows moved at once
                                 # (ops/bisection.py fused kernels; ~2-3x
                                 # fewer sequential launches; False = the
                                 # reference's per-particle move order)
    end_regrow: str = "bis"      # fused end-move family: "bis" = per-level
                                 # bisection (reference-like multilevel
                                 # filter), "sta" = one-shot staging bridge
                                 # (fewest sequential kernels; same proposal
                                 # distribution at full window)
    exact_f2: bool = False       # exact Chin F^2 in move acceptances (the
                                 # reference tracks only the moved particle's
                                 # |F_ip|^2, vpi_mod.f90:2825 — a
                                 # non-conservative Delta-S that distorts the
                                 # sampled measure; see ops/pairwise.delta_pot
                                 # and docs/VALIDATION.md)
    f2_cache: bool = True        # with exact_f2: maintain the per-step
                                 # ODD-BEAD force-field cache (the only
                                 # beads whose F^2 carries Chin weight) so
                                 # EVERY move — diagonal, fused, and worm —
                                 # gets exact F^2 at O(N) per displaced
                                 # bead (delta_pot_cached semantics);
                                 # False = brute-force O(N^2) field
                                 # differences everywhere (validation path)
    shared_windows: bool = True  # one window offset per move site shared by
                                 # all walkers (exact kernel mixture, ~10x
                                 # faster; see ops.moves._window_start).
                                 # False: per-walker offsets.
    bis_end_random_depth: bool = False  # reference-style random end-bisection
                                        # depths (compiles one body per depth)
    paired_ends: bool = False    # compute head+tail end moves from the
                                 # same pre-move paths and apply both
                                 # writebacks together (bitwise-identical;
                                 # ops/bisection.paired_end_bisections).
                                 # Off: measured a wash at best-W and an
                                 # 8% loss at W=4096 (deferred writeback
                                 # breaks XLA's in-place aliasing)
    bis_monoshot: bool = True    # one-dispatch bisection moves: the level
                                 # chain's construction is deterministic
                                 # given the draws and the accepts
                                 # factorize, so ALL levels' pair deltas
                                 # evaluate in ONE fused kernel per move
                                 # instead of one per level (ops/bisection
                                 # monoshot note; ~nlev+1 -> 1 sequential
                                 # pair kernels per move).  False = the
                                 # per-level dispatch form (identical
                                 # kernel semantics, for comparison)
    cascade: bool = False        # experimental whole-move Pallas cascade
                                 # kernels (ops/cascade_kernels): the full
                                 # bisection cascade in ONE kernel.  Kept
                                 # off by default — VMEM limits force tiny
                                 # walker tiles and the measured flagship
                                 # step is ~2x SLOWER than the fused rows-
                                 # kernel composites (docs/VALIDATION.md)

    def __post_init__(self):
        if self.sampling not in ("sta", "bis"):
            raise ValueError(f"sampling must be 'sta' or 'bis', got {self.sampling!r}")
        if self.trap and len(self.a_ho) not in (0, self.dim):
            raise ValueError("a_ho must have one entry per dimension")
        if self.trap and not self.a_ho:
            object.__setattr__(self, "a_ho", tuple(1.0 for _ in range(self.dim)))

    @property
    def M(self) -> int:
        """Number of beads along the open worldline (reference: 0:2*Nb)."""
        return 2 * self.Nb + 1

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Derived geometry, computed exactly as the reference driver does.

    PBC branch: vpi.f90:97-128.  Trap branch: vpi.f90:82-94.
    All fields are plain floats/tuples so Geometry is hashable and can be
    closed over / passed statically into jit-compiled kernels.
    """

    Lbox: Tuple[float, ...]
    LboxHalf: Tuple[float, ...]
    qbin: Tuple[float, ...]
    rcut: float
    rcut2: float
    rbin: float
    dr: float          # table grid spacing (vpi_mod.f90:94: rcut/(Nmax-1))
    delta_cm: float    # CM step after density scaling (vpi.f90:93,123)
    density: float     # effective density (trap branch recomputes it, vpi.f90:90)


def geometry(cfg: SimConfig) -> Geometry:
    """Reproduce the reference's geometry setup (vpi.f90:80-128)."""
    d = cfg.dim
    if cfg.trap:
        # vpi.f90:82-94 (note: density uses the *product* rcut before the
        # d-th root is taken — reproduced verbatim).
        rcut = 1.0
        for k in range(d):
            rcut = 3.0 * rcut * cfg.a_ho[k]
        density = cfg.Np / (math.pi ** (0.5 * d) * rcut / math.gamma(0.5 * d + 1.0))
        rcut = rcut ** (1.0 / d)
        rcut = 10.0 * rcut
        delta_cm = cfg.delta_cm * min(cfg.a_ho)
        Lbox = tuple(0.0 for _ in range(d))  # unused under trap
        qbin = tuple(0.0 for _ in range(d))
        LboxHalf = tuple(0.0 for _ in range(d))
    else:
        if cfg.crystal:
            if len(cfg.crystal_Lbox) != d:
                raise ValueError("crystal=True requires crystal_Lbox (per-dim box)")
            Lbox = tuple(cfg.crystal_Lbox)
            density = cfg.density
        else:
            L = (cfg.Np / cfg.density) ** (1.0 / d)  # vpi.f90:112
            Lbox = tuple(L for _ in range(d))
            density = cfg.density
        LboxHalf = tuple(0.5 * L for L in Lbox)
        qbin = tuple(2.0 * math.pi / L for L in Lbox)
        rcut = min(LboxHalf)                      # vpi.f90:122
        delta_cm = cfg.delta_cm / density ** (1.0 / d)  # vpi.f90:123

    rcut2 = rcut * rcut
    rbin = rcut / cfg.Nbin                        # vpi.f90:128
    dr = rcut / (cfg.Nmax - 1)                    # vpi_mod.f90:94
    return Geometry(
        Lbox=Lbox, LboxHalf=LboxHalf, qbin=qbin,
        rcut=rcut, rcut2=rcut2, rbin=rbin, dr=dr,
        delta_cm=delta_cm, density=density,
    )


# ---------------------------------------------------------------------------
# Fortran-namelist parsing — accepts the reference's vpi.in unchanged.
# ---------------------------------------------------------------------------

_NML_GROUP = re.compile(r"&(\w+)(.*?)(?:^|\s)/", re.S | re.M)
_NML_ITEM = re.compile(r"(\w+)\s*=\s*([^=]+?)(?=(?:,?\s*\w+\s*=)|\Z)", re.S)


def _parse_fortran_literal(tok: str):
    tok = tok.strip().rstrip(",").strip()
    if not tok:
        return None
    low = tok.lower()
    if low in ("t", ".true.", "true"):
        return True
    if low in ("f", ".false.", "false"):
        return False
    if (tok[0] == tok[-1]) and tok[0] in "'\"" and len(tok) >= 2:
        return tok[1:-1]
    num = low.replace("d", "e")
    try:
        if re.fullmatch(r"[+-]?\d+", num):
            return int(num)
        return float(num)
    except ValueError:
        return tok


def parse_namelists(text: str) -> dict:
    """Parse Fortran namelist groups into {group: {key: value}}.

    Handles the reference's comment style (`! ...`), `T`/`F` logicals,
    `5.00d-3` doubles, quoted strings, and comma-separated arrays.
    """
    # strip comments (anything after ! on a line)
    text = "\n".join(line.split("!")[0] for line in text.splitlines())
    groups: dict = {}
    for m in _NML_GROUP.finditer(text):
        name = m.group(1).lower()
        body = m.group(2)
        entries: dict = {}
        for im in _NML_ITEM.finditer(body):
            key = im.group(1)
            raw = im.group(2).strip().rstrip(",")
            parts = [p for p in (s.strip() for s in raw.split(",")) if p]
            vals = [_parse_fortran_literal(p) for p in parts]
            entries[key] = vals[0] if len(vals) == 1 else tuple(vals)
        groups.setdefault(name, {}).update(entries)
    return groups


def read_crystal_file(path: str):
    """Read the reference's `config_ini.in` crystal-start file
    (vpi.f90:101-107 + vpi_mod.f90:218-228): Np / Lbox / density header,
    then Np position rows.  Returns (Np, Lbox tuple, density, R[Np, dim])."""
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    Np = int(float(lines[0].split()[0]))
    Lbox = tuple(float(x) for x in lines[1].split())
    density = float(lines[2].split()[0])
    import numpy as _np
    R = _np.array([[float(x) for x in ln.split()] for ln in lines[3:3 + Np]])
    return Np, Lbox, density, R


def load_namelist_config(path_or_text: str, is_text: bool = False, **overrides) -> SimConfig:
    """Build a SimConfig from a reference-format namelist file (e.g. vpi.in).

    Extra keyword arguments override/extend parsed values (this is where the
    TPU-native keys such as n_walkers are usually supplied).
    """
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    groups = parse_namelists(text)
    known = {f.name for f in dataclasses.fields(SimConfig)}
    kw: dict = {}
    for grp in ("system", "samp", "obdm", "wavefun", "jastrow", "extpot", "tpu"):
        for key, val in groups.get(grp, {}).items():
            if key in known:
                if key == "a_ho" and not isinstance(val, tuple):
                    val = (val,)
                kw[key] = val
    kw.update(overrides)
    if kw.get("trap") and isinstance(kw.get("a_ho"), tuple):
        d = kw.get("dim", 3)
        if len(kw["a_ho"]) == 1 and d > 1:
            kw["a_ho"] = tuple(kw["a_ho"][0] for _ in range(d))
    return SimConfig(**kw)


# ---------------------------------------------------------------------------
# Startup namelist echo (vpi_mod.f90:64-75: every namelist is read and then
# written back to stdout via `write (*,nml=...)`).
# ---------------------------------------------------------------------------

_NML_GROUPS = (
    ("system", ("dim", "Np", "density", "crystal", "trap")),
    ("samp", ("resume", "dt", "Nb", "seed", "delta_cm", "CMFreq", "sampling",
              "Lstag", "Nlev", "Nstag", "Nblock", "Nstep", "Nbin", "Nk")),
    ("obdm", ("swapping", "CWorm", "Nobdm", "Npw")),
    ("wavefun", ("Nmax", "wf_table", "v_table")),
    ("jastrow", ("Rm",)),
    ("extpot", ("a_ho",)),
    # TPU-native extension keys (no reference analogue)
    ("tpu", ("n_walkers", "dtype", "potential", "jastrow", "mesh_walkers",
             "mesh_pairs", "mesh_beads", "distributed", "exact_f2",
             "f2_cache", "fused_sweep", "sampling", "regrow", "smart_mc",
             "use_pallas", "measure_every", "density_map",
             "bis_monoshot")),
)


def _nml_repr(v) -> str:
    if isinstance(v, bool):
        return "T" if v else "F"
    if isinstance(v, tuple):
        return ", ".join(_nml_repr(x) for x in v) if v else ""
    if isinstance(v, str):
        return f'"{v}"'
    return repr(v)


def echo_namelists(cfg: SimConfig, write=print) -> None:
    """Echo every configuration group in Fortran namelist-output style,
    making run provenance self-contained in the console log exactly like
    the reference's `write (*,nml=...)` (vpi_mod.f90:64-75)."""
    for group, keys in _NML_GROUPS:
        write(f"&{group.upper()}")
        for k in keys:
            v = getattr(cfg, k)
            write(f" {k.upper()}={_nml_repr(v)},")
        write(" /")


def namelist_text(cfg: SimConfig) -> str:
    """cfg's groups of _NML_GROUPS as namelist input (vpi.in's format), which
    load_namelist_config reads back to cfg where cfg differs from the
    defaults only in those keys.  Empty a_ho is left out."""
    out = []
    for group, keys in _NML_GROUPS:
        items = [f"{k} = {_nml_repr(getattr(cfg, k))}" for k in keys
                 if getattr(cfg, k) != ()]
        out.append(f"&{group}\n " + ", ".join(items) + " /\n")
    return "".join(out)
