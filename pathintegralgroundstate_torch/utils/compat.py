"""Reference-format I/O: migrate to and from the Fortran code's files.

The torch port's copy of pathintegralgroundstate_tpu/utils/compat.py.  The
reference checkpoints to a text `checkpoint.dat` (CheckPoint,
vpi_mod.f90:263-309): the trap and isopen flags, the worm particle index,
the whole worldline Path(dim, Np, 0:2*Nb) (particle-major, bead-minor) and
the two worm ends.  These readers and writers let a reference user resume
a run in the port (the one configuration seeds every walker of the
ensemble) and export any walker back into a file the reference can resume
from.
"""

from __future__ import annotations

import numpy as np
import torch

from ..state import MCState, _generators, to_numpy


def _parse_logical(tok: str) -> bool:
    return tok.strip().lower() in (".true.", "t", "true")


def read_reference_checkpoint(path: str) -> dict:
    """Parse a reference checkpoint.dat: dict(trap, isopen, iworm (0-based),
    body [Np*(2Nb+1), dim] in the file's particle-major order, xend [2,
    dim], dim).  The file stores Path particle-major ((ip, ib) loops,
    vpi_mod.f90:289-295) with a 1-based iworm."""
    with open(path) as f:
        lines = [ln for ln in f.read().split("\n") if ln.strip()]
    trap = _parse_logical(lines[0])
    isopen = _parse_logical(lines[1])
    iworm = int(lines[2]) - 1
    rows = [np.array([float(x) for x in ln.split()]) for ln in lines[3:]]
    rows = [r for r in rows if r.size]
    return dict(trap=trap, isopen=isopen, iworm=max(iworm, 0),
                body=np.stack(rows[:-2]), xend=np.stack(rows[-2:]),
                dim=rows[0].size)


def reference_checkpoint_to_state(system, path: str, seed=None) -> MCState:
    """A whole walker ensemble on the System's device from a reference
    checkpoint.dat: every walker starts from the reference's configuration
    (they decorrelate over the first blocks, as in the reference's own
    resume); the generators are seeded from `seed` (default cfg.seed)."""
    cfg = system.cfg
    raw = read_reference_checkpoint(path)
    M, N, D, W = cfg.M, cfg.Np, cfg.dim, cfg.n_walkers
    if raw["body"].shape != (N * M, D):
        raise ValueError(
            f"checkpoint shape {raw['body'].shape} does not match "
            f"Np={N}, M={M}, dim={D}")
    # particle-major [N, M, D] -> bead-major [M, N, D]
    path_arr = raw["body"].reshape(N, M, D).transpose(1, 0, 2)
    kw = dict(device=system.device)
    paths = torch.as_tensor(path_arr, dtype=system.dtype, **kw)
    xend = torch.as_tensor(raw["xend"], dtype=system.dtype, **kw)
    gen, host = _generators(system, cfg.seed if seed is None else seed)
    return MCState(
        paths=paths.expand(W, M, N, D).contiguous(),
        xend=xend.expand(W, 2, D).contiguous(),
        isopen=torch.full((W,), raw["isopen"], dtype=torch.bool, **kw),
        iworm=torch.full((W,), raw["iworm"], dtype=torch.long, **kw),
        in_cycle=torch.zeros((W, N), dtype=torch.bool, **kw),
        iperm=torch.ones(W, dtype=torch.long, **kw),
        step=0, gen=gen, host_gen=host)


def write_reference_checkpoint(system, state: MCState, path: str,
                               walker: int = 0) -> None:
    """Export one walker in the reference's checkpoint.dat layout
    (CheckPoint, vpi_mod.f90:273-304), so the Fortran code can resume from
    it."""
    cfg = system.cfg
    p = to_numpy(state.paths[walker])                     # [M, N, D]
    xend = to_numpy(state.xend[walker])
    isopen = bool(state.isopen[walker])
    iworm = int(state.iworm[walker]) + 1
    with open(path, "w") as f:
        f.write(" .True.\n" if cfg.trap else " .False.\n")
        f.write(" .True.\n" if isopen else " .False.\n")
        f.write(f" {iworm}\n")
        for ip in range(cfg.Np):
            for ib in range(cfg.M):
                f.write(" " + " ".join(f"{x: .17E}" for x in p[ib, ip]) + "\n")
        f.write("\n\n")
        for j in range(2):
            f.write(" " + " ".join(f"{x: .17E}" for x in xend[j]) + "\n")
