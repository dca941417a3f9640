"""Walker-ensemble Monte Carlo state.

The torch counterpart of pathintegralgroundstate_tpu/state.py: the same
fields, with the threefry key replaced by a device `torch.Generator` (the
moves' tensors) and a host one (the shared window starts), and the step
counter kept on the host.  `state_from_numpy` / `state_to_numpy` carry the
reference MCState's fields across (np.asarray of each), as weight
conversion does for a model port; `generator_states` /
`set_generator_states` carry the generators across a checkpoint.

Layout: paths[W, M, N, D] with M = 2 Nb + 1 beads.

Under walker sharding (a System whose mesh has dp > 1) both constructors
build the global ensemble of cfg.n_walkers walkers, identically on every
rank, and keep this rank's rows (parallel/mesh.shard_state), as the
reference's shard_state assumes every process holds the same global state.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .parallel.mesh import shard_state
from .utils.draws import uniform

_FIELDS = ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm")


@dataclasses.dataclass
class MCState:
    paths: torch.Tensor      # [W, M, N, D]
    xend: torch.Tensor       # [W, 2, D] worm head/tail positions at bead Nb
    isopen: torch.Tensor     # [W] bool off-diagonal (worm) sector
    iworm: torch.Tensor      # [W] long worm particle
    in_cycle: torch.Tensor   # [W, N] bool particles of the current cycle
    iperm: torch.Tensor      # [W] long current cycle length
    step: int                # global MC step counter (host)
    gen: torch.Generator     # device draws
    host_gen: torch.Generator  # host draws (shared window starts)

    @property
    def n_walkers(self) -> int:
        return self.paths.shape[0]


def _generators(system, seed: int):
    gen = torch.Generator(device=system.device)
    gen.manual_seed(seed)
    host = torch.Generator()
    host.manual_seed(seed + 1)
    return gen, host


def init_state(system, seed=None, init_positions=None) -> MCState:
    """Fresh ensemble (vpi_mod.f90:149-259): particles uniform in the box,
    or under the trap uniform in [-a_ho, a_ho] per axis (state.py:60-62),
    or at the given crystal positions init_positions ([N, D], the
    reference's config_ini.in, or [W, N, D] per walker); the one time
    slice replicated to every bead, xend at the last particle's central
    bead.  The generators are seeded either way, so a crystal start draws
    the same moves as a random one."""
    cfg = system.cfg
    W, M, N, D = cfg.n_walkers, cfg.M, cfg.Np, cfg.dim
    gen, host = _generators(system, cfg.seed if seed is None else seed)
    u = uniform((W, N, D), gen, system.device, system.dtype) - 0.5
    if init_positions is not None:
        R = torch.as_tensor(np.asarray(init_positions), dtype=system.dtype,
                            device=system.device).expand(W, N, D)
    else:
        R = 2.0 * system.a_ho * u if cfg.trap else system.L * u
    paths = R[:, None].expand(W, M, N, D).contiguous()
    xend = paths[:, cfg.Nb, N - 1][:, None].expand(W, 2, D).contiguous()
    kw = dict(device=system.device)
    state = MCState(
        paths=paths, xend=xend,
        isopen=torch.zeros(W, dtype=torch.bool, **kw),
        iworm=torch.zeros(W, dtype=torch.long, **kw),
        in_cycle=torch.zeros((W, N), dtype=torch.bool, **kw),
        iperm=torch.ones(W, dtype=torch.long, **kw),
        step=0, gen=gen, host_gen=host)
    return shard_state(system, state)


def host_array(x) -> np.ndarray:
    """x as a numpy array torch can take: a bfloat16 array (JAX's
    ml_dtypes.bfloat16, which torch.from_numpy refuses) as float32, which
    holds every bfloat16 value exactly."""
    a = np.array(x)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of t as numpy; bfloat16 (which numpy lacks) as float32,
    exactly."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def state_from_numpy(system, d: dict, seed=None) -> MCState:
    """MCState from the reference state's fields ({name: array}); the key
    is not carried: the generators are seeded from `seed` (cfg.seed)."""
    kw = dict(device=system.device)
    gen, host = _generators(system, system.cfg.seed if seed is None else seed)
    return shard_state(system, MCState(
        paths=torch.as_tensor(host_array(d["paths"]), dtype=system.dtype,
                              **kw),
        xend=torch.as_tensor(host_array(d["xend"]), dtype=system.dtype, **kw),
        isopen=torch.as_tensor(np.array(d["isopen"]), dtype=torch.bool, **kw),
        iworm=torch.as_tensor(np.array(d["iworm"]), dtype=torch.long, **kw),
        in_cycle=torch.as_tensor(np.array(d["in_cycle"]), dtype=torch.bool,
                                 **kw),
        iperm=torch.as_tensor(np.array(d["iperm"]), dtype=torch.long, **kw),
        step=int(np.asarray(d["step"])), gen=gen, host_gen=host))


def generator_states(state: MCState):
    """(device generator state, host generator state) as uint8 numpy
    arrays, their get_state() bytes: a checkpoint's `gen_state` and
    `host_gen_state`.  A CUDA generator's state is its seed and offset, kept
    on the host, so reading it does not synchronise with the device."""
    return (state.gen.get_state().numpy().copy(),
            state.host_gen.get_state().numpy().copy())


def set_generator_states(state: MCState, gen_state, host_gen_state) -> None:
    """Set both generators of `state` to the states of generator_states."""
    state.gen.set_state(torch.as_tensor(np.asarray(gen_state,
                                                   dtype=np.uint8)))
    state.host_gen.set_state(torch.as_tensor(np.asarray(host_gen_state,
                                                        dtype=np.uint8)))


def state_to_numpy(state: MCState) -> dict:
    """{field: numpy array} of the state, copied (the generators are not
    carried); bfloat16 positions as float32, exactly."""
    out = {k: to_numpy(getattr(state, k)) for k in _FIELDS}
    out["step"] = np.int32(state.step)
    return out
