"""Walker (dp), partner (tp) and bead (sp) sharding over torch.distributed.

The torch counterpart of pathintegralgroundstate_tpu/parallel/mesh.py, of
the reference's tensor-parallel pair annotation
(ops/pairwise._tp_constrain) and of the exchanges of its sp mesh
(parallel/beadshard.py).  One process per mesh position:

  * the world of dp * tp ranks is laid out as the reference lays out its
    devices (make_mesh's reshape(n_dp, n_tp)): rank = dp index * tp + tp
    index.  Each rank runs on `cuda:(LOCAL_RANK % device_count)`, or on
    the CPU where the caller asks for it;
  * dp: each rank owns W/dp walkers, the rows dp_index * W/dp onwards of
    the global ensemble (`shard_state`).  Every rank draws each random
    block for all W walkers and keeps its rows (utils/draws.py), so a
    sharded run draws the numbers of the unsharded run of the same seed.
    The block statistics are sums over walkers: `reduce_stats` all-reduces
    them (SUM) over the dp group once per block, and every rank then holds
    the replicated statistics, as the reference's replicated stats_sh;
  * tp: every rank of a tp group holds the same walkers, all N particles
    of their paths, and takes the same accept decisions.  The plain pair
    forms (ops/kernels.py, ops/pairwise.py) evaluate this rank's N/tp
    partners (`partners`) and all-reduce the partial sums over the tp group
    (`tp_sum`) before the Metropolis test; under tp every pair call takes
    the plain forms, as the reference routes its Pallas kernels off under
    a tp mesh;
  * sp (mesh_beads, alone: dp = tp = 1): rank k owns the bead shard k of
    the SP staging sweep (parallel/beadshard.py).  The state stays
    replicated; each sweep call takes its halo from the next rank around
    the ring (`ring_next`) and gathers every shard's moved beads
    (`gather`).

The backend is NCCL when every rank has a card of its own and gloo when
ranks share a card (NCCL refuses two ranks on one GPU) or run on the CPU:
a route by layout (`pick_backend`).  Every collective but the ring is an
all-reduce, which both backends take on CUDA tensors (gloo stages them
through the host inside the call); the checkpoint's gather and the sp
gather are padded all-reduces for the same reason.  The ring is
point-to-point: on the tensor's device under NCCL and for CPU tensors,
staged through the host under gloo with CUDA tensors (gloo's send and recv
take CPU tensors only).  Each rank counts its collectives and the
seconds spent inside them (`collectives`, `coll_s`): on the card the time
between CUDA events recorded on the current stream just before and just
after each call, which spans the collective under either backend (NCCL's
kernel; gloo's staging through the host and its exchange, during which the
stream waits), and not the card's queued work ahead of it; on the CPU the
host clock around the call, which returns when the sum is done.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time

import torch
import torch.distributed as dist


def local_device(device=None):
    """The rank's device: `device` where given, else the card
    cuda:(LOCAL_RANK % device_count)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is present; pass device='cpu' to "
                           "run the mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def pick_backend(device) -> str:
    """'nccl' when every rank of this node has a card of its own, else
    'gloo' (ranks sharing a card, or the CPU)."""
    device = torch.device(device)
    if device.type != "cuda":
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def init_from_env(device=None) -> str:
    """dist.init_process_group from torchrun's standard environment
    (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; LOCAL_RANK picks the
    card), unless a group already exists.  Returns the backend."""
    if dist.is_initialized():
        return dist.get_backend()
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                           "WORLD_SIZE") if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"distributed=True needs torchrun's environment; {missing} are "
            "not set.  Run it as: torchrun --nproc-per-node K -m "
            "pathintegralgroundstate_torch in.in --set mesh_walkers=K")
    device = local_device(device)
    backend = pick_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://")
    return backend


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's place in the dp x tp mesh and its two process groups, or
    in the sp ring (sp > 1, dp = tp = 1, the default group)."""
    dp: int
    tp: int
    rank: int
    backend: str
    dp_group: object = None
    tp_group: object = None
    sp: int = 1
    collectives: int = 0      # collectives this rank issued
    _done_s: float = 0.0      # seconds inside them, read so far
    _events: list = dataclasses.field(default_factory=list)

    @property
    def dp_rank(self) -> int:
        return self.rank // (self.sp * self.tp)

    @property
    def tp_rank(self) -> int:
        return self.rank // self.sp % self.tp

    @property
    def sp_rank(self) -> int:
        return self.rank % self.sp

    def walkers(self, W: int) -> slice:
        """This rank's rows of a global ensemble of W walkers."""
        n = W // self.dp
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def partners(self, R):
        """(this rank's N/tp partners R[..., lo:lo+N/tp, :] (a view), lo)."""
        n = R.shape[-2] // self.tp
        lo = self.tp_rank * n
        return R[..., lo:lo + n, :], lo

    @contextlib.contextmanager
    def _timed(self, on_card: bool):
        """Count one collective and time it: CUDA events around it on the
        card, the host clock on the CPU."""
        if on_card:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            yield
            ev[1].record()
            self._events.append(ev)
        else:
            t0 = time.perf_counter()
            yield
            self._done_s += time.perf_counter() - t0
        self.collectives += 1

    def all_reduce(self, t, group):
        """t summed over `group` (None: the default group), in place;
        counted and timed."""
        with self._timed(t.is_cuda):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t

    def ring_next(self, t):
        """The next sp rank's t (rank + 1 mod sp), this rank's t going to
        the previous one: lax.ppermute's shift around the ring
        (beadshard.py:113-115).  Point-to-point on t's device where the
        backend takes it (NCCL, or a CPU tensor), else (gloo and a CUDA
        tensor) staged through the host.  Counted and timed."""
        S, k = self.sp, self.sp_rank
        direct = self.backend == "nccl" or not t.is_cuda
        with self._timed(t.is_cuda):
            send = t.contiguous() if direct else t.cpu()
            recv = torch.empty_like(send)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, send, (k - 1) % S),
                dist.P2POp(dist.irecv, recv, (k + 1) % S)])
            for r in reqs:
                r.wait()
            out = recv if direct else recv.to(t.device)
        return out

    def gather(self, t, n: int, i: int, group):
        """[n, *t.shape]: t of each of the n ranks of `group` (None: the
        default group), i this rank's index in it, on every rank: one
        all-reduce of a buffer holding -0.0 (0 for integers) but at row i.
        It is exact bit for bit: x + (-0.0) == x for every x, +0.0 and
        -0.0 included."""
        buf = torch.full((n,) + tuple(t.shape), -0.0, dtype=t.dtype,
                         device=t.device)
        buf[i] = t
        return self.all_reduce(buf, group)

    @property
    def coll_s(self) -> float:
        """Seconds inside this rank's collectives so far (on the card,
        reading it waits for the last collective's end event)."""
        if self._events:
            self._events[-1][1].synchronize()
            self._done_s += sum(a.elapsed_time(b)
                                for a, b in self._events) / 1e3
            self._events.clear()
        return self._done_s

    def tp_sum(self, *ts):
        """The tensors ts (one dtype, None passed through) summed over the
        tp group in ONE all-reduce of their concatenation."""
        live = [t for t in ts if t is not None]
        buf = self.all_reduce(torch.cat([t.reshape(-1) for t in live]),
                              self.tp_group)
        out, k = [], 0
        for t in ts:
            if t is None:
                out.append(None)
                continue
            out.append(buf[k:k + t.numel()].view(t.shape))
            k += t.numel()
        return out

    def dp_sum(self, t):
        """t summed over the dp group (a copy)."""
        t = t.clone()
        return self.all_reduce(t, self.dp_group) if self.dp > 1 else t


def make_mesh(n_dp: int, n_tp: int = 1, n_sp: int = 1) -> Mesh:
    """This rank's Mesh over the initialised default group, whose world must
    be n_dp * n_tp ranks, or n_sp ranks for an sp ring (which takes no dp
    or tp).  Every rank builds every subgroup, in one order, as
    dist.new_group requires; the sp ring is the default group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_sp > 1 and n_dp * n_tp > 1:
        raise ValueError("an sp mesh takes no dp or tp axis")
    if world != n_dp * n_tp * n_sp:
        raise ValueError(f"a {n_dp} x {n_tp} x {n_sp} (dp x tp x sp) mesh "
                         f"needs {n_dp * n_tp * n_sp} ranks, the process "
                         f"group has {world}")
    mesh = Mesh(dp=n_dp, tp=n_tp, rank=rank, backend=dist.get_backend(),
                sp=n_sp)
    if n_sp > 1:
        return mesh
    for t in range(n_tp):
        g = dist.new_group([d * n_tp + t for d in range(n_dp)])
        if mesh.tp_rank == t:
            mesh.dp_group = g
    for d in range(n_dp):
        g = dist.new_group([d * n_tp + t for t in range(n_tp)])
        if mesh.dp_rank == d:
            mesh.tp_group = g
    return mesh


# ---------------------------------------------------------------------------
# The walker-sharded state and statistics
# ---------------------------------------------------------------------------

WALKER_FIELDS = ("paths", "xend", "isopen", "iworm", "in_cycle", "iperm")


def shard_state(system, state):
    """This rank's walkers of a global state (a copy of each walker field);
    the state itself without walker sharding.  The generators and the step
    are replicated: every rank holds the same."""
    mesh = system.mesh
    if mesh is None or mesh.dp == 1:
        return state
    rows = mesh.walkers(state.paths.shape[0])
    return dataclasses.replace(state, **{
        f: getattr(state, f)[rows].contiguous() for f in WALKER_FIELDS})


def gather_walkers(system, t):
    """The global [dp * W, ...] tensor of this rank's t [W, ...], on every
    rank of the dp group (Mesh.gather, exact bit for bit).  Bool tensors
    come back bool."""
    mesh = system.mesh
    if mesh is None or mesh.dp == 1:
        return t
    work = t.to(torch.int32) if t.dtype == torch.bool else t
    full = mesh.gather(work, mesh.dp, mesh.dp_rank, mesh.dp_group).flatten(
        0, 1)
    return full.bool() if t.dtype == torch.bool else full


def gather_state(system, state):
    """The global state (every walker field gathered over dp) of this
    rank's slice, on every rank."""
    mesh = system.mesh
    if mesh is None or mesh.dp == 1:
        return state
    return dataclasses.replace(state, **{
        f: gather_walkers(system, getattr(state, f)) for f in WALKER_FIELDS})


def reduce_stats(system, stats):
    """The block statistics summed over the dp group: every floating field
    in one all-reduce, the integer counters in a second.  Every rank then
    holds the replicated statistics."""
    mesh = system.mesh
    if mesh is None or mesh.dp == 1:
        return stats
    names = [k for k in stats._fields if k != "counters"]
    buf = mesh.dp_sum(torch.cat([getattr(stats, k).reshape(-1)
                                 for k in names]))
    out, k = {}, 0
    for nm in names:
        t = getattr(stats, nm)
        out[nm] = buf[k:k + t.numel()].view(t.shape)
        k += t.numel()
    out["counters"] = mesh.dp_sum(stats.counters)
    return stats._replace(**out)
