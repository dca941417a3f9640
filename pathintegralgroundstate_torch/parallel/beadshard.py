"""Sequence-parallel (SP) bead-axis sharding with a ring halo exchange.

The torch counterpart of pathintegralgroundstate_tpu/parallel/beadshard.py
(cfg.mesh_beads > 1, the reference's correctness demo of the SP pattern).
The imaginary-time axis is the "sequence": the M-1 links are split into
S = mesh_beads contiguous shards of Mloc beads, and shard k owns beads
[k Mloc, (k+1) Mloc).  One call of the SP sweep regrows ONE staging window
of particle ip per shard:

  * the window start is even-aligned, a local start ii in [0, Mloc - L],
    shared by every walker (one host int per shard);
  * the window is beads ii..ii+L of the shard's beads extended by one halo
    bead, the next shard's first bead (the last shard's is the replicated
    global bead M-1); the move is moves.segment_regrow's fixed-end bridge
    on it with the GLOBAL bead indices k Mloc + ii + (0..L), so the Chin
    odd/even weights and the end-WF terms are the global ones (an even
    Mloc keeps every shard offset even);
  * a Metropolis test, then only the interior beads ii+1..ii+L-1 of
    particle ip are written back.  No shard moves a boundary bead k Mloc or
    another particle, so the S windows touch disjoint coordinates and the
    S accept decisions compose into a valid product kernel.

Two forms, equal bit for bit on the same draws:

  sp_staging_sweep_ref  the unsharded composite on one process (the
      reference's explicit shard axis, beadshard.py:128-148): a loop over
      the shards of one System without a mesh;
  sp_staging_sweep      one rank's shard of an sp mesh (parallel/mesh.py):
      the paths stay replicated on every rank outside the sweep, as the
      reference's jit holds them whole around its shard_map.  Each call
      makes two exchanges: the halo from the next rank around the ring
      (Mesh.ring_next, lax.ppermute's counterpart) and one gather of every
      shard's moved window interior and accept flags (Mesh.gather),
      which re-replicates what changed.

Every rank draws the blocks of all S shards, in shard order, and keeps
its own (utils/draws.DeviceDraws.sp_staging), so a sharded run draws
exactly the numbers of the unsharded run of the same seed.  The window
pass is ops/pairwise.delta_action_sum: kernel A on the card.
"""

from __future__ import annotations

import torch

from ..ops.moves import _where, metropolis_u, segment_regrow

# the reference's refusal outside the demo's envelope (sweep.py:237-246)
SP_ENVELOPE = (
    "mesh_beads>1 is the SP correctness demo, limited to "
    "sampling='sta', CWorm=0, exact_f2=F and "
    "mesh_walkers=mesh_pairs=1.  For production long-M "
    "runs use walker DP instead: a single chip holds the "
    "full bead axis to M ~ 16k at useful walker counts, "
    "and measured M=257 single-chip throughput is ~62% of "
    "the M=65 flagship rate with zero communication "
    "(docs/VALIDATION.md 'SP bead-sharding').")


def check_sp_geometry(Mm1: int, S: int, L: int) -> None:
    """The reference's _check_sp_geometry (beadshard.py:45-56): the links
    divide the shards, every shard's bead count Mloc is even (so every
    shard offset k Mloc is even and the global Chin parities hold), and
    the window L is even and fits a shard."""
    if Mm1 % S:
        raise ValueError(f"M-1={Mm1} links must divide the sp axis S={S}")
    Mloc = Mm1 // S
    if Mloc % 2:
        raise ValueError(f"Mloc={Mloc} must be even (even-aligned windows)")
    if L % 2 or L > Mloc:
        raise ValueError(f"window L={L} must be even and <= Mloc={Mloc}")


def check_sp_config(cfg) -> None:
    """ValueError outside the SP envelope (sweep.py:234-250): staging,
    no worm, the partial F^2, no dp or tp mesh, and the shard geometry."""
    if cfg.sampling != "sta" or cfg.CWorm > 0.0 or cfg.exact_f2 \
            or cfg.mesh_walkers > 1 or cfg.mesh_pairs > 1:
        raise ValueError(SP_ENVELOPE)
    check_sp_geometry(cfg.M - 1, cfg.mesh_beads, cfg.Lstag)


def n_starts(Mloc: int, L: int) -> int:
    """The number of even local window starts in [0, Mloc - L]."""
    return (Mloc - L) // 2 + 1


def shard_window(paths_l, halo, ii: int, L: int):
    """The window [W, L+1, N, D] at local start ii of the shard's beads
    paths_l [W, Mloc, N, D]: a view of paths_l where it ends inside the
    shard, else its last L beads and the halo [W, N, D] joined into a
    copy."""
    if ii + L < paths_l.shape[1]:
        return paths_l[:, ii:ii + L + 1]
    return torch.cat([paths_l[:, ii:], halo[:, None]], 1)


def _shard_move(system, paths_l, halo, ip: int, L: int, offset: int,
                ii: int, gs, u_acc):
    """One staging move on one shard (beadshard.py:59-91).  paths_l
    [W, Mloc, N, D]: the shard's beads, a view written in place at particle
    ip's window interior; halo [W, N, D] the next boundary bead; offset the
    global index of local bead 0; ii the even local start; gs [L-1, W, D]
    and u_acc [W] the draws; the window is shard_window's.  Returns (the
    window's interior as written [W, L-1, D], acc [W])."""
    W = paths_l.shape[0]
    R_seg = shard_window(paths_l, halo, ii, L)
    seg = R_seg[:, :, ip]
    Ls = torch.full((W,), L, dtype=torch.long, device=paths_l.device)
    seg_new, dS = segment_regrow(
        system, seg, R_seg, system.arange(offset + ii, offset + ii + L + 1),
        ip, Ls, "fixed", 1.0, None, gs, fixed_L=L)
    acc = metropolis_u(u_acc, dS)
    inner = _where(acc, seg_new[:, 1:L], seg[:, 1:L])
    paths_l[:, ii + 1:ii + L, ip] = inner
    return inner, acc


def _blocks(paths, S: int, L: int):
    """(Mloc, the last global bead M-1 [W, N, D]) after the geometry
    check."""
    M = paths.shape[1]
    check_sp_geometry(M - 1, S, L)
    return (M - 1) // S, paths[:, M - 1]


def sp_staging_sweep_ref(system, paths, ip: int, S: int, L: int, draws):
    """The SP sweep of S shards on one process: paths [W, M, N, D] in
    place; draws [(ii, gs, u_acc)] one per shard (DeviceDraws.sp_staging).
    Every window reads only beads no other shard writes (its interior and
    the fixed boundary beads), so moving the shards one after the other
    equals the reference's simultaneous form.  Returns acc [S, W]."""
    Mloc, last = _blocks(paths, S, L)
    accs = []
    for k in range(S):
        lo = k * Mloc
        halo = paths[:, lo + Mloc] if k < S - 1 else last
        accs.append(_shard_move(system, paths[:, lo:lo + Mloc], halo, ip, L,
                                lo, *draws[k])[1])
    return torch.stack(accs)


def sp_staging_sweep(system, paths, ip: int, L: int, draws):
    """This rank's shard of the SP sweep (beadshard.py:94-125), on the
    replicated paths [W, M, N, D] in place: the ring halo, this shard's
    move, then one gather of every shard's window interior and accepts,
    written into every rank's copy.  Returns acc [S, W] (every shard's,
    on every rank)."""
    mesh = system.mesh
    S, k = mesh.sp, mesh.sp_rank
    Mloc, last = _blocks(paths, S, L)
    W, D = paths.shape[0], paths.shape[-1]
    lo = k * Mloc
    paths_l = paths[:, lo:lo + Mloc]
    # the ring: this shard's first bead goes to the previous rank, the next
    # shard's comes in; the last shard takes the replicated bead M-1
    halo = mesh.ring_next(paths_l[:, 0])
    if k == S - 1:
        halo = last
    inner, acc = _shard_move(system, paths_l, halo, ip, L, lo, *draws[k])
    mine = torch.cat([inner.reshape(W, -1), acc[:, None].to(paths.dtype)], 1)
    every = mesh.gather(mine, S, k, None)           # [S, W, (L-1) D + 1]
    for j in range(S):
        if j != k:
            b = j * Mloc + draws[j][0] + 1
            paths[:, b:b + L - 1, ip] = every[j, :, :-1].view(W, L - 1, D)
    return every[:, :, -1] > 0.5
