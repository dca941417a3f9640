"""The yardstick of work: bead updates attempted per Monte Carlo step per
walker, the engine's own throughput definition (bead-updates/s = W x this
/ seconds per step).  A frozen copy of the count the program states in
`sweep.bead_updates_per_step` (itself a copy of the reference's); a test
holds the two equal for every cell.  It charges 3 2^Nlev beads per
unfused particle visit, as the reference counts them.

`cfg` is a mapping of the configuration's fields."""

from __future__ import annotations


def bead_updates_per_step(cfg) -> int:
    M = 2 * cfg["Nb"] + 1
    Np = cfg["Np"]
    per = 0
    if cfg["CMFreq"] > 0:
        per += Np * M // max(cfg["CMFreq"], 1)
    if cfg.get("smart_mc", 0.0) > 0.0:
        per += Np * M
    if cfg["Nstag"] > 0:
        if cfg["sampling"] == "bis":
            L = 2 ** cfg["Nlev"]
            fused = (cfg.get("fused_sweep", True)
                     and not cfg.get("bis_end_random_depth", False)
                     and 2 * L < M - 1)
            if fused:
                K = min(max(1, (M - 1 - L) // L), Np)
                ngroups = -(-Np // K)
                per += cfg["Nstag"] * Np * 2 * L
                per += cfg["Nstag"] * ngroups * K * (L - 1)
            else:
                per += cfg["Nstag"] * Np * 3 * L
        else:
            n_int = max(cfg.get("mesh_beads", 1), 1)
            Ls = cfg["Lstag"]
            per += cfg["Nstag"] * Np * (2 * Ls + n_int * (Ls - 1)
                                        + (1 if n_int == 1 else 0))
    if cfg.get("CWorm", 0.0) > 0.0:
        per += cfg["Nobdm"] * (2 * (cfg["Nb"] + 1) + 2 * 3 * cfg["Lstag"])
    return per


def rate(walkers: int, per_step: int, steps: int, seconds: float) -> float:
    """bead-updates/s: all the work of the window over all its time."""
    return walkers * per_step * steps / seconds


# the program's acceptance counters in the order its statistics hold them
# (a copy of `sweep.COUNTER_NAMES`, held equal by a test)
COUNTER_NAMES = (
    "try_cm", "acc_cm", "try_stag", "acc_bd", "acc_head", "acc_tail",
    "try_cm_half", "acc_cm_half", "try_stag_half", "acc_bd_half",
    "acc_head_half", "acc_tail_half",
    "try_open", "acc_open", "try_close", "acc_close", "try_swap", "acc_swap",
    "try_mala", "acc_mala", "try_int",
)
