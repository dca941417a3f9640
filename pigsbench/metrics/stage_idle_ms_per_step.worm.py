"""Milliseconds per traced step of the device's idle gaps (between the
block's first and last device activity, as trace.breakdown finds them)
whose midpoint lies in the program's `worm` span (Sweeper.step's Nobdm
worm rounds: half moves, swaps, the OBDM histogram)."""

from pigsbench.harness.stages import idle_ms_per_step


def read(run):
    return idle_ms_per_step(run, "worm")
