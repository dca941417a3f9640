"""Milliseconds per traced step between the two CUDA events of the
program's `worm` span (Sweeper.step's Nobdm worm rounds: half moves,
swaps, the OBDM histogram), summed over the block's steps: the stage's
stretch of the stream."""

from pigsbench.harness.stages import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "worm")
