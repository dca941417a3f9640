"""Milliseconds per traced step between the two CUDA events of the
program's `measure` span (Sweeper.step's estimators: energies, kernel B,
g(r), S(k)), summed over the block's steps: the stage's stretch of the
stream."""

from pigsbench.harness.stages import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "measure")
