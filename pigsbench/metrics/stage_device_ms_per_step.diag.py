"""Milliseconds per traced step between the two CUDA events of the
program's `diag` span (Sweeper.step's diagonal sweep: the head, tail and
interior bisections or their composites), summed over the block's steps:
the stage's stretch of the stream."""

from pigsbench.harness.stages import device_ms_per_step


def read(run):
    return device_ms_per_step(run, "diag")
