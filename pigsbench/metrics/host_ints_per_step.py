"""Ints drawn on the host per traced step: the program's `host_int` counter
(utils/draws.DeviceDraws._host_int: the shared window starts, random end
depths, group offsets, composite, cascade and SP shifts) over the traced
block's steps."""

from pigsbench.harness.stages import host_ints_per_step


def read(run):
    return host_ints_per_step(run)
