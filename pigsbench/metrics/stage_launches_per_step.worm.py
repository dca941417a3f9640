"""Host launch calls per traced step whose start lies in the program's
`worm` span (Sweeper.step's Nobdm worm rounds: half moves, swaps, the
OBDM histogram), counted as host_launches_per_step counts them (a call
nested in another once)."""

from pigsbench.harness.stages import launches_per_step


def read(run):
    return launches_per_step(run, "worm")
