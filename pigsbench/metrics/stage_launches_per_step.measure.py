"""Host launch calls per traced step whose start lies in the program's
`measure` span (Sweeper.step's estimators: energies, kernel B, g(r),
S(k)), counted as host_launches_per_step counts them (a call nested in
another once)."""

from pigsbench.harness.stages import launches_per_step


def read(run):
    return launches_per_step(run, "measure")
