"""bead-updates/s: W x bead updates per step per walker (the frozen count,
harness/counting.py) x the steps of every block of the window, over the
window's wall time from its start to the last block's read-back."""


def read(run):
    return run.bead_updates_per_s if run.steps and run.window_s > 0 else None
