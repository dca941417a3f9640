"""Seconds from the process's start to the window's start: imports, CUDA
start-up, the kernels' library, make_system, the start and the warm-up
block."""


def read(run):
    return run.setup_s
