"""The host's CUDA launch calls per traced step: kernel launches, memcpy,
memset and graph launches as the profiler records them on the host (a
call nested inside another launch call counted once)."""


def read(run):
    td = run.trace
    if td is None or not td.launch_calls or not td.steps:
        return None
    return td.launch_calls / td.steps
