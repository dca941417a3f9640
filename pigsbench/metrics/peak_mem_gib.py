"""Peak device memory over set-up and window, in GiB:
torch.cuda.max_memory_allocated(), read before anything is compared."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
