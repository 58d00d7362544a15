"""The most device memory the allocator held over a decode cell's window,
in GiB: the weights and every request's cache."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
