"""The allocator's peak over set-up and window, in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
