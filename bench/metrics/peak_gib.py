"""The card's peak allocated memory in the window (the allocator's peak,
reset at the end of set-up), in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
