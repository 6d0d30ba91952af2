"""The card's peak allocated memory over the window's steps (the
allocator's peak, reset at the end of set-up and after each prefill kept
off a decode window, and read before it), in GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None
