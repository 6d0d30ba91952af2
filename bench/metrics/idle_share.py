"""The share of the profiled segment in which no operation ran on the
card, in %: one less the union of device operations over the segment."""


def read(run):
    if run.trace is None or not run.trace.window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
