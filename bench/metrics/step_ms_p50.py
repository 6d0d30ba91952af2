"""The median decode step of the window on the host clock, in ms."""
import statistics


def read(run):
    ms = [s.seconds * 1e3 for s in run.steps if s.kind == "decode"]
    return statistics.median(ms) if ms else None
