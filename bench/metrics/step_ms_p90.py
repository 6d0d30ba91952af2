"""The 90th percentile of every decode step of the window, each timed on
the host clock up to its tokens' copy to the host, in milliseconds: the
tail that a slower host CPU adds to a step bound by its launches."""
import statistics


def read(run):
    ms = [s.seconds * 1e3 for s in run.steps if s.kind == "decode"]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
