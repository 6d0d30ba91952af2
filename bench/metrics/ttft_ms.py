"""Job submit to its first token's copy to the host, the median over the
jobs whose prefill ran in the window, in ms."""
import statistics


def read(run):
    first = {s.job for s in run.steps if s.kind == "prefill"}
    ms = [(j.first_token - j.submit) * 1e3 for j in run.jobs
          if j.index in first and j.first_token is not None]
    return statistics.median(ms) if ms else None
