"""Kernels the card ran in the profiled segment over its decode steps."""


def read(run):
    if run.trace is None:
        return None
    steps = sum(1 for s in run.traced_steps if s.kind == "decode")
    return run.trace.kernels / steps if steps else None
