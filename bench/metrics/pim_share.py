"""Device time of the operations launched inside the engine's PIM
``linear``/``ragged_linear`` calls, over all device time of the profiled
segment, in %."""


def read(run):
    if run.trace is None or not run.trace.device_s:
        return None
    return 100.0 * sum(run.trace.pim_call_s) / run.trace.device_s
