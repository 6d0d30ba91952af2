"""Device time of the PIM linear's weight work (``pim.weight``: the
weight's amax, quantization, int64 column sums and float64 levels) under
the cell's step span (``model.decode_step`` in a decode cell,
``model.forward`` in a prefill cell) over the device time of those
steps, in %: the program's own spans of the profiled segment."""
from pimbench.spans import device_share, program_spans, step_span


def read(run):
    return device_share(program_spans(), "pim.weight", step_span(run))
