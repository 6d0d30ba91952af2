"""Device time of the PIM linear's weight work (``pim.weight``) under
the cell's step span (``model.decode_step`` in a decode cell,
``model.forward`` in a prefill cell) over the device time of those
steps, in %: the program's own spans of the profiled segment. A weight
whose 8-bit levels the program keeps (each dense weight after its first
call) spends that phase only on widening the kept levels to float64; a
first call, or a weight the program does not keep, spends it on the
weight's amax, quantization, int64 column sums and float64 levels."""
from pimbench.spans import device_share, program_spans, step_span


def read(run):
    return device_share(program_spans(), "pim.weight", step_span(run))
