"""Device time of the PIM linear's integer product (``pim.product``: the
float64 GEMM and its cast to int64) under the cell's step span
(``model.decode_step`` in a decode cell, ``model.forward`` in a prefill
cell) over the device time of those steps, in %: the program's own
spans of the profiled segment."""
from pimbench.spans import device_share, program_spans, step_span


def read(run):
    return device_share(program_spans(), "pim.product", step_span(run))
