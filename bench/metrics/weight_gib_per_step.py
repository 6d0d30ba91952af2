"""Weight bytes the PIM linear's weight work reads a step (``bytes`` of
the ``pim.weight`` spans under the cell's step span, over the number of
those steps), in GiB: the program's own count, from the spans of the
profiled segment."""
from pimbench.spans import bytes_per_step, program_spans, step_span


def read(run):
    b = bytes_per_step(program_spans(), "pim.weight", step_span(run))
    return None if b is None else b / 2 ** 30
