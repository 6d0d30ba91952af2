"""The engine of a ``--trace 1`` run: the port's ``Engine`` with a
profiler range around each PIM linear call, and the call's shapes kept
while a segment is recorded (for the roofline's work counts). The
untraced runs pass the port's ``Engine`` itself."""
from __future__ import annotations

__all__ = ["traced_engine"]


def traced_engine(backend=None):
    """An ``Engine`` subclass instance whose ``linear`` and
    ``ragged_linear`` open a :data:`pimbench.trace.PIM` range. While
    ``calls`` is a list, each call appends ``(kind, rows, k, n, n_bits,
    counts)`` to it (``counts`` as the port passed it: a ragged call's
    segment lengths, read after the segment)."""
    from repro_torch.engine import Engine
    from torch.profiler import record_function

    from .trace import PIM

    class TracedEngine(Engine):
        calls = None

        def linear(self, x, w, b=None, **kw):
            if self.calls is not None:
                self.calls.append(("linear", x.numel() // x.shape[-1],
                                   w.shape[0], w.shape[1],
                                   kw.get("n_bits", 8), None))
            with record_function(PIM):
                return super().linear(x, w, b, **kw)

        def ragged_linear(self, xs, we, counts, **kw):
            if self.calls is not None:
                self.calls.append(("ragged", xs.shape[0], we.shape[1],
                                   we.shape[2], kw.get("n_bits", 8), counts))
            with record_function(PIM):
                return super().ragged_linear(xs, we, counts, **kw)

    return TracedEngine(backend)
