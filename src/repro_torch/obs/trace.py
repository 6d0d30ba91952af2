"""Span tracer -> Chrome trace-event JSON (zero dependencies).

One process-wide :class:`Tracer` records *spans* — named, timed,
attribute-carrying intervals — from every layer of the stack (compiler
passes, program cache, engine compiles, executable runs, the serve
decode loop). The export is the Chrome trace-event format
(``{"traceEvents": [...]}``), loadable directly in ``chrome://tracing``
or https://ui.perfetto.dev, so a serve run becomes a navigable timeline
with the compile/cache/execute breakdown on real (wall) time and the
crossbar waterfall (the reference package's ``repro.obs.waterfall``) on modeled (cycle) time
as sibling counter tracks.

Overhead contract: the tracer is **disabled by default** and the
disabled hot path is near-free — ``span()`` returns a shared no-op
singleton (:data:`NULL_SPAN`) without allocating or taking a lock, so
instrumented code (``with obs.span("exec.kernel", ...)``) costs one
attribute check per call site when tracing is off. Enabled spans append
one event dict under a lock on exit; recording is thread-safe and each
span carries its recording thread's id, so concurrent compiles land on
separate tracks.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Span", "Tracer", "NULL_SPAN", "PID_SPANS"]

# Process-row ids in the exported trace: wall-time spans live in pid 1;
# modeled-time waterfall tracks claim pids >= 2 (one per program).
PID_SPANS = 1

_clock_ns = time.perf_counter_ns


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out. Every
    method is a no-op and ``span()`` always returns the same instance,
    so the disabled path performs no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span; records itself on ``__exit__``. ``set(**args)``
    attaches attributes any time before exit (e.g. a result computed
    inside the span, like a pass's cycles-after)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args

    def set(self, **args) -> "Span":
        """Attach result arguments to the open span."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        self._t0 = _clock_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._record(self.name, self.cat, self._t0, _clock_ns(),
                             self.args)
        return False


def _jsonable(v):
    """Trace args must serialize; numpy scalars and other odd values
    degrade to builtin numbers/strings instead of failing the export."""
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        if hasattr(v, "item"):          # numpy scalar
            return v.item()
    except Exception:
        pass
    return str(v)


class Tracer:
    """Thread-safe span recorder with Chrome trace-event export."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._epoch = _clock_ns()

    # ------------------------------------------------------- control ----
    def enable(self) -> None:
        """Start recording spans."""
        self.enabled = True

    def disable(self) -> None:
        """Stop recording spans."""
        self.enabled = False

    def reset(self) -> None:
        """Drop every recorded event."""
        with self._lock:
            self._events.clear()
            self._epoch = _clock_ns()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ----------------------------------------------------- recording ----
    def span(self, name: str, cat: str = "repro", **args):
        """Context manager timing one interval. Near-free when the
        tracer is disabled (returns the shared :data:`NULL_SPAN`)."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": (_clock_ns() - self._epoch) / 1e3,
              "pid": PID_SPANS,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def counter(self, name: str, cat: str = "repro", **values) -> None:
        """One sample of a wall-time counter track (Chrome ``ph:"C"``):
        every keyword becomes a stacked series of the track ``name``.
        Unlike the modeled-cycle waterfall tracks (pids >= 2), these
        live on the span row (pid 1), so a scheduler's queue depth and
        slot occupancy line up under its own ``serve.*`` spans. No-op
        while disabled, like spans."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "C",
              "ts": (_clock_ns() - self._epoch) / 1e3,
              "pid": PID_SPANS,
              "args": {k: _jsonable(v) for k, v in values.items()}}
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, cat: str, t0: int, t1: int,
                args: Dict) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": (t0 - self._epoch) / 1e3,
              "dur": (t1 - t0) / 1e3,
              "pid": PID_SPANS,
              "tid": threading.get_ident() & 0x7FFFFFFF}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    def add_events(self, events: List[dict]) -> None:
        """Append pre-built trace events (e.g. waterfall counter tracks
        from ``repro.obs.waterfall.waterfall_events``). Unlike
        spans, raw events are accepted even while the tracer is
        disabled — an export is explicit, so whoever exports decided
        they want them."""
        with self._lock:
            self._events.extend(events)

    # -------------------------------------------------------- export ----
    def trace_dict(self) -> dict:
        """The Chrome trace-event JSON object (see module docstring)."""
        with self._lock:
            events = list(self._events)
        meta = [{"name": "process_name", "ph": "M", "pid": PID_SPANS,
                 "tid": 0, "args": {"name": "repro (wall time)"}}]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the trace to ``path``; returns the event count."""
        doc = self.trace_dict()
        with open(path, "w") as f:
            json.dump(doc, f, default=str)
        return len(doc["traceEvents"])


# Shared default tracer (what ``repro_torch.obs``'s module-level helpers use).
_GLOBAL: Optional[Tracer] = None
_GLOBAL_LOCK = threading.Lock()


def get_tracer() -> Tracer:
    """The process-wide tracer."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Tracer()
    return _GLOBAL
