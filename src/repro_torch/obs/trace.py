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

A span records while the tracer is enabled **or** while
``torch.profiler`` records (``torch.autograd.profiler``'s
``_is_profiler_enabled``), so a profiled segment holds the program's
spans with no switch of its own. While the profiler records, each span:

* opens a profiler range of its own name: torch's
  ``_RecordFunctionFast`` (a ``cpu_op`` in the profiler's export; a
  tenth of ``record_function``'s host cost, which it falls back to,
  a ``user_annotation``), inside which the host's launches fall;
* at the profiler's stop, gets ``args.device_us``: the summed durations
  of the device operations (kernels, copies, sets) whose launch the
  profiler saw inside that range, on any thread. This is kernel time,
  not the stream's wall time: a launch-bound step's idle gaps are not
  in it. A profile that saw no device operation writes none.

Every recorded span carries an ``id`` and its ``parent``'s id (the
enclosing recorded span on the same thread, None at the top).

The profiler hands its results only to whoever stopped it, so the first
span that opens a range wraps ``torch.autograd.profiler``'s
``_disable_profiler``: the wrapper returns the results as they were and
first reads the device times of the spans of that segment
(:func:`_device_ns`).

Timestamps are CLOCK_REALTIME in microseconds: the tracer anchors one
(``perf_counter_ns``, ``time_ns``) pair at its epoch and times every
span on ``perf_counter_ns`` from there, so a span's ``ts`` equals its
profiler twin's ``ts + baseTimeNanoseconds / 1e3``.

Overhead contract: the tracer is **disabled by default** and the
disabled hot path is near-free — ``span()`` returns a shared no-op
singleton (:data:`NULL_SPAN`, which is falsy) without allocating or
taking a lock, so instrumented code (``with obs.span("exec.kernel",
...)``) costs two attribute checks per call site when tracing is off and
the profiler does not record. Call sites pass only values already in
hand; anything computed for a span goes through ``if sp: sp.set(...)``.
Recorded spans append one event dict under a lock on exit; recording is
thread-safe and each span carries its recording thread's id, so
concurrent compiles land on separate tracks.
"""
from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
import weakref
from collections import defaultdict
from typing import Dict, Iterable, List, Optional

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Span", "Tracer", "NULL_SPAN", "PID_SPANS"]

# Process-row ids in the exported trace: wall-time spans live in pid 1;
# modeled-time waterfall tracks claim pids >= 2 (one per program).
PID_SPANS = 1

_clock_ns = time.perf_counter_ns
_ids = itertools.count(1)


class _Stack(threading.local):
    """Each thread's ids of its open recorded spans, innermost last."""

    def __init__(self):
        self.ids: List[int] = []


_OPEN = _Stack()


# The profiler's segments: the number of stops seen so far, which is the
# index of the segment that is recording (``Span._segment``), and the
# tracers that hold spans waiting for a stop.
_SEGMENT = [0]
_WAITING: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
_WATCHING = [False]
_CPU = torch.autograd.DeviceType.CPU
_twin = getattr(torch._C._profiler, "_RecordFunctionFast",
                _profiler.record_function)


def _watch_profiler() -> None:
    """Wrap ``torch.autograd.profiler._disable_profiler`` (once) so that
    each stop of the profiler resolves the device times of the spans
    recorded under it (the module docstring)."""
    if _WATCHING[0]:
        return
    _WATCHING[0] = True
    disable = _profiler._disable_profiler

    def _disable_profiler(*a, **kw):
        result = disable(*a, **kw)
        segment = _SEGMENT[0]
        _SEGMENT[0] += 1
        for tracer in list(_WAITING):
            tracer._resolve(segment, result)
        return result

    _profiler._disable_profiler = _disable_profiler


def _device_ns(events: Iterable, names) -> Dict[str, List[List[int]]]:
    """The ranges named in ``names`` among the profiler's ``events``
    (``torch.profiler``'s ``_KinetoEvent``s): for each name, its ranges
    in start order as ``[start_ns, end_ns, device_ns]``, where
    ``device_ns`` sums the durations of the device operations (kernels,
    copies, sets: a device event other than the device's copy of a
    user annotation) whose launch starts inside the range. A launch is
    a host event linked to the operator that made it (a runtime call),
    with the device operation's correlation id. Empty when no device
    operation is among the events."""
    ranges: Dict[str, List[List[int]]] = defaultdict(list)
    launches: Dict[int, int] = {}
    device = []
    for e in events:
        if e.device_type() != _CPU:
            if not e.is_user_annotation():
                device.append((e.correlation_id(), e.duration_ns()))
        elif e.linked_correlation_id():
            launches[e.correlation_id()] = e.start_ns()
        elif e.name() in names:
            t = e.start_ns()
            ranges[e.name()].append([t, t + e.duration_ns(), 0])
    if not device:
        return {}
    for rs in ranges.values():
        rs.sort()
    starts = {n: [r[0] for r in rs] for n, rs in ranges.items()}
    for corr, ns in device:
        at = launches.get(corr)
        if at is None:
            continue
        for n, rs in ranges.items():
            i = bisect.bisect_right(starts[n], at) - 1
            if i >= 0 and at <= rs[i][1]:
                rs[i][2] += ns
    return ranges


class _NullSpan:
    """Shared no-op span: what a disabled tracer hands out. Every
    method is a no-op and ``span()`` always returns the same instance,
    so the disabled path performs no allocation."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> "_NullSpan":
        return self


NULL_SPAN = _NullSpan()


class Span:
    """One live span; records itself on ``__exit__``. ``set(**args)``
    attaches attributes any time before exit (e.g. a result computed
    inside the span, like a pass's cycles-after)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "id", "parent",
                 "_twin", "_segment")

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
        stack = _OPEN.ids
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self._twin = self._segment = None
        if _profiler._is_profiler_enabled:
            _watch_profiler()
            self._segment = _SEGMENT[0]
            self._twin = _twin(self.name)
            self._twin.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._twin is not None:
            self._twin.__exit__(None, None, None)
        _OPEN.ids.pop()
        self._tracer._record(self.name, self.cat, self._t0, _clock_ns(),
                             self.args, self.id, self.parent, self._segment)
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
        self._pending: List[tuple] = []      # (segment, event) of twins
        self._anchor()

    def _anchor(self) -> None:
        """The epoch: one reading of both clocks, so ``perf_counter_ns``
        stamps become CLOCK_REALTIME (:meth:`_us`)."""
        self._epoch = _clock_ns()
        self._wall_ns = time.time_ns()

    def _us(self, t: int) -> float:
        """A ``perf_counter_ns`` stamp as CLOCK_REALTIME microseconds."""
        return (self._wall_ns + (t - self._epoch)) / 1e3

    def start_us(self) -> float:
        """Where the trace starts on its clock (CLOCK_REALTIME µs): the
        earliest recorded span, instant or counter, else the epoch. Events
        on another axis (the modeled-cycle waterfalls) are placed from
        here."""
        with self._lock:
            ts = [e["ts"] for e in self._events
                  if e.get("pid") == PID_SPANS and "ts" in e]
        return min(ts) if ts else self._us(self._epoch)

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
            self._pending.clear()
            self._anchor()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # ----------------------------------------------------- recording ----
    def span(self, name: str, cat: str = "repro", **args):
        """Context manager timing one interval. Near-free when neither
        the tracer nor the profiler records (returns the shared
        :data:`NULL_SPAN`)."""
        if not self.enabled and not _profiler._is_profiler_enabled:
            return NULL_SPAN
        return Span(self, name, cat, args)

    def instant(self, name: str, cat: str = "repro", **args) -> None:
        """A zero-duration marker event."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self._us(_clock_ns()),
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
              "ts": self._us(_clock_ns()),
              "pid": PID_SPANS,
              "args": {k: _jsonable(v) for k, v in values.items()}}
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, cat: str, t0: int, t1: int, args: Dict,
                sid: int, parent: Optional[int],
                segment: Optional[int]) -> None:
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": self._us(t0),
              "dur": (t1 - t0) / 1e3,
              "pid": PID_SPANS,
              "tid": threading.get_ident() & 0x7FFFFFFF,
              "id": sid, "parent": parent}
        if args:
            ev["args"] = {k: _jsonable(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)
            if segment is None:
                return
            first = not self._pending
            self._pending.append((segment, ev))
        if first:
            _WAITING.add(self)

    def _resolve(self, segment: int, result) -> None:
        """At the stop of the profiler's ``segment``, with its
        ``result``: write ``args.device_us`` of this tracer's spans of
        that segment from their twins (matched in start order per name;
        a name whose spans and twins do not pair one to one gets none)
        and drop spans of earlier segments, whose results are gone."""
        with self._lock:
            mine = [ev for seg, ev in self._pending if seg == segment]
            self._pending = [(seg, ev) for seg, ev in self._pending
                             if seg > segment]
        if not mine or not hasattr(result, "events"):
            return
        by_name: Dict[str, List[dict]] = defaultdict(list)
        for ev in mine:
            by_name[ev["name"]].append(ev)
        ranges = _device_ns(result.events(), set(by_name))
        for name, evs in by_name.items():
            twins = ranges.get(name, [])
            if len(twins) != len(evs):
                continue
            evs.sort(key=lambda e: e["id"])
            for ev, (_, _, ns) in zip(evs, twins):
                ev.setdefault("args", {})["device_us"] = ns / 1e3

    def add_events(self, events: List[dict]) -> None:
        """Append pre-built trace events (e.g. waterfall counter tracks
        from ``repro.obs.waterfall.waterfall_events``). Unlike
        spans, raw events are accepted even while the tracer is
        disabled — an export is explicit, so whoever exports decided
        they want them."""
        with self._lock:
            self._events.extend(events)

    # -------------------------------------------------------- export ----
    def events(self) -> List[dict]:
        """Every recorded event (spans of a stopped profiler segment with
        their ``args.device_us``)."""
        with self._lock:
            return list(self._events)

    def trace_dict(self) -> dict:
        """The Chrome trace-event JSON object (see module docstring)."""
        events = self.events()
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
