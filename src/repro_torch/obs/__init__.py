"""repro_torch.obs — zero-dependency observability for the whole stack.

Three pieces, one import surface:

* **Spans** (:mod:`.trace`) — ``with obs.span("compile.fuse", op=...):``
  wall-time intervals from the compiler, cache, engine, executors, and
  serve loop, exported as Chrome trace-event JSON
  (``obs.export_trace(path)``; open in chrome://tracing or Perfetto).
  Disabled by default and near-free when disabled.
* **Metrics** (:mod:`.metrics`) — process-wide counters / gauges /
  streaming histograms; ``obs.dump()`` snapshots everything (a superset
  of ``Engine.stats()``), ``obs.write_metrics(path)`` saves it.
  Always on: recording a counter or latency sample is cheap enough to
  not need a switch.

The reference package's waterfall tracks (``repro.obs.waterfall``) and
the ``energy_proxy`` they feed are not ported yet.

Import layering: ``repro_torch.obs`` imports nothing else of the
package — the compiler and engine layers import it, so it sits below
them.
"""
from __future__ import annotations

from typing import Optional

from .logging import get_logger, setup_logging
from .metrics import (Counter, Gauge, Histogram, Registry,
                      WindowedHistogram, get_registry)
from .trace import NULL_SPAN, PID_SPANS, Span, Tracer, get_tracer

__all__ = [
    # trace
    "span", "instant", "track", "enable", "disable", "enabled",
    "reset_trace", "add_events", "export_trace", "get_tracer", "Tracer",
    "Span", "NULL_SPAN", "PID_SPANS",
    # metrics
    "counter", "gauge", "histogram", "windowed_histogram", "dump",
    "write_metrics", "reset_metrics", "get_registry", "Registry",
    "Counter", "Gauge", "Histogram", "WindowedHistogram",
    # logging
    "setup_logging", "get_logger",
]


# --------------------------------------------------------------- spans ----
def span(name: str, cat: str = "repro", **args):
    """Module-level alias for ``get_tracer().span(...)`` — the form
    instrumented code uses. One attribute check when tracing is off."""
    t = get_tracer()
    if not t.enabled:
        return NULL_SPAN
    return t.span(name, cat, **args)


def instant(name: str, cat: str = "repro", **args) -> None:
    """Record an instant event on the wall-time trace."""
    get_tracer().instant(name, cat, **args)


def track(name: str, cat: str = "repro", **values) -> None:
    """One sample of a wall-time counter track in the exported trace
    (e.g. ``obs.track("serve.sched", queue_depth=3, live=4)``). Distinct
    from :func:`counter`, which is the *metrics* counter instrument."""
    get_tracer().counter(name, cat, **values)


def enable() -> None:
    """Turn span tracing on."""
    get_tracer().enable()


def disable() -> None:
    """Turn span tracing off."""
    get_tracer().disable()


def enabled() -> bool:
    """Whether span tracing is on."""
    return get_tracer().enabled


def reset_trace() -> None:
    """Drop every recorded trace event."""
    get_tracer().reset()


def add_events(events) -> None:
    """Append pre-built trace events."""
    get_tracer().add_events(events)


def export_trace(path: str) -> int:
    """Write the trace as Chrome trace-event JSON; returns the event count."""
    return get_tracer().export(path)


# ------------------------------------------------------------- metrics ----
def counter(name: str) -> Counter:
    """The named process-wide counter."""
    return get_registry().counter(name)


def gauge(name: str) -> Gauge:
    """The named process-wide gauge."""
    return get_registry().gauge(name)


def histogram(name: str, cap: int = Histogram.DEFAULT_CAP) -> Histogram:
    """The named process-wide histogram."""
    return get_registry().histogram(name, cap)


def windowed_histogram(name: str, cap: int = Histogram.DEFAULT_CAP
                       ) -> WindowedHistogram:
    """The named process-wide windowed histogram."""
    return get_registry().windowed_histogram(name, cap)


def dump() -> dict:
    """Snapshot of every metric as a dict."""
    return get_registry().dump()


def write_metrics(path: str, extra: Optional[dict] = None) -> dict:
    """Write the metrics snapshot to ``path`` as JSON."""
    return get_registry().write(path, extra)


def reset_metrics() -> None:
    """Zero every metric in place."""
    get_registry().reset()
