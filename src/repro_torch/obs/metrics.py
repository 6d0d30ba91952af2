"""Metrics registry: counters, gauges, streaming histograms (zero deps).

One process-wide :class:`Registry` aggregates what the stack is doing —
program-cache hits/misses/compiles/verifies, engine runs, per-token
serve latency — and snapshots to JSON (:meth:`Registry.dump`). This
subsumes and extends :meth:`repro_torch.engine.Engine.stats`: the cache and
engine still keep their own counters for back-compat, but the same
events also land here, next to timing histograms only this layer holds.

Instruments are get-or-create by name and **keep their identity for the
process lifetime** (``reset()`` zeroes values without discarding
instruments), so call sites may cache a reference and increment
lock-cheap on the hot path. Histograms are streaming: exact
count/sum/min/max plus a bounded reservoir (deterministic per-name RNG)
for percentiles — exact below the reservoir cap, a uniform sample
above it. Percentiles use the nearest-rank definition:
``p(q) = sorted(sample)[ceil(q * len) - 1]``.
"""
from __future__ import annotations

import json
import math
import random
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "WindowedHistogram",
           "Registry", "get_registry"]


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_lock", "_v")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._v = 0

    def inc(self, n: int = 1) -> None:
        """Add ``n``."""
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        """Current value."""
        return self._v

    def _reset(self) -> None:
        with self._lock:
            self._v = 0


class Gauge:
    """Last-write-wins value."""

    __slots__ = ("name", "_v")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0

    def set(self, v: float) -> None:
        """Set the value."""
        self._v = float(v)

    @property
    def value(self) -> float:
        """Current value."""
        return self._v

    def _reset(self) -> None:
        self._v = 0.0


class Histogram:
    """Streaming histogram with reservoir-sampled percentiles."""

    DEFAULT_CAP = 4096

    __slots__ = ("name", "cap", "_lock", "_rng", "count", "total",
                 "_min", "_max", "_sample")

    def __init__(self, name: str, cap: int = DEFAULT_CAP):
        self.name = name
        self.cap = cap
        self._lock = threading.Lock()
        # Deterministic per-name reservoir so repeated runs of the same
        # workload snapshot identical percentiles.
        self._rng = random.Random(name)
        self.count = 0
        self.total = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._sample: List[float] = []

    def observe(self, v: float) -> None:
        """Record one sample."""
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._sample) < self.cap:
                self._sample.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.cap:
                    self._sample[j] = v

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the retained sample (exact while
        ``count <= cap``). ``q`` in [0, 1]; NaN when empty."""
        with self._lock:
            xs = sorted(self._sample)
        if not xs:
            return math.nan
        i = max(0, min(len(xs) - 1, math.ceil(q * len(xs)) - 1))
        return xs[i]

    @property
    def mean(self) -> float:
        """Mean of all samples (NaN when empty)."""
        return self.total / self.count if self.count else math.nan

    def snapshot(self) -> Dict[str, float]:
        """Summary statistics as a dict."""
        return {
            "count": self.count,
            "sum": self.total,
            "mean": self.mean,
            "min": self._min if self.count else math.nan,
            "max": self._max if self.count else math.nan,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
        }

    def _reset(self) -> None:
        with self._lock:
            self._rng = random.Random(self.name)
            self.count = 0
            self.total = 0.0
            self._min = math.inf
            self._max = -math.inf
            self._sample = []


class WindowedHistogram(Histogram):
    """Histogram that additionally tracks the current *window*: samples
    since the last :meth:`window` call. The cumulative view (count, sum,
    percentiles — everything :class:`Histogram` reports) keeps the whole
    run; ``window()`` snapshots just the interval and resets it, so a
    load harness can discard warmup (reset the window once steady state
    begins) and report steady-state p50/p99 that no cold-start sample
    can skew. Window percentiles are exact up to ``cap`` samples per
    interval, reservoir-sampled beyond it (own deterministic RNG, so
    repeated runs snapshot identical windows)."""

    __slots__ = ("_wrng", "_wcount", "_wtotal", "_wmin", "_wmax",
                 "_wsample")

    def __init__(self, name: str, cap: int = Histogram.DEFAULT_CAP):
        super().__init__(name, cap)
        self._wipe_window()

    def _wipe_window(self) -> None:
        self._wrng = random.Random(self.name + "/window")
        self._wcount = 0
        self._wtotal = 0.0
        self._wmin = math.inf
        self._wmax = -math.inf
        self._wsample: List[float] = []

    def observe(self, v: float) -> None:
        """Record one sample."""
        super().observe(v)
        v = float(v)
        with self._lock:
            self._wcount += 1
            self._wtotal += v
            if v < self._wmin:
                self._wmin = v
            if v > self._wmax:
                self._wmax = v
            if len(self._wsample) < self.cap:
                self._wsample.append(v)
            else:
                j = self._wrng.randrange(self._wcount)
                if j < self.cap:
                    self._wsample[j] = v

    def window(self, reset: bool = True) -> Dict[str, float]:
        """Snapshot of the current interval (same fields as
        :meth:`snapshot`, computed over window samples only), then —
        unless ``reset=False`` — start a fresh interval. The cumulative
        histogram is untouched either way."""
        with self._lock:
            xs = sorted(self._wsample)
            count, total = self._wcount, self._wtotal
            lo = self._wmin if count else math.nan
            hi = self._wmax if count else math.nan
            if reset:
                self._wipe_window()

        def pct(q: float) -> float:
            if not xs:
                return math.nan
            return xs[max(0, min(len(xs) - 1, math.ceil(q * len(xs)) - 1))]

        return {
            "count": count,
            "sum": total,
            "mean": total / count if count else math.nan,
            "min": lo,
            "max": hi,
            "p50": pct(0.50),
            "p90": pct(0.90),
            "p99": pct(0.99),
        }

    def _reset(self) -> None:
        super()._reset()
        with self._lock:
            self._wipe_window()


class Registry:
    """Named instrument store with a JSON snapshot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        """Get or create the named counter."""
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        """Get or create the named gauge."""
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str, cap: int = Histogram.DEFAULT_CAP
                  ) -> Histogram:
        """Get or create the named histogram."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(name, cap)
            return h

    def windowed_histogram(self, name: str,
                           cap: int = Histogram.DEFAULT_CAP
                           ) -> WindowedHistogram:
        """Get-or-create a :class:`WindowedHistogram`. The name is
        claimed for the windowed variant: asking for a name already held
        by a plain histogram raises (and vice versa — ``histogram()``
        happily returns a windowed one, a plain one just never has
        ``window()``)."""
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = WindowedHistogram(name, cap)
            elif not isinstance(h, WindowedHistogram):
                raise TypeError(
                    f"histogram '{name}' already exists without a window; "
                    f"pick a distinct name for the windowed variant")
            return h

    def dump(self) -> Dict:
        """JSON-ready snapshot of every instrument."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(hists.items())},
        }

    def write(self, path: str, extra: Optional[Dict] = None) -> Dict:
        """Write ``dump()`` (merged with ``extra``) to ``path``."""
        doc = self.dump()
        if extra:
            doc.update(extra)
        with open(path, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
        return doc

    def reset(self) -> None:
        """Zero every instrument **without** discarding it, so cached
        references at call sites stay live."""
        with self._lock:
            instruments = (list(self._counters.values())
                           + list(self._gauges.values())
                           + list(self._hists.values()))
        for inst in instruments:
            inst._reset()


_GLOBAL: Optional[Registry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> Registry:
    """The process-wide metrics registry."""
    global _GLOBAL
    if _GLOBAL is None:
        with _GLOBAL_LOCK:
            if _GLOBAL is None:
                _GLOBAL = Registry()
    return _GLOBAL
