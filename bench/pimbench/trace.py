"""The profiled segment of a ``--trace 1`` run, and what is read from it.

``torch.profiler`` records the host's operators and the card's kernels
(CUPTI) over a segment of the closed loop, inside a range named
:data:`WINDOW`; the PIM linear calls are ranges named :data:`PIM` (see
:mod:`pimbench.engine`). The trace is exported as Chrome trace JSON into
the run's temporary directory and read back once: a device operation
belongs to a PIM call when the host launched it inside that call's
range (the launch and the kernel share a correlation id).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["WINDOW", "PIM", "TraceSummary", "profile", "summarize"]

WINDOW = "bench.window"
PIM = "bench.pim_linear"
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH = {"cuda_runtime", "cuda_driver"}
_HOST = {"cpu_op", "user_annotation"}


@dataclass
class TraceSummary:
    """What the readers take from the trace. Times in seconds."""

    window_s: float
    busy_s: float
    device_s: float
    kernels: int
    pim_call_s: List[float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def profile(fn: Callable[[], object]):
    """``fn()`` under the profiler; returns (its result, the
    :class:`TraceSummary` of the segment)."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(WINDOW):
            result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return result, summarize(events)


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def summarize(events: List[dict]) -> TraceSummary:
    """Read a Chrome trace's events (microseconds)."""
    window = None
    pim: List[Tuple[float, float, object]] = []
    launches: Dict[object, float] = {}
    device: List[dict] = []
    host: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        if cat in _DEVICE:
            device.append(ev)
        elif cat in _LAUNCH:
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in _HOST:
            name = ev.get("name", "")
            if name == WINDOW and cat == "user_annotation":
                window = (ts, ts + dur)
            elif name == PIM and cat == "user_annotation":
                pim.append((ts, ts + dur, ev.get("tid")))
            host[ev.get("tid")].append((ts, ts + dur, name))
    if window is None:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = window
    pim.sort()
    starts = [p[0] for p in pim]
    pim_s = [0.0] * len(pim)
    by_name: Dict[str, float] = defaultdict(float)
    spans = []
    device_s = 0.0
    kernels = 0
    for ev in device:
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        a, b = max(ts, w0), min(ts + dur, w1)
        if b <= a:
            continue
        spans.append((a, b))
        device_s += b - a
        by_name[ev.get("name", "")] += b - a
        kernels += ev.get("cat") == "kernel"
        at = launches.get(ev.get("args", {}).get("correlation"))
        if at is None:
            continue
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= pim[i][1]:
            pim_s[i] += b - a
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy)
    gaps = []
    edge = w0
    for a, b in busy + [(w1, w1)]:
        if a > edge:
            gaps.append((a - edge, edge))
        edge = max(edge, b)
    gaps.sort(reverse=True)
    main = max(host.values(), key=len) if host else []
    idle = [(_host_at(main, t0), g * 1e-6) for g, t0 in gaps[:10]]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_s * 1e-6,
        device_s=device_s * 1e-6, kernels=kernels,
        pim_call_s=[t * 1e-6 for t in pim_s],
        device_ops=[(_short(n), t * 1e-6) for n, t in top], idle_gaps=idle)


def _short(name: str) -> str:
    """A kernel's name without the namespaces that every one carries."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:160]


def _host_at(spans: List[Tuple[float, float, str]], t: float) -> str:
    """The innermost host range (operator or annotation) open at ``t`` on
    the thread ``spans`` belong to, or ``python`` between operators."""
    best: Optional[Tuple[float, str]] = None
    for a, b, name in spans:
        if a <= t <= b and name != WINDOW and (best is None
                                               or b - a < best[0]):
            best = (b - a, name)
    return best[1] if best else "python"
