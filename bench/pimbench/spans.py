"""What the readers take from the program's own spans.

The port's spans (``repro_torch.obs``) record while ``torch.profiler``
records, so in a ``--trace 1`` run the process tracer holds the spans of
the profiled segment alone: the model's steps (``model.forward``,
``model.decode_step``), each PIM projection under them and its phases
(``pim.weight``, ``pim.activation``, ``pim.product``, ``pim.dequant``).
On the card each span has ``args.device_us``, which the program takes
from the profiler when it stops: the summed durations of the kernels
launched inside the span's profiler range. A program without these spans
(or without ``obs.events``) gives nothing to read, and the readers then
return None. Where steps were recorded but no phase span lies under
them, a phase's share and bytes are 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["STEP", "program_spans", "step_span", "under", "device_share",
           "bytes_per_step"]

# The step span that a cell's timed unit runs: decode steps, or whole
# jobs, whose time is the prefill's.
STEP = {"step": "model.decode_step", "job": "model.forward"}


def program_spans() -> List[dict]:
    """The complete spans the port's process tracer holds (none where the
    port has no ``obs.events``)."""
    from repro_torch import obs
    events = getattr(obs, "events", None)
    if events is None:
        return []
    return [e for e in events() if e.get("ph") == "X" and "id" in e]


def step_span(run) -> str:
    """The name of the step span of ``run``'s cell."""
    return STEP[run.traffic["window_unit"]]


def under(spans: List[dict], name: str, step: str) -> List[dict]:
    """The spans named ``name`` that a ``step`` span encloses (through
    any depth of parents)."""
    by_id: Dict[int, dict] = {e["id"]: e for e in spans}
    out = []
    for e in spans:
        if e["name"] != name:
            continue
        p = by_id.get(e.get("parent"))
        while p is not None and p["name"] != step:
            p = by_id.get(p.get("parent"))
        if p is not None:
            out.append(e)
    return out


def _device_us(spans: List[dict]) -> Optional[float]:
    """Σ ``device_us`` of ``spans``, None if any lacks it."""
    times = [e.get("args", {}).get("device_us") for e in spans]
    if any(t is None for t in times):
        return None
    return sum(times)


def device_share(spans: List[dict], phase: str, step: str
                 ) -> Optional[float]:
    """100 × Σ ``device_us`` of the ``phase`` spans under ``step`` spans
    over Σ ``device_us`` of the ``step`` spans: 0 when no ``phase`` span
    lies under them, None without ``step`` spans or their device time."""
    whole = _device_us([e for e in spans if e["name"] == step])
    if not whole:
        return None
    part = _device_us(under(spans, phase, step))
    if part is None:
        return None
    return 100.0 * part / whole


def bytes_per_step(spans: List[dict], phase: str, step: str
                   ) -> Optional[float]:
    """Σ ``args.bytes`` of the ``phase`` spans under ``step`` spans over
    the number of ``step`` spans: 0 when no ``phase`` span lies under
    them, None without ``step`` spans."""
    steps = sum(1 for e in spans if e["name"] == step)
    if not steps:
        return None
    return sum(e["args"]["bytes"] for e in under(spans, phase, step)) / steps
