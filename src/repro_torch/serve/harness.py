"""Closed-loop load harness: replay a trace, report SLOs, gate speedup.

:func:`run_load` replays a generated trace against one
:class:`~repro_torch.serve.batcher.ContinuousBatcher` in real time — requests
are submitted when the wall clock passes their arrival stamp, the
batcher steps whenever anything is live or queued — and distills a
:class:`LoadReport`: tokens/sec, per-request TTFT and per-token latency
percentiles (steady-state window, warmup excluded), queue wait, and the
engine's compile count delta after warmup (the zero-recompile gate).

:func:`compare_modes` replays the *same* trace (via
:meth:`Request.fresh`) under resident continuous batching
(``continuous``), the per-pass host round-trip it replaced
(``roundtrip``), and serial one-request-at-a-time scheduling
(``serial`` — what serving looked like before this subsystem), checks
all modes emit bit-identical tokens, and reports both throughput ratios
the acceptance gates demand (continuous/serial and
continuous/roundtrip).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Union

from repro_torch import obs

from .batcher import ContinuousBatcher
from .request import Request, RequestQueue
from .sequence import DECODE_ELEMS, reference_tokens

__all__ = ["LoadReport", "run_load", "compare_modes"]


@dataclass
class LoadReport:
    """What one replay of a trace measured."""

    mode: str
    n_requests: int = 0
    n_tokens: int = 0
    wall_s: float = 0.0               # first submit -> last token
    tokens_per_s: float = 0.0
    passes: int = 0
    steps: int = 0
    recompiles: int = 0               # compile events after warmup()
    bit_exact: bool = True            # every request matched reference
    aborted: bool = False             # watchdog killed a stalled run
    rejected: int = 0                 # requests shed (capacity exhausted)
    escaped_tokens: int = 0           # corrupt tokens detection missed
    # Steady-state percentiles (us), from the obs windowed histograms —
    # the window resets once `warmup_frac` of requests finished, so
    # these exclude cold-start effects.
    ttft_us: Dict[str, float] = field(default_factory=dict)
    token_latency_us: Dict[str, float] = field(default_factory=dict)
    queue_wait_us: Dict[str, float] = field(default_factory=dict)

    def summary(self) -> Dict[str, float]:
        """Flat dict for BENCH json / metric gating."""
        return {
            "mode": self.mode,
            "n_requests": self.n_requests,
            "n_tokens": self.n_tokens,
            "wall_s": round(self.wall_s, 6),
            "tokens_per_s": round(self.tokens_per_s, 3),
            "passes": self.passes,
            "recompiles": self.recompiles,
            "bit_exact": self.bit_exact,
            "aborted": self.aborted,
            "rejected": self.rejected,
            "escaped_tokens": self.escaped_tokens,
            "ttft_p50_us": self.ttft_us.get("p50", 0.0),
            "ttft_p99_us": self.ttft_us.get("p99", 0.0),
            "token_p50_us": self.token_latency_us.get("p50", 0.0),
            "token_p99_us": self.token_latency_us.get("p99", 0.0),
        }


def run_load(engine, requests: List[Request], *, mode: str = "continuous",
             n_bits: int = 8, decode_elems: int = DECODE_ELEMS,
             max_slots: Optional[int] = None, priority: str = "prefill",
             backend: Union[None, str, object] = None,
             warmup_frac: float = 0.25,
             realtime: bool = True,
             watchdog_s: Optional[float] = None) -> LoadReport:
    """Replay ``requests`` (a generated trace) and measure.

    ``mode="continuous"`` serves with continuous batching on the
    device-resident lane path (falling back to round-trip only when the
    backend cannot host resident chains); ``mode="roundtrip"`` forces
    the dynamic-K co-scheduled host round-trip path (the pre-resident
    substrate, kept as the speedup baseline); ``mode="serial"`` pins
    ``max_slots=1, ladder=(1,)`` — the one-request-at-a-time baseline.
    ``realtime=False`` ignores arrival stamps and enqueues everything up
    front (pure throughput mode, used by tests to stay deterministic
    under slow CI machines).

    ``watchdog_s`` arms a stall watchdog: the serve loop runs on a
    worker thread and the harness aborts cleanly — partial stats,
    ``aborted=True``, ``serve.watchdog.aborts`` counter — if no
    scheduler progress (steps, passes, tokens, finishes) lands within
    the budget. ``None`` (default) keeps the fully synchronous loop.
    """
    if mode not in ("continuous", "roundtrip", "serial"):
        raise ValueError(
            f"mode {mode!r} not in ('continuous', 'roundtrip', 'serial')")
    reqs = sorted((r.fresh() for r in requests), key=lambda r: r.arrival)
    queue = RequestQueue()
    kwargs = dict(n_bits=n_bits, decode_elems=decode_elems,
                  priority=priority, backend=backend,
                  watchdog_s=watchdog_s)
    if mode == "serial":
        kwargs.update(max_slots=1, ladder=(1,), resident=False)
    elif mode == "roundtrip":
        kwargs.update(max_slots=max_slots, resident=False)
    else:
        kwargs.update(max_slots=max_slots)
    b = ContinuousBatcher(engine, queue, **kwargs)
    b.warmup()
    compiles0 = engine.stats()["compiles"]

    # The windowed histograms are process-global; wipe their windows so
    # this run's percentiles don't inherit a previous run's samples.
    for h in (b._h_ttft, b._h_tok, b._h_wait):
        h.window(reset=True)

    n = len(reqs)
    steady_at = max(1, int(warmup_frac * n)) if n else 0
    prog = {"steps": 0, "steady_reset": False}
    pending = list(reqs)
    t0 = time.perf_counter()

    def serve_loop() -> None:
        while pending or not b.idle:
            now = time.perf_counter()
            elapsed = now - t0
            if realtime:
                while pending and pending[0].arrival <= elapsed:
                    queue.submit(pending.pop(0), now)
            else:
                while pending:
                    queue.submit(pending.pop(0), now)
            if b.live or len(queue) or b._displaced:
                b.step(now)
                prog["steps"] += 1
            elif pending:
                time.sleep(min(1e-3, max(0.0,
                                         pending[0].arrival - elapsed)))
            if (not prog["steady_reset"]
                    and len(b.finished_reqs) >= steady_at):
                # Steady state: drop warmup samples from the windows so
                # the reported percentiles describe the regime users at
                # scale actually sit in.
                for h in (b._h_ttft, b._h_tok, b._h_wait):
                    h.window(reset=True)
                prog["steady_reset"] = True

    aborted = False
    with obs.span("serve.load", mode=mode, n_requests=n,
                  watchdog_s=watchdog_s):
        if watchdog_s is None:
            serve_loop()
        else:
            worker = threading.Thread(target=serve_loop, daemon=True,
                                      name="serve-load")
            worker.start()
            snap = None
            snap_t = time.perf_counter()
            while worker.is_alive():
                worker.join(timeout=min(0.05, watchdog_s / 4))
                cur = (prog["steps"], b.passes, b.tokens_emitted,
                       len(b.finished_reqs), len(b.rejected_reqs),
                       len(queue), len(pending))
                now = time.perf_counter()
                if cur != snap:
                    snap, snap_t = cur, now
                elif now - snap_t > watchdog_s:
                    # Stalled mid-step: abandon the worker (daemon) and
                    # report what completed. A hung device call cannot
                    # be interrupted from here — clean abort with
                    # partial stats is the contract.
                    aborted = True
                    obs.counter("serve.watchdog.aborts").inc()
                    obs.instant("serve.watchdog.abort", mode=mode,
                                stalled_s=now - snap_t,
                                steps=prog["steps"])
                    break
    t_end = time.perf_counter()

    rep = LoadReport(mode=mode, aborted=aborted)
    rep.n_requests = len(b.finished_reqs)
    rep.n_tokens = b.tokens_emitted
    rep.wall_s = t_end - t0
    rep.tokens_per_s = (rep.n_tokens / rep.wall_s if rep.wall_s else 0.0)
    rep.passes = b.passes
    rep.steps = prog["steps"]
    rep.recompiles = engine.stats()["compiles"] - compiles0
    rep.rejected = len(b.rejected_reqs)
    escaped = 0
    for req in b.finished_reqs:
        want = reference_tokens(req, n_bits, decode_elems)
        if req.tokens != want:
            escaped += (abs(len(req.tokens) - len(want))
                        + sum(1 for g, w in zip(req.tokens, want)
                              if g != w))
    if escaped:
        rep.bit_exact = False
        rep.escaped_tokens = escaped
        obs.counter("faults.escaped").inc(escaped)
    rep.ttft_us = b._h_ttft.window(reset=True)
    rep.token_latency_us = b._h_tok.window(reset=True)
    rep.queue_wait_us = b._h_wait.window(reset=True)
    return rep


def compare_modes(engine, requests: List[Request], *,
                  n_bits: int = 8, decode_elems: int = DECODE_ELEMS,
                  max_slots: Optional[int] = None,
                  priority: str = "prefill",
                  backend: Union[None, str, object] = None,
                  realtime: bool = True) -> Dict[str, object]:
    """Replay one trace under continuous (resident), round-trip, and
    serial scheduling.

    Returns ``{"continuous": LoadReport, "roundtrip": LoadReport,
    "serial": LoadReport, "speedup": float, "resident_speedup": float,
    "tokens_match": bool}`` — ``speedup`` is the continuous-over-serial
    tokens/sec ratio the original acceptance gate (>= 3x) checks,
    ``resident_speedup`` the continuous-over-roundtrip ratio the
    resident-execution gate (>= 2x on a packed device backend) checks,
    and ``tokens_match`` asserts all three schedules emitted
    bit-identical tokens per request (scheduling and execution substrate
    must never change results).
    """
    cont = run_load(engine, requests, mode="continuous", n_bits=n_bits,
                    decode_elems=decode_elems, max_slots=max_slots,
                    priority=priority, backend=backend, realtime=realtime)
    rt = run_load(engine, requests, mode="roundtrip", n_bits=n_bits,
                  decode_elems=decode_elems, max_slots=max_slots,
                  priority=priority, backend=backend, realtime=realtime)
    ser = run_load(engine, requests, mode="serial", n_bits=n_bits,
                   decode_elems=decode_elems, backend=backend,
                   realtime=realtime)
    speedup = (cont.tokens_per_s / ser.tokens_per_s
               if ser.tokens_per_s else 0.0)
    resident_speedup = (cont.tokens_per_s / rt.tokens_per_s
                        if rt.tokens_per_s else 0.0)
    return {"continuous": cont, "roundtrip": rt, "serial": ser,
            "speedup": speedup, "resident_speedup": resident_speedup,
            "tokens_match": (cont.bit_exact and rt.bit_exact
                             and ser.bit_exact)}
