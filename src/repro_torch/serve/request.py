"""Requests, the FCFS queue, and admission control.

A :class:`Request` is one user's generate call: a prompt (the element
stream whose inner product prefills the sequence and emits the first
token) plus a decode budget (``max_new_tokens``). The scheduler tracks
it through ``queued -> prefill -> decode -> finished`` and stamps the
latency-defining moments (submit, admit, first token, done) so the
harness can report TTFT and per-token latency per request.

:class:`RequestQueue` is the thread-safe FCFS ingress: a traffic
generator (or a real frontend thread) ``submit()``s, the batcher
``admit()``s into freed slots. :class:`AdmissionController` owns the
policy — how many sequences may be live at once (the *slot budget*,
derived from the engine's crossbar column budget, see
:func:`repro_torch.pim.planner.plan_serve_slots`) and whether freed slots
backfill eagerly (``prefill`` priority: new requests join mid-stream,
best TTFT) or only once the current batch drains (``decode`` priority:
running sequences keep every pass to themselves, best per-token
latency).
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

__all__ = ["PHASES", "Request", "RequestQueue", "AdmissionController"]

# Lifecycle (strictly forward): queued -> prefill -> decode -> finished.
PHASES = ("queued", "prefill", "decode", "finished")


@dataclass
class Request:
    """One generate request plus its runtime bookkeeping.

    ``prompt`` holds the prefill element stream (unsigned ints; keep
    them below ``2^(n_bits-2)`` so the carry-save accumulator's u-stream
    stays in range — the traffic generator enforces this). ``seed``
    feeds the decode element streams, which also hash in each previously
    emitted token so any scheduling bug propagates into every later
    token instead of hiding.
    """

    rid: int
    arrival: float                    # seconds since trace start
    prompt: Tuple[int, ...]
    max_new_tokens: int = 1
    seed: int = 0

    # runtime (stamped by the scheduler; perf_counter seconds)
    phase: str = "queued"
    tokens: List[int] = field(default_factory=list)
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    t_last_tok: Optional[float] = None

    def fresh(self) -> "Request":
        """A clean copy with all runtime state cleared — lets one
        generated trace be replayed under several scheduling modes."""
        return replace(self, phase="queued", tokens=[], t_submit=None,
                       t_admit=None, t_first=None, t_done=None,
                       t_last_tok=None)

    @property
    def n_tokens(self) -> int:
        """Tokens this request will emit in total (the prefill's inner
        product emits the first; decode emits the rest)."""
        return self.max_new_tokens

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token seconds, once both are stamped."""
        if self.t_submit is None or self.t_first is None:
            return None
        return self.t_first - self.t_submit


class RequestQueue:
    """Thread-safe FCFS request queue (the scheduler ingress)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._q: deque = deque()
        self.submitted = 0

    def submit(self, req: Request, now: Optional[float] = None) -> Request:
        """Enqueue ``req`` at time ``now``; returns it."""
        with self._lock:
            req.t_submit = now
            req.phase = "queued"
            self._q.append(req)
            self.submitted += 1
        return req

    def pop(self) -> Optional[Request]:
        """The oldest queued request, or ``None``."""
        with self._lock:
            return self._q.popleft() if self._q else None

    @property
    def depth(self) -> int:
        """Requests waiting."""
        with self._lock:
            return len(self._q)

    def __len__(self) -> int:
        return self.depth


class AdmissionController:
    """Slot-budget + backfill policy between the queue and the batcher.

    ``max_live`` is the hard cap on concurrently-live sequences (the
    crossbar slot budget). ``priority``:

    * ``"prefill"`` — a freed slot backfills immediately from the queue
      (continuous batching proper: sequences join mid-stream, minimizing
      queue wait and TTFT).
    * ``"decode"`` — admit only while *nothing* is live, i.e. drain the
      current batch fully before the next wave joins (gang scheduling:
      steadier per-token latency, worse TTFT under load).
    """

    def __init__(self, queue: RequestQueue, max_live: int,
                 priority: str = "prefill"):
        if max_live < 1:
            raise ValueError("max_live >= 1")
        if priority not in ("prefill", "decode"):
            raise ValueError(f"priority {priority!r} not in "
                             f"('prefill', 'decode')")
        self.queue = queue
        self.max_live = max_live
        self.priority = priority

    def admissible(self, live: int) -> int:
        """How many requests may join right now, given ``live``
        currently-occupied slots."""
        if live >= self.max_live:
            return 0
        if self.priority == "decode" and live > 0:
            return 0
        return self.max_live - live

    def admit(self, live: int, now: Optional[float] = None
              ) -> List[Request]:
        """Pop up to ``admissible(live)`` requests FCFS, stamping their
        admission time."""
        out: List[Request] = []
        for _ in range(self.admissible(live)):
            req = self.queue.pop()
            if req is None:
                break
            req.t_admit = now
            out.append(req)
        return out
