"""ContinuousBatcher: live sequences share co-scheduled crossbar passes.

The unit of serving work goes from "one request end-to-end" to "one
grouped pass per scheduler step": every step the batcher (1) backfills
freed slots from the queue (admission policy permitting), (2) gathers
each live sequence's next MAC operands, (3) sizes the pass to the
smallest precompiled K-rung that holds the live batch (dynamic K — "K
MACs per pass" is a function of live load, not a CLI flag), (4) issues
**one** :class:`~repro_torch.engine.executable.BatchedExecutable` pass whose
per-op scatter/gather slots carry the live sequences, and (5) scatters
results back, emitting tokens and freeing the slots of finished
sequences mid-stream.

The default execution substrate is **device-resident** (``resident``):
slots map to packed crossbar *rows* (lanes) of one
:class:`~repro_torch.engine.executable.ResidentExecutable`, the carry-save
accumulators live in device state between passes, and a scheduler step
ships only each live slot's new ``(a, b)`` element pair plus a one-bit
fresh mask — no per-pass unmarshal/re-marshal of ``(s, c)``, no
``backend.unpack`` between passes, and a drain only on steps where some
lane finishes a token. ``resident=False`` keeps the co-scheduled
column-slot round-trip path (the baseline the speedup gate compares
against, and the fallback for backends without resident support).

In both modes a sequence joining or leaving is a slot-assignment change,
never a recompile: the K-rung executables / the resident program triple
are memoized on the engine and precompiled by
:meth:`ContinuousBatcher.warmup`, so steady-state serving performs
**zero recompiles** (the load harness and the CI smoke scenario both
enforce this). Idle slots pad with zero operands; their columns/lanes
still cycle but touch nothing observable.

**Self-healing under device faults** (`repro_torch.faults`): when the backend
carries an active fault model, the resident executable detects and
replays corrupted lanes at every drain; lanes it reports *unrecovered*
restart their sequence's current token stream in place, and a lane that
fails ``lane_fail_threshold`` consecutive drains (a stuck-at fault
replay cannot beat) is **quarantined** — masked out of the executable's
checks, removed from the assignable slot set, its sequence remapped to
a spare slot (or parked for the next free one). All of it is pure slot
reassignment: zero recompiles, and the fresh-lane mask is the restart
substrate. The round-trip substrate instead runs a cheap host-side
mod-21 token checksum (:meth:`SequenceState.check_token`) with bounded
stream restarts. When quarantine exhausts every slot the batcher sheds
load: queued work is rejected with ``phase="rejected"`` rather than
hanging. A ``watchdog_s`` budget flags scheduler steps that overrun it
(``serve.watchdog.slow_passes``) — the harness layers a hard abort on
top.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.engine.backends import (backend_fault_model, resolve_backend,
                                   supports_resident)
from repro_torch.faults import RetryPolicy

from .request import AdmissionController, Request, RequestQueue
from .sequence import DECODE_ELEMS, SequenceState, zero_operands

__all__ = ["ContinuousBatcher", "StepStats"]


@dataclass
class StepStats:
    """What one scheduler step did (returned by :meth:`step`)."""

    live: int = 0                 # sequences served by the pass
    k: int = 0                    # pass width (co-scheduled slots)
    admitted: int = 0
    tokens: int = 0               # tokens emitted this step
    finished: List[int] = field(default_factory=list)   # rids freed
    queue_depth: int = 0


class ContinuousBatcher:
    """Admission-controlled continuous batching over one Engine.

    ``ladder`` is the set of co-schedule widths the scheduler may size a
    pass to (default: the engine's pow2 :meth:`~repro_torch.engine.Engine.
    k_ladder` for the MAC at ``n_bits``, clamped by ``max_slots``).
    Passing a single-element ladder pins the batch width; ``max_slots=1`` with
    ``ladder=(1,)`` degenerates to serial one-request-at-a-time serving
    — the baseline the speedup gate compares against.

    ``resident`` selects the execution substrate: ``None`` (default)
    uses the device-resident lane path whenever the backend supports it
    (:func:`repro_torch.engine.backends.supports_resident`) and falls back to
    the round-trip path otherwise; ``True`` requires it; ``False``
    forces the round-trip path. In resident mode the pass width is
    always ``max_slots`` lanes (dynamic K does not apply — an idle lane
    costs one packed bit, not a column range).
    """

    def __init__(self, engine, queue: Optional[RequestQueue] = None, *,
                 n_bits: int = 8, decode_elems: int = DECODE_ELEMS,
                 max_slots: Optional[int] = None,
                 ladder: Optional[Sequence[int]] = None,
                 priority: str = "prefill",
                 backend: Union[None, str, object] = None,
                 resident: Optional[bool] = None,
                 watchdog_s: Optional[float] = None,
                 retry: Optional[RetryPolicy] = None,
                 lane_fail_threshold: int = 2,
                 clock=time.perf_counter):
        self.engine = engine
        self.queue = queue if queue is not None else RequestQueue()
        self.n = n_bits
        self.decode_elems = decode_elems
        self.backend = backend
        self.clock = clock
        self.watchdog_s = watchdog_s
        bk = resolve_backend(backend, engine.backend)
        self.fault_model = backend_fault_model(bk)
        self.retry = retry if retry is not None else RetryPolicy(
            scope="serve.restart")
        self.lane_fail_threshold = int(lane_fail_threshold)
        if resident is None:
            self.resident = supports_resident(bk)
        else:
            self.resident = bool(resident)
            if self.resident and not supports_resident(bk):
                raise ValueError(
                    f"resident=True but backend '{bk.name}' does not "
                    f"support resident execution (torch needs "
                    f"pack=true)")
        self._rex = None              # ResidentExecutable, built lazily
        if ladder is None:
            ladder = engine.k_ladder("mac", n_bits, max_k=max_slots)
        self.ladder: Tuple[int, ...] = tuple(sorted(set(int(k)
                                                        for k in ladder)))
        if not self.ladder:
            raise ValueError(
                f"no ladder rung fits: a {n_bits}-bit MAC exceeds the "
                f"crossbar column budget even alone")
        # max_slots may exceed the top rung when the budget spans a
        # device hierarchy's parallel crossbars
        # (plan_serve_slots(..., device=...)): the round-trip path then
        # drains the live set as one <= top-rung pass per crossbar, the
        # resident path simply maps slots onto that many packed lanes.
        self.max_slots = (int(max_slots) if max_slots is not None
                          else self.ladder[-1])
        self.admission = AdmissionController(self.queue, self.max_slots,
                                             priority=priority)
        self.slots: List[Optional[SequenceState]] = [None] * self.max_slots
        self.passes = 0
        self.tokens_emitted = 0
        self.finished_reqs: List[Request] = []
        # Self-healing state: quarantined lanes, consecutive unrecovered
        # drains per lane, sequences awaiting a spare slot, per-request
        # consecutive checksum restarts (round-trip substrate), and the
        # requests shed once capacity is exhausted.
        self._bad_slots: set = set()
        self._lane_fails = np.zeros(self.max_slots, dtype=np.int64)
        self._displaced: List[SequenceState] = []
        self._tok_retries: dict = {}
        self.rejected_reqs: List[Request] = []
        # Cached instrument refs (hot path — see repro_torch.obs.metrics).
        self._m_tok = obs.counter("serve.sched.tokens")
        self._m_pass = obs.counter("serve.sched.passes")
        self._m_adm = obs.counter("serve.sched.admitted")
        self._m_qd = obs.gauge("serve.sched.queue_depth")
        self._m_occ = obs.gauge("serve.sched.slot_occupancy")
        self._m_k = obs.gauge("serve.sched.k")
        self._h_ttft = obs.windowed_histogram("serve.sched.ttft_us")
        self._h_tok = obs.windowed_histogram("serve.sched.token_latency_us")
        self._h_wait = obs.windowed_histogram("serve.sched.queue_wait_us")
        self._m_restart = obs.counter("serve.fault.restarts")
        self._m_quar = obs.counter("serve.fault.quarantined")
        self._m_disp = obs.counter("serve.fault.displaced")
        self._m_rej = obs.counter("serve.rejected")
        self._m_slow = obs.counter("serve.watchdog.slow_passes")
        self._g_quar = obs.gauge("serve.fault.quarantined_lanes")

    # -------------------------------------------------------- compile ----
    def _resident_exe(self):
        if self._rex is None:
            self._rex = self.engine.resident(self.n, rows=self.max_slots,
                                             backend=self.backend)
        return self._rex

    def warmup(self) -> None:
        """Precompile the execution substrate so no scheduler step ever
        compiles: every K-rung's fused executable in round-trip mode,
        the mac/stage/recomb program triple (plus a throwaway
        load/step/drain to warm the backend's jit caches) in resident
        mode. Call once before taking traffic; the zero-recompile gate
        measures from here."""
        with obs.span("serve.sched.warmup", ladder=str(self.ladder),
                      resident=self.resident):
            if self.resident:
                rex = self._resident_exe()
                z = np.zeros(self.max_slots, dtype=np.int64)
                rex.step(z, z)
                rex.step(z, z, fresh=np.ones(self.max_slots, dtype=bool))
                rex.drain()
                rex.reset()
            else:
                for k in self.ladder:
                    self.engine.compile_batch("mac", self.n, k)

    # ----------------------------------------------------------- state ----
    @property
    def live(self) -> int:
        """Occupied slots."""
        return sum(1 for s in self.slots if s is not None)

    @property
    def capacity(self) -> int:
        """Slots still assignable after lane quarantine."""
        return self.max_slots - len(self._bad_slots)

    @property
    def idle(self) -> bool:
        """Nothing live, queued or awaiting a spare slot."""
        return (self.live == 0 and len(self.queue) == 0
                and not self._displaced)

    def _free_slot(self) -> Optional[int]:
        """First assignable slot: empty and not quarantined."""
        for i, s in enumerate(self.slots):
            if s is None and i not in self._bad_slots:
                return i
        return None

    def _choose_k(self, live: int) -> int:
        """Smallest precompiled rung that holds the live batch."""
        for k in self.ladder:
            if k >= live:
                return k
        return self.ladder[-1]

    # ------------------------------------------------------------ step ----
    def _reject(self, req: Request, reason: str) -> None:
        """Shed one request with a clear terminal state instead of
        letting it starve in the queue."""
        req.phase = "rejected"
        self.rejected_reqs.append(req)
        self._m_rej.inc()
        obs.instant("serve.reject", rid=req.rid, reason=reason)

    def _admit(self, now: float) -> int:
        # Displaced sequences (quarantine survivors) outrank the queue:
        # they already hold emitted tokens and restart their current
        # stream on whatever spare lane frees up first.
        while self._displaced:
            slot = self._free_slot()
            if slot is None:
                break
            self.slots[slot] = self._displaced.pop(0)
            obs.instant("serve.remap", rid=self.slots[slot].req.rid,
                        slot=slot)
        # Quarantine shrinks the admission budget; at zero capacity the
        # batcher degrades by shedding instead of hanging.
        self.admission.max_live = max(1, self.capacity)
        if self.capacity == 0:
            for seq in self._displaced:
                self._reject(seq.req, "no healthy lanes")
            self._displaced.clear()
            while True:
                req = self.queue.pop()
                if req is None:
                    break
                self._reject(req, "no healthy lanes")
            return 0
        admitted = self.admission.admit(self.live + len(self._displaced),
                                        now)
        for req in admitted:
            slot = self._free_slot()
            if slot is None:        # budget raced a quarantine: requeue
                self.queue.submit(req, req.t_submit)
                break
            self.slots[slot] = SequenceState(req, self.n,
                                             self.decode_elems)
            wait = (now - req.t_submit) if req.t_submit is not None else 0.0
            self._h_wait.observe(wait * 1e6)
            obs.instant("serve.admit", rid=req.rid, slot=slot,
                        queue_wait_us=wait * 1e6)
        if admitted:
            self._m_adm.inc(len(admitted))
        return len(admitted)

    def step(self, now: Optional[float] = None) -> StepStats:
        """One scheduler step: admit, gather, one grouped pass, scatter.

        Returns :class:`StepStats`; a no-op (nothing live, nothing
        admissible) returns ``live=0`` without touching the engine.
        """
        now = self.clock() if now is None else now
        t_start = self.clock()
        st = StepStats(queue_depth=len(self.queue))
        st.admitted = self._admit(now)
        seqs = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        st.live = len(seqs)
        st.queue_depth = len(self.queue)
        if not seqs:
            self._m_qd.set(st.queue_depth)
            self._m_occ.set(0.0)
            return st

        if self.resident:
            self._step_resident(st, seqs)
        else:
            self._step_roundtrip(st, seqs)

        if self.watchdog_s is not None:
            dur = self.clock() - t_start
            if dur > self.watchdog_s:
                self._m_slow.inc()
                obs.instant("serve.watchdog.slow_pass", dur_s=dur,
                            budget_s=self.watchdog_s)

        if st.tokens:
            self.tokens_emitted += st.tokens
            self._m_tok.inc(st.tokens)
        self._m_qd.set(st.queue_depth)
        self._m_occ.set(st.live / self.max_slots)
        self._m_k.set(st.k)
        obs.track("serve.sched", queue_depth=st.queue_depth,
                  live=st.live, k=st.k)
        return st

    def _note_token(self, st: StepStats, slot: int, seq: SequenceState,
                    t_emit: float) -> None:
        """Per-token bookkeeping shared by both substrates: latency
        histograms, TTFT, eviction of finished sequences (their slots
        backfill next step, mid-stream for the survivors)."""
        st.tokens += 1
        req = seq.req
        # Per-token latency: time since this request's previous token;
        # token 0 anchors at admission (TTFT covers the queue wait and
        # is tracked separately).
        anchor = (req.t_last_tok if req.t_last_tok is not None
                  else req.t_admit)
        if anchor is not None:
            self._h_tok.observe((t_emit - anchor) * 1e6)
        req.t_last_tok = t_emit
        if req.t_first is None:
            req.t_first = t_emit
            if req.t_submit is not None:
                self._h_ttft.observe((t_emit - req.t_submit) * 1e6)
        if seq.finished:
            req.t_done = t_emit
            self.slots[slot] = None
            st.finished.append(req.rid)
            self.finished_reqs.append(req)
            obs.instant("serve.finish", rid=req.rid, slot=slot,
                        tokens=len(req.tokens))

    def _step_resident(self, st: StepStats, seqs) -> None:
        """One resident pass: slots are packed crossbar lanes of a
        single :class:`ResidentExecutable` — ship each live slot's new
        ``(a, b)`` element, mark stream-start lanes fresh, advance every
        lane in place, and drain (one device read) only on steps where
        some lane finishes its token's stream. Idle lanes carry zero
        operands; an evicted lane's stale state is reset by the fresh
        mask the moment a new sequence lands on it."""
        st.k = self.max_slots
        rex = self._resident_exe()
        with obs.span("serve.sched.step", live=st.live, k=st.k,
                      queue_depth=st.queue_depth, resident=True):
            a = np.zeros(self.max_slots, dtype=np.int64)
            b = np.zeros(self.max_slots, dtype=np.int64)
            fresh = np.zeros(self.max_slots, dtype=bool)
            boundary = set()
            for slot, seq in seqs:
                ai, bi, _, _ = seq.mac_operands()
                a[slot] = ai
                b[slot] = bi
                fresh[slot] = seq.at_stream_start
                if seq.steps_left == 1:
                    boundary.add(slot)
            rex.step(a, b, fresh=fresh)
            self.passes += 1
            self._m_pass.inc()

            drained = rex.drain() if boundary else None
            skip = (self._heal_lanes(rex, seqs)
                    if drained is not None and self.fault_model is not None
                    else set())
            t_emit = self.clock()
            for slot, seq in seqs:
                if slot in skip:
                    continue
                val = int(drained[slot]) if slot in boundary else None
                tok = seq.advance_resident(val)
                if tok is not None:
                    self._note_token(st, slot, seq, t_emit)

    def _heal_lanes(self, rex, seqs) -> set:
        """Post-drain self-healing: every lane the executable could not
        recover restarts its sequence's current token stream (the fresh
        mask rebuilds the accumulator next pass); a lane that stays
        unrecovered ``lane_fail_threshold`` drains in a row is a stuck
        fault replay cannot beat — quarantine it and remap its sequence
        to a spare slot (or park it until one frees). Returns the slots
        whose sequences must not advance on this (corrupt) drain."""
        unrec = np.asarray(rex.unrecovered, dtype=bool)
        self._lane_fails[~unrec] = 0
        if not unrec.any():
            return set()
        skip = set()
        by_slot = dict(seqs)
        for slot in np.flatnonzero(unrec):
            slot = int(slot)
            self._lane_fails[slot] += 1
            seq = by_slot.get(slot)
            if seq is not None:
                skip.add(slot)
                seq.restart_stream()
                self._m_restart.inc()
                obs.instant("serve.fault.restart", rid=seq.req.rid,
                            slot=slot, fails=int(self._lane_fails[slot]))
            if self._lane_fails[slot] < self.lane_fail_threshold:
                continue
            # Persistently failing: quarantine the lane, spare the work.
            self._bad_slots.add(slot)
            rex.quarantine([slot])
            self._m_quar.inc()
            self._g_quar.set(len(self._bad_slots))
            obs.instant("serve.quarantine", slot=slot,
                        lanes=len(self._bad_slots))
            if seq is not None:
                self.slots[slot] = None
                j = self._free_slot()
                if j is not None:
                    self.slots[j] = seq
                    obs.instant("serve.remap", rid=seq.req.rid, slot=j)
                else:
                    self._displaced.append(seq)
                    self._m_disp.inc()
        return skip

    def _step_roundtrip(self, st: StepStats, seqs) -> None:
        """Co-scheduled round-trip passes (the original path): marshal every
        live slot's full latch state in, one fused K-wide pass per
        crossbar-sized chunk, unmarshal and fold ``(s, c)`` back on the
        host. With a single-crossbar budget (``max_slots <= top rung``)
        this is exactly one pass; a device-scaled budget drains the live
        set in ``ceil(live / top rung)`` passes — one per parallel
        crossbar, issued back-to-back here since the host models the
        crossbars as concurrent."""
        top = self.ladder[-1]
        chunks = [seqs[lo:lo + top] for lo in range(0, len(seqs), top)]
        st.k = self._choose_k(min(st.live, top))
        with obs.span("serve.sched.step", live=st.live, k=st.k,
                      queue_depth=st.queue_depth,
                      crossbars=len(chunks)):
            for chunk in chunks:
                k = self._choose_k(len(chunk))
                # Gather: live sequences ride the first slots of the
                # K-wide fused pass (slot-order stable), the rest pad
                # with zero operands. Marshal all K operand sets as one
                # batch per stream so mac_inputs is called once per slot.
                groups = []
                for _, seq in chunk:
                    a, b, s_i, c_i = seq.mac_operands()
                    groups.append(self.engine.mac_inputs(
                        self.n, np.array([a], dtype=object),
                        np.array([b], dtype=object),
                        np.array([s_i], dtype=object),
                        np.array([c_i], dtype=object)))
                if k > len(chunk):
                    a, b, s_i, c_i = zero_operands()
                    pad = self.engine.mac_inputs(
                        self.n, np.array([a], dtype=object),
                        np.array([b], dtype=object),
                        np.array([s_i], dtype=object),
                        np.array([c_i], dtype=object))
                    groups.extend([pad] * (k - len(chunk)))

                bex = self.engine.compile_batch("mac", self.n, k)
                outs = bex.run(groups, backend=self.backend)
                self.passes += 1
                self._m_pass.inc()

                # Scatter: fold each slot's MAC result back into its
                # sequence and emit tokens. Under an active fault model
                # each stream-boundary step first runs the cheap mod-21
                # token checksum; a mismatch restarts the stream (bounded
                # per request by the retry policy) instead of emitting a
                # corrupt token.
                t_emit = self.clock()
                for (slot, seq), out in zip(chunk, outs):
                    s, c = self.engine.mac_accumulate(self.n, out)
                    si, ci = int(s[0]), int(c[0])
                    if (self.fault_model is not None
                            and seq.steps_left == 1
                            and not seq.check_token(si, ci)):
                        obs.counter("faults.detected").inc()
                        rid = seq.req.rid
                        tries = self._tok_retries.get(rid, 0)
                        if tries < self.retry.max_retries:
                            self._tok_retries[rid] = tries + 1
                            self.retry.note_retry(tries, sleep=False)
                            seq.restart_stream()
                            self._m_restart.inc()
                            obs.instant("serve.fault.restart", rid=rid,
                                        slot=slot, tries=tries + 1)
                            continue
                        # Bounded: give up and emit the corrupt token
                        # (the harness's reference check counts it).
                        self._tok_retries.pop(rid, None)
                        self.retry.note_exhausted()
                        obs.counter("faults.unrecovered").inc()
                    tok = seq.absorb(si, ci)
                    if tok is not None:
                        if self._tok_retries.pop(seq.req.rid, None):
                            obs.counter("faults.recovered").inc()
                        self._note_token(st, slot, seq, t_emit)

    # ------------------------------------------------------------ drain ----
    def run_until_idle(self, max_steps: int = 1_000_000) -> int:
        """Step until queue and slots are empty; returns steps taken."""
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        return steps
