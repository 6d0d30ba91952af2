"""Per-sequence PIM decode state: element streams, carry-save chain,
token emission.

Serving semantics, kept deliberately bit-exact and model-independent so
slot scheduling is testable: each *token* of a request is the
full-precision inner product (mod ``2^(2n)``) of an element stream
computed on the crossbar as a MultPIM Section-VI carry-save MAC chain —
one MAC step per element, exactly the schedule
:meth:`repro_torch.engine.Engine.inner_product` charges. The **prefill**
stream is the request's prompt against seeded weights (its inner product
is the first token, so TTFT covers queue wait + the whole prompt
stream); each **decode** stream is seeded by ``(seed, rid, t,
prev_token)`` — feeding the previous token back in means any scheduling
bug (a slot misassignment, a stale accumulator after an eviction)
corrupts every subsequent token instead of hiding.

:func:`reference_tokens` computes the same tokens in plain Python ints,
so tests can assert bit-parity of a sequence's output whether it ran
alone, joined mid-batch, or survived its neighbors' eviction.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = ["SequenceState", "token_stream", "reference_tokens",
           "zero_operands", "DECODE_ELEMS"]

# Decode elements per token (the per-token MAC chain length) unless the
# caller overrides — small so a smoke trace finishes in seconds while
# still exercising multi-pass accumulation.
DECODE_ELEMS = 4


def token_stream(req, t: int, prev_token: int, n_bits: int,
                 decode_elems: int = DECODE_ELEMS
                 ) -> Tuple[List[int], List[int]]:
    """The element stream whose inner product is token ``t`` of ``req``.

    ``t == 0`` is prefill: the prompt itself against seeded weights.
    ``t > 0`` is decode: ``decode_elems`` seeded pairs, re-seeded with
    the previously emitted token. Elements stay below ``2^(n_bits-2)``
    so a stream of up to ~16 elements cannot overflow the carry-save
    accumulator's u-stream (the same headroom the matvec benchmarks
    keep).
    """
    hi = 1 << max(1, n_bits - 2)
    if t == 0:
        a = [int(p) % hi for p in req.prompt]
        rng = np.random.default_rng([req.seed, req.rid, 0])
        x = [int(v) for v in rng.integers(0, hi, len(a))]
        return a, x
    rng = np.random.default_rng([req.seed, req.rid, t,
                                 int(prev_token) & 0xFFFFFFFF])
    a = [int(v) for v in rng.integers(0, hi, decode_elems)]
    x = [int(v) for v in rng.integers(0, hi, decode_elems)]
    return a, x


def reference_tokens(req, n_bits: int,
                     decode_elems: int = DECODE_ELEMS) -> List[int]:
    """Plain-int reference of every token the crossbar must emit."""
    mask = (1 << (2 * n_bits)) - 1
    toks: List[int] = []
    prev = 0
    for t in range(req.max_new_tokens):
        a, x = token_stream(req, t, prev, n_bits, decode_elems)
        prev = sum(ai * xi for ai, xi in zip(a, x)) & mask
        toks.append(prev)
    return toks


class SequenceState:
    """One live request's crossbar-resident decode state.

    The batcher owns a *slot* per live sequence; each scheduler step the
    sequence contributes one MAC's operands (:meth:`mac_operands`) to
    the grouped pass and absorbs the result (:meth:`absorb`). When its
    current stream drains, the carry-save accumulator recombines into a
    token; after ``max_new_tokens`` the sequence reports finished and
    its slot is freed for backfill.
    """

    def __init__(self, req, n_bits: int,
                 decode_elems: int = DECODE_ELEMS):
        self.req = req
        self.n = n_bits
        self.decode_elems = decode_elems
        self._mask = (1 << (2 * n_bits)) - 1
        self._t = 0                       # token index being computed
        self._prev = 0                    # previously emitted token
        self._s = 0                       # carry-save accumulators
        self._c = 0
        self._e = 0                       # next element index
        self._res21 = 0                   # running mod-21 token checksum
        self._stream = token_stream(req, 0, 0, n_bits, decode_elems)
        req.phase = "prefill"

    # ---------------------------------------------------------- views ----
    @property
    def finished(self) -> bool:
        """Whether every token of the request was emitted."""
        return self.req.phase == "finished"

    @property
    def phase(self) -> str:
        """The request's lifecycle phase."""
        return self.req.phase

    @property
    def steps_left(self) -> int:
        """MAC steps until the *current* token emits."""
        return len(self._stream[0]) - self._e

    @property
    def at_stream_start(self) -> bool:
        """True when the next MAC step starts a fresh accumulator chain
        (element 0 of a stream) — the resident path marks exactly these
        lanes in its per-pass fresh mask."""
        return self._e == 0

    # ----------------------------------------------------------- step ----
    def mac_operands(self) -> Tuple[int, int, int, int]:
        """``(a, b, s_i, c_i)`` for this sequence's next MAC step."""
        a, x = self._stream
        return a[self._e], x[self._e], self._s, self._c

    def check_token(self, s: int, c: int) -> bool:
        """Cheap drain-time checksum for the round-trip substrate: does
        the candidate token this step would emit match the host-tracked
        running mod-21 (mod-3 x mod-7) residue of the element stream?
        Five bits of host state per slot instead of a full recompute;
        a corrupt token slips through only on a 1-in-21 residue
        collision (the harness counts those as ``faults.escaped``).
        Call at a stream-boundary step *before* :meth:`absorb`."""
        a, x = self._stream
        exp = (self._res21 + a[self._e] * x[self._e]) % 21
        return ((int(s) + int(c)) & self._mask) % 21 == exp

    def restart_stream(self) -> None:
        """Abandon the current token's partial stream and rewind to its
        element 0 with a fresh accumulator — the recovery hook for lane
        quarantine/remap and checksum restarts. Emitted tokens are never
        rewound (the decode re-seed chain stays intact)."""
        self._e = 0
        self._s = 0
        self._c = 0
        self._res21 = 0

    def absorb(self, s: int, c: int) -> Optional[int]:
        """Fold one MAC result back in; returns the emitted token when
        this step drained the current stream, else ``None``."""
        a, x = self._stream
        self._res21 = (self._res21 + a[self._e] * x[self._e]) % 21
        self._s, self._c = int(s), int(c)
        self._e += 1
        if self._e < len(self._stream[0]):
            return None
        # Stream drained: final s + c recombination emits the token.
        return self._emit((self._s + self._c) & self._mask)

    def advance_resident(self, drained: Optional[int] = None
                         ) -> Optional[int]:
        """Resident-path counterpart of :meth:`absorb`: the accumulator
        lives in crossbar state, so nothing folds back per step — the
        caller passes the device-drained 2n-bit lane value on the step
        that drains the current stream (and ``None`` otherwise). Returns
        the emitted token exactly like :meth:`absorb`."""
        self._e += 1
        if self._e < len(self._stream[0]):
            return None
        if drained is None:
            raise ValueError(
                f"rid={self.req.rid}: stream drained this step but no "
                f"device lane value was supplied")
        return self._emit(int(drained) & self._mask)

    def _emit(self, tok: int) -> int:
        """Shared token-emission bookkeeping (stream rollover, phase
        transitions, re-seeding the next decode stream with the emitted
        token)."""
        self.req.tokens.append(tok)
        self._prev = tok
        self._t += 1
        self._s = self._c = 0
        self._e = 0
        self._res21 = 0
        if self._t >= self.req.max_new_tokens:
            self.req.phase = "finished"
            self._stream = ([], [])
        else:
            self.req.phase = "decode"
            self._stream = token_stream(self.req, self._t, self._prev,
                                        self.n, self.decode_elems)
        return tok

    # ------------------------------------------------------- reference ----
    def expected_tokens(self) -> List[int]:
        """The plain-int reference tokens of this request."""
        return reference_tokens(self.req, self.n, self.decode_elems)

    def __repr__(self) -> str:
        return (f"SequenceState(rid={self.req.rid}, phase={self.phase}, "
                f"tok {self._t}/{self.req.max_new_tokens}, "
                f"elem {self._e}/{len(self._stream[0])})")


def zero_operands() -> Tuple[int, int, int, int]:
    """Padding operands for a free slot in a grouped pass (the slot's
    columns still cycle, but 0*0+0+0 writes nothing observable)."""
    return 0, 0, 0, 0
