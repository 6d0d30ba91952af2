"""One retry/backoff policy for every recovery loop in the stack.

:class:`RetryPolicy` replaces the ad-hoc loops that used to live in
``train/fault.py`` (checkpoint-restore retries) and now also bounds the
resident executor's replay-on-corruption
(:meth:`repro_torch.engine.executable.ResidentExecutable.drain`) and the
serve batcher's round-trip checksum restarts. Semantics:

* ``max_retries`` — retries *after* the first attempt (so a call is
  tried at most ``max_retries + 1`` times), matching the historical
  ``RetryingRunner.max_retries`` contract.
* ``backoff_s`` / ``backoff_mult`` — exponential backoff between
  attempts; 0 disables sleeping entirely (the in-process replay loops
  never sleep, the train loop does).
* ``jitter`` — +/- fraction of the delay, drawn deterministically from
  ``seed`` so two runs of the same policy produce the same schedule.
* every retry increments the ``<scope>.retries`` obs counter; giving up
  increments ``<scope>.exhausted``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Type

import numpy as np

from repro_torch import obs

__all__ = ["RetryPolicy", "DEFAULT_POLICY"]


@dataclass(frozen=True)
class RetryPolicy:
    """Bounded attempts + deterministic jittered backoff (see module
    doc). Frozen so policies can be shared module-level defaults."""

    max_retries: int = 3
    backoff_s: float = 0.0
    backoff_mult: float = 2.0
    jitter: float = 0.0
    seed: int = 0
    scope: str = "retry"

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError("max_retries >= 0")

    @property
    def max_attempts(self) -> int:
        """Total tries: the first attempt plus ``max_retries``."""
        return self.max_retries + 1

    def delay_s(self, retry_idx: int) -> float:
        """Backoff before retry ``retry_idx`` (0-based), jittered
        deterministically per (seed, retry index)."""
        if self.backoff_s <= 0:
            return 0.0
        d = self.backoff_s * (self.backoff_mult ** retry_idx)
        if self.jitter > 0:
            u = np.random.default_rng([self.seed, retry_idx]).random()
            d *= 1.0 + self.jitter * (2.0 * u - 1.0)
        return float(d)

    def note_retry(self, retry_idx: int, *, sleep: bool = True) -> None:
        """Account (and optionally sleep) one retry — the hook for
        loops that manage their own control flow, like the resident
        replay."""
        obs.counter(f"{self.scope}.retries").inc()
        d = self.delay_s(retry_idx)
        if sleep and d > 0:
            time.sleep(d)

    def note_exhausted(self) -> None:
        """Account giving up after the final retry."""
        obs.counter(f"{self.scope}.exhausted").inc()

    def run(self, fn: Callable, *,
            retry_on: Tuple[Type[BaseException], ...] = (Exception,),
            on_failure: Optional[Callable] = None):
        """Call ``fn()`` with this policy: on a ``retry_on`` exception,
        invoke ``on_failure(exc, retry_idx)`` (if given), back off, and
        try again; re-raise once retries are exhausted."""
        for retry_idx in range(self.max_attempts):
            try:
                return fn()
            except retry_on as exc:
                if retry_idx >= self.max_retries:
                    self.note_exhausted()
                    raise
                if on_failure is not None:
                    on_failure(exc, retry_idx)
                self.note_retry(retry_idx)


DEFAULT_POLICY = RetryPolicy()
