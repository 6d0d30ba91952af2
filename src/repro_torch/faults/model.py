"""Seeded device-error models for the packed executors.

A :class:`FaultModel` describes three memristive failure modes, all
deterministic functions of ``(seed, geometry, pass index)`` so every
backend injects **bit-identical** faults for the same program run:

* **stuck-at cells** — per-cell stuck-at-0 / stuck-at-1 maps drawn once
  per ``(rows, cols)`` footprint (a cell that fails manufacture fails
  everywhere), enforced after every cycle as bitwise masks on the packed
  words. ``dead_rows`` pins whole crossbar rows stuck-at-0 — the
  deterministic quarantine target the serve tests lean on.
* **transient gate flips** — per-gate-evaluation bit flips at
  probability ``p_flip``, drawn per *pass* in ``(cycle, op-slot, row)``
  table space (word-size independent, so numpy's 64-bit packing and
  torch's 32-bit packing inject the same faults) and XORed into
  the gate result before the AND-write. A flip can only be observed
  where the write could have changed the cell (the AND-write masks
  0 -> 1 flips on already-zero cells), which is physically faithful.
* **drift** — an epoch-indexed schedule: every ``drift_every`` passes
  the stuck-at-0 threshold grows by ``drift_p``, monotonically
  converting more cells (conductance drift toward the reset state).

Passes are numbered by a monotone per-model counter
(:meth:`FaultModel.next_pass`) so a *retry* of a detected-corrupt pass
re-draws fresh transients — recovery-by-replay converges — while
stuck-at faults persist and drive lane quarantine instead.

Models resolve by key through :func:`get_fault_model` (the hook backend
specs use: ``"torch:pack=true,faults=flip@1e-5@7"``). ``None``/``"none"``
resolve to no model at all, keeping the zero-fault path bit-identical
to a build without this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch import obs
from repro_torch.core.bits import WORD_DTYPES, pack_rows

__all__ = ["FaultModel", "register_fault_model", "get_fault_model",
           "fault_model_names"]

# Sub-stream tags keeping the stuck-at and flip draws independent.
_SA0_STREAM = 11
_SA1_STREAM = 13
_FLIP_STREAM = 17


@dataclass
class FaultModel:
    """One named, seeded device-error configuration (see module doc).

    ``key`` is the registry name backends reference in their spec
    string; ``seed`` feeds every random draw; probabilities are per
    cell (stuck-at) or per gate-evaluation site (``p_flip``).
    """

    key: str
    seed: int = 0
    p_flip: float = 0.0
    p_sa0: float = 0.0
    p_sa1: float = 0.0
    drift_every: int = 0        # passes per drift epoch (0 = no drift)
    drift_p: float = 0.0        # stuck-at-0 probability added per epoch
    dead_rows: Tuple[int, ...] = ()

    _passes: int = field(default=0, repr=False, compare=False)
    _uniform_memo: Dict = field(default_factory=dict, repr=False,
                                compare=False)
    _stuck_memo: Dict = field(default_factory=dict, repr=False,
                              compare=False)

    # ------------------------------------------------------- lifecycle ----
    def active(self) -> bool:
        """Whether this model injects anything at all."""
        return (self.p_flip > 0 or self.p_sa0 > 0 or self.p_sa1 > 0
                or self.drift_p > 0 or bool(self.dead_rows))

    def next_pass(self) -> int:
        """Allocate the next monotone pass index (one per program
        execution). Retried passes get *new* indices, hence new
        transient draws."""
        i = self._passes
        self._passes += 1
        return i

    def reset(self) -> None:
        """Rewind the pass counter (test determinism across runs)."""
        self._passes = 0

    def epoch(self, pass_idx: int) -> int:
        """Drift epoch of a pass (0 when drift is disabled)."""
        return pass_idx // self.drift_every if self.drift_every else 0

    # ----------------------------------------------------- stuck cells ----
    def _uniforms(self, stream: int, rows: int, cols: int) -> np.ndarray:
        key = (stream, rows, cols)
        u = self._uniform_memo.get(key)
        if u is None:
            rng = np.random.default_rng([self.seed, stream, rows, cols])
            u = rng.random((rows, cols))
            self._uniform_memo[key] = u
        return u

    def stuck_bits(self, rows: int, cols: int, epoch: int = 0
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """``(sa0, sa1)`` bool maps of shape ``(rows, cols)``. Each cell
        draws one uniform per polarity; drift raises the stuck-at-0
        threshold by ``epoch * drift_p``, so later epochs strictly grow
        the sa0 set. sa1 yields to sa0 where both fire; ``dead_rows``
        force whole rows stuck-at-0."""
        key = ("bits", rows, cols, epoch)
        memo = self._stuck_memo.get(key)
        if memo is not None:
            return memo
        p0 = min(1.0, self.p_sa0 + epoch * self.drift_p)
        sa0 = self._uniforms(_SA0_STREAM, rows, cols) < p0
        sa1 = self._uniforms(_SA1_STREAM, rows, cols) < self.p_sa1
        for r in self.dead_rows:
            if 0 <= r < rows:
                sa0[r, :] = True
        sa1 &= ~sa0
        memo = (sa0, sa1)
        self._stuck_memo[key] = memo
        return memo

    def stuck_words(self, rows: int, cols: int, epoch: int,
                    word_bits: int) -> Tuple[np.ndarray, np.ndarray]:
        """The stuck maps row-packed to ``(ceil(rows/word_bits), cols)``
        words of the packed executors' dtype (memoized)."""
        key = ("words", rows, cols, epoch, word_bits)
        memo = self._stuck_memo.get(key)
        if memo is None:
            sa0, sa1 = self.stuck_bits(rows, cols, epoch)
            memo = (pack_rows(sa0.astype(np.uint8), word_bits),
                    pack_rows(sa1.astype(np.uint8), word_bits))
            self._stuck_memo[key] = memo
        return memo

    # -------------------------------------------------- transient flips ----
    def flip_events(self, pass_idx: int, n_cycles: int, n_slots: int,
                    rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Transient flip sites for one pass: ``(t, m, r)`` index arrays
        into (cycle, op-slot, row) table space. Site count is binomial
        in the site population; sites are drawn with replacement
        (duplicates OR into the same mask bit, harmlessly). Word-size
        independent by construction."""
        if self.p_flip <= 0:
            z = np.zeros(0, dtype=np.int64)
            return z, z, z
        rng = np.random.default_rng(
            [self.seed, _FLIP_STREAM, int(pass_idx)])
        n_sites = n_cycles * n_slots * rows
        k = int(rng.binomial(n_sites, self.p_flip)) if n_sites else 0
        idx = rng.integers(0, n_sites, size=k)
        t = idx // (n_slots * rows)
        rem = idx % (n_slots * rows)
        return t, rem // rows, rem % rows

    def flip_words(self, pass_idx: int, gate_id: np.ndarray, rows: int,
                   word_bits: int) -> np.ndarray:
        """Dense per-pass flip table ``(T, W, M)`` in packed words.
        Sites landing on NOP / init slots (``gate_id == 0``) are dropped
        — there is no gate evaluation there to disturb — which also
        keeps the padding scratch column bit-identical across
        backends."""
        T, M = gate_id.shape
        dt = WORD_DTYPES[word_bits]
        words = np.zeros((T, -(-rows // word_bits), M), dtype=dt)
        t, m, r = self.flip_events(pass_idx, T, M, rows)
        if len(t):
            keep = gate_id[t, m] != 0
            t, m, r = t[keep], m[keep], r[keep]
        if len(t):
            bit = np.left_shift(np.ones_like(r, dtype=dt),
                                (r % word_bits).astype(dt))
            np.bitwise_or.at(words, (t, r // word_bits, m), bit)
            obs.counter("faults.injected").inc(int(len(t)))
        return words


# -------------------------------------------------------------- registry ----
_MODELS: Dict[str, FaultModel] = {}


def register_fault_model(model: FaultModel) -> FaultModel:
    """Register (or replace) a model under its key; returns it."""
    _MODELS[model.key] = model
    return model


def fault_model_names() -> list:
    """Registered fault-model keys, sorted."""
    return sorted(_MODELS)


def _parse_compact(key: str) -> FaultModel:
    """``flip@P[@SEED]`` / ``sa0@P[@SEED]`` / ``sa1@P[@SEED]`` — the
    compact spec form CLI flags synthesize."""
    parts = key.split("@")
    if parts[0] not in ("flip", "sa0", "sa1") or len(parts) not in (2, 3):
        raise KeyError(
            f"unknown fault model '{key}' (registered: "
            f"{fault_model_names()}; compact forms: flip@P[@SEED], "
            f"sa0@P[@SEED], sa1@P[@SEED])")
    p = float(parts[1])
    seed = int(parts[2]) if len(parts) == 3 else 0
    kw = {"flip": "p_flip", "sa0": "p_sa0", "sa1": "p_sa1"}[parts[0]]
    return FaultModel(key=key, seed=seed, **{kw: p})


def get_fault_model(key: Union[None, str, FaultModel]
                    ) -> Optional[FaultModel]:
    """Resolve a backend's ``faults`` spec to a model instance.

    ``None`` / ``""`` / ``"none"`` / ``"off"`` -> ``None`` (the
    zero-fault fast path). Registered keys resolve to their shared
    instance; compact forms (``flip@1e-5@7``) auto-register on first
    use so repeated resolution shares one pass counter.
    """
    if key is None:
        return None
    if isinstance(key, FaultModel):
        return key
    k = str(key).strip()
    if k.lower() in ("", "none", "off"):
        return None
    m = _MODELS.get(k)
    if m is None:
        m = register_fault_model(_parse_compact(k))
    return m
