"""Macro-cycle fusion: group consecutive cycles into one kernel step.

The packed executors (:mod:`repro_torch.kernels.ref` /
:mod:`repro_torch.kernels.crossbar_step` with ``pack=True`` backends) dispatch
one scan step / one grid-loop iteration per program cycle. For the long
serial programs MultPIM produces (hundreds of cycles, a handful of ops
each) the per-step dispatch overhead — scan bookkeeping, gather/scatter
setup — dominates the actual gate arithmetic once the state itself is
bit-plane packed. This pass fuses runs of ``factor`` consecutive cycles
into one *macro cycle*: the executor scans over ``ceil(T/factor)`` macro
steps and unrolls the ``factor`` constituent cycles inside each step, so
the outer dispatch count drops by ``factor`` while the per-cycle
semantics (simultaneous reads, AND-writes, batched SETs) are preserved
exactly.

Fusion legality: a run of cycles can fuse iff every constituent cycle's
gather/scatter columns are static — true by construction for every
:class:`~repro_torch.core.executor.PackedProgram` (the dense tables *are* the
static column schedule; data-dependent addressing does not exist in the
ISA). The fuser therefore only has to choose the segmentation and pad
the tail: the trailing ``Tm*factor - T`` slots are NOP cycles (gate 0,
scratch-column operands, empty init mask), which the executors' AND-write
of constant 1 into the scratch column makes side-effect free.

Fused tables are memoized on the PackedProgram instance (keyed by
factor), so repeated runs — decode traffic — reshape once.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.executor import PackedProgram

__all__ = ["MacroTables", "fuse_macrocycles", "choose_factor",
           "DEFAULT_MACRO_FACTOR"]

# 8 cycles per macro step: deep enough to amortize scan/grid dispatch,
# shallow enough that the unrolled trace stays small for the ~600-cycle
# multiplier programs (T/8 ~ 75 outer steps, 8x inner unroll).
DEFAULT_MACRO_FACTOR = 8


@dataclass(frozen=True)
class MacroTables:
    """Macro-fused executor tables.

    Shapes (Tm = macro steps, K = fusion factor, M = max ops/cycle,
    C = padded columns): ``gate_id``/``out_col`` (Tm, K, M),
    ``in_cols`` (Tm, K, M, 3), ``init_mask`` (Tm, K, C) bool, and
    ``init_words`` (Tm, K, C) uint32 — the same mask as all-ones /
    all-zero words, pre-materialized so the packed executors apply a
    batched SET as one word-wide OR. Slot ``[t, j]`` is original cycle
    ``t*K + j``; slots past the original cycle count are NOP padding.
    """

    gate_id: np.ndarray
    in_cols: np.ndarray
    out_col: np.ndarray
    init_mask: np.ndarray
    init_words: np.ndarray
    factor: int
    n_cycles: int            # original (unpadded) cycle count

    @property
    def n_macro(self) -> int:
        """Number of fused macro steps."""
        return self.gate_id.shape[0]


def choose_factor(n_cycles: int,
                  factor: int = DEFAULT_MACRO_FACTOR) -> int:
    """Clamp the requested fusion factor to the program length (a
    program shorter than one macro step fuses into a single step)."""
    return max(1, min(int(factor), max(1, n_cycles)))


def fuse_macrocycles(packed: PackedProgram, factor: int) -> MacroTables:
    """Fuse ``packed``'s cycle tables ``factor``-deep (see module doc).

    ``factor=1`` degenerates to a (Tm=T, K=1) view of the original
    tables. Results are memoized per (packed, factor).
    """
    factor = choose_factor(packed.n_cycles, factor)
    cache = getattr(packed, "_macro_cache", None)
    if cache is None:
        cache = {}
        packed._macro_cache = cache
    hit = cache.get(factor)
    if hit is not None:
        return hit

    T, M = packed.gate_id.shape
    C = packed.init_mask.shape[1]
    n_macro = -(-T // factor)
    scratch = packed.scratch_col

    gate_id = np.zeros((n_macro * factor, M), dtype=np.int32)
    in_cols = np.full((n_macro * factor, M, 3), scratch, dtype=np.int32)
    out_col = np.full((n_macro * factor, M), scratch, dtype=np.int32)
    init_mask = np.zeros((n_macro * factor, C), dtype=bool)
    gate_id[:T] = packed.gate_id
    in_cols[:T] = packed.in_cols
    out_col[:T] = packed.out_col
    init_mask[:T] = packed.init_mask
    # Tail slots past T stay NOP/scratch/empty-init by construction.

    init_mask = init_mask.reshape(n_macro, factor, C)
    tables = MacroTables(
        gate_id=gate_id.reshape(n_macro, factor, M),
        in_cols=in_cols.reshape(n_macro, factor, M, 3),
        out_col=out_col.reshape(n_macro, factor, M),
        init_mask=init_mask,
        init_words=np.where(init_mask, np.uint32(0xFFFFFFFF),
                            np.uint32(0)),
        factor=factor, n_cycles=T)
    cache[factor] = tables
    return tables
