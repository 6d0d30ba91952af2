"""Multi-program co-scheduling: K programs, one crossbar, one pass.

The executor model dedicates a whole backend pass (one
``Backend.run_state`` call) to a single compiled program even though the
program only engages ``prog.n_partitions`` partitions of a much wider
physical crossbar. This module packs K *independent* programs into
disjoint partition and column ranges of one wide crossbar and merges
their cycle streams, so a single pass serves K programs — the
"serve several MACs per crossbar pass" optimization
(HIPE-MAGIC-style technology-aware mapping; see ROADMAP).

Relocation invariants (asserted by tests and ``Program.validate``):

* **Range disjointness** — the :class:`PartitionAllocator` hands out
  strictly increasing, non-overlapping ``[partition_lo, partition_hi]``
  and ``[col_lo, col_hi]`` ranges; a relocated program's every column
  (ops, inits, I/O maps) lands inside its own ranges, so no two
  co-scheduled programs can ever alias a cell or a partition.
* **Span containment** — relocation adds a constant offset to every
  column and partition, so each op's engaged span
  ``[partition(min col), partition(max col)]`` stays inside its
  program's partition range; ops from different programs are therefore
  always span-disjoint and may share a cycle.
* **Stream order** — merging never reorders cycles *within* a program,
  so each program's own data flow is untouched; init and compute
  cycles are merged type-aligned (pending inits batch into one fused
  INIT — standard MAGIC accounting — before the next fused compute
  cycle). For K copies of the same program the merged stream has
  exactly the single program's cycle count: cycles-per-program drops
  K-fold.

Bit-exactness of the fused program against K independent runs is
checked by the engine test suite on every backend.

This is the port's copy of ``repro.compiler.coschedule``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.program import Cycle, Layout, Program

__all__ = ["Placement", "CapacityError", "PartitionAllocator",
           "relocate", "coschedule", "column_budget_counts"]


class CapacityError(ValueError):
    """The crossbar has no room for another program."""


@dataclass(frozen=True)
class Placement:
    """One program's slot in the fused crossbar (ranges inclusive)."""

    index: int
    prefix: str
    partition_lo: int
    partition_hi: int
    col_lo: int
    col_hi: int

    @property
    def n_partitions(self) -> int:
        """Partitions the slot spans."""
        return self.partition_hi - self.partition_lo + 1

    @property
    def n_cols(self) -> int:
        """Columns the slot spans."""
        return self.col_hi - self.col_lo + 1


class PartitionAllocator:
    """Hands out disjoint partition/column ranges of one wide crossbar.

    ``max_partitions`` / ``max_cols`` bound the physical crossbar
    (``None`` = unbounded, for tests and cost-model-only use);
    :meth:`place` raises :class:`CapacityError` once a program no longer
    fits, which is how callers discover the largest legal K
    (:meth:`capacity`).
    """

    def __init__(self, max_partitions: Optional[int] = None,
                 max_cols: Optional[int] = None):
        self.max_partitions = max_partitions
        self.max_cols = max_cols
        self.next_partition = 0
        self.next_col = 0
        self.placements: List[Placement] = []

    def fits(self, prog: Program) -> bool:
        """Whether ``prog`` fits at the next free offset."""
        return ((self.max_partitions is None
                 or self.next_partition + prog.n_partitions
                 <= self.max_partitions)
                and (self.max_cols is None
                     or self.next_col + prog.layout.n_cols <= self.max_cols))

    def capacity(self, prog: Program) -> int:
        """How many copies of ``prog`` fit in an empty crossbar."""
        caps = []
        if self.max_partitions is not None:
            caps.append(self.max_partitions // max(prog.n_partitions, 1))
        if self.max_cols is not None:
            caps.append(self.max_cols // max(prog.layout.n_cols, 1))
        return min(caps) if caps else 1 << 30

    def place(self, prog: Program, prefix: str = "") -> Placement:
        """Reserve the next partition/column range for ``prog``; raises
        :class:`CapacityError` when it does not fit."""
        if not self.fits(prog):
            raise CapacityError(
                f"no room for {prog.name}: needs {prog.n_partitions} "
                f"partitions / {prog.layout.n_cols} cols at offset "
                f"({self.next_partition}, {self.next_col}) of crossbar "
                f"({self.max_partitions}, {self.max_cols})")
        p = Placement(index=len(self.placements), prefix=prefix,
                      partition_lo=self.next_partition,
                      partition_hi=self.next_partition
                      + prog.n_partitions - 1,
                      col_lo=self.next_col,
                      col_hi=self.next_col + prog.layout.n_cols - 1)
        self.next_partition = p.partition_hi + 1
        self.next_col = p.col_hi + 1
        self.placements.append(p)
        return p


def column_budget_counts(progs: Sequence[Program],
                         max_cols: Optional[int],
                         weights: Optional[Sequence[float]] = None,
                         max_partitions: Optional[int] = None
                         ) -> List[int]:
    """Heterogeneous-K allocator policy: copies per program, packed by
    column budget rather than a uniform K.

    Given the *distinct* programs that want to share one crossbar pass,
    return how many co-scheduled copies (MAC chains, multiplier lanes,
    ...) each should get so that the whole group fills — but never
    exceeds — the physical column (and partition) budget. Each program
    gets at least one copy (the group is infeasible otherwise —
    :class:`CapacityError`); leftover budget is handed out greedily to
    the program with the largest remaining ``weight / copies`` ratio, so
    ops with more streamed work (e.g. a wider ``in_dim`` in a
    weight-stationary linear) end up with proportionally more chains.
    ``weights`` defaults to all-equal. ``max_cols=None`` means
    unbounded: every program gets ``max(1, round(weight))`` copies.
    """
    if not progs:
        raise ValueError("nothing to pack")
    w = [1.0] * len(progs) if weights is None else [float(x) for x in weights]
    if len(w) != len(progs):
        raise ValueError("len(weights) != len(progs)")
    if any(x <= 0 for x in w):
        raise ValueError("weights must be positive")
    if max_cols is None:
        return [max(1, round(x)) for x in w]
    cols = [p.layout.n_cols for p in progs]
    parts = [p.n_partitions for p in progs]
    counts = [1] * len(progs)
    used_c = sum(cols)
    used_p = sum(parts)
    if used_c > max_cols or (max_partitions is not None
                             and used_p > max_partitions):
        raise CapacityError(
            f"one copy of each of {len(progs)} programs needs {used_c} "
            f"cols / {used_p} partitions; crossbar has "
            f"({max_partitions}, {max_cols})")
    while True:
        # most under-served op first: largest weight per current copy
        order = sorted(range(len(progs)),
                       key=lambda i: (-w[i] / counts[i], i))
        for i in order:
            if used_c + cols[i] <= max_cols and (
                    max_partitions is None
                    or used_p + parts[i] <= max_partitions):
                counts[i] += 1
                used_c += cols[i]
                used_p += parts[i]
                break
        else:
            return counts


def relocate(prog: Program, layout: Layout, placement: Placement) -> Program:
    """Rebuild ``prog`` against the fused ``layout`` at ``placement``.

    ``layout`` must already contain the placement's partitions and
    columns (built by :func:`coschedule`); every column index shifts by
    ``placement.col_lo`` and input/output names gain the placement
    prefix. The per-cycle structure is preserved verbatim.
    """
    off = placement.col_lo
    cycles: List[Cycle] = []
    for cyc in prog.cycles:
        if cyc.is_init:
            cycles.append(Cycle(init_cells=[c + off for c in cyc.init_cells],
                                note=cyc.note))
        else:
            cycles.append(Cycle(
                ops=[replace(op, ins=tuple(c + off for c in op.ins),
                             out=op.out + off) for op in cyc.ops],
                note=cyc.note))
    pfx = placement.prefix
    return Program(
        layout=layout, cycles=cycles,
        input_map={f"{pfx}{k}": [c + off for c in v]
                   for k, v in prog.input_map.items()},
        output_map={f"{pfx}{k}": [c + off for c in v]
                    for k, v in prog.output_map.items()},
        name=f"{pfx}{prog.name}")


def _merge_streams(parts: Sequence[Program]) -> List[Cycle]:
    """Merge relocated cycle streams without reordering any single
    stream. Pending init cycles batch into one fused INIT before the
    next fused compute cycle (init and compute cannot share a cycle)."""
    ptr = [0] * len(parts)
    fused: List[Cycle] = []
    while any(ptr[i] < len(p.cycles) for i, p in enumerate(parts)):
        pending = [(i, parts[i].cycles[ptr[i]]) for i in range(len(parts))
                   if ptr[i] < len(parts[i].cycles)]
        inits = [(i, c) for i, c in pending if c.is_init]
        if inits:
            cells: List[int] = []
            notes = []
            for i, c in inits:
                cells.extend(c.init_cells)
                if c.note:
                    notes.append(c.note)
                ptr[i] += 1
            fused.append(Cycle(init_cells=sorted(cells),
                               note=";".join(dict.fromkeys(notes))))
        else:
            ops = []
            notes = []
            for i, c in pending:
                ops.extend(c.ops)
                if c.note:
                    notes.append(c.note)
                ptr[i] += 1
            fused.append(Cycle(ops=ops, note=";".join(dict.fromkeys(notes))))
    return fused


def coschedule(progs: Sequence[Program], *,
               allocator: Optional[PartitionAllocator] = None,
               name: str = "coschedule",
               prefixes: Optional[Sequence[str]] = None
               ) -> Tuple[Program, List[Placement]]:
    """Pack ``progs`` into one fused, validated :class:`Program`.

    Returns ``(fused, placements)``. Input/output names of program ``i``
    are prefixed ``g{i}/`` (or ``prefixes[i]``); placements record the
    disjoint partition/column ranges for scatter/gather and for the
    aliasing regression tests.
    """
    if not progs:
        raise ValueError("nothing to co-schedule")
    alloc = allocator or PartitionAllocator()
    prefixes = list(prefixes) if prefixes is not None else [
        f"g{i}/" for i in range(len(progs))]
    if len(prefixes) != len(progs):
        raise ValueError("len(prefixes) != len(progs)")

    layout = Layout()
    placements: List[Placement] = []
    parts: List[Program] = []
    for prog, pfx in zip(progs, prefixes):
        pl = alloc.place(prog, prefix=pfx)
        placements.append(pl)
        pid_of: Dict[int, int] = {}
        for pid in range(prog.n_partitions):
            pid_of[pid] = layout.new_partition()
        for col in range(prog.layout.n_cols):
            got = layout.add_cell(pid_of[prog.layout.partition_of(col)],
                                  f"{pl.prefix}c{col}")
            if got != pl.col_lo + col:
                # A pre-used allocator (next_col > 0 on entry) would
                # desynchronize placements from the fresh fused layout
                # and silently alias columns — refuse loudly instead.
                raise ValueError(
                    f"allocator/layout drift at {pl.prefix}c{col}: layout "
                    f"column {got} != placement {pl.col_lo + col}; "
                    f"coschedule() needs a fresh (empty) allocator")
        parts.append(relocate(prog, layout, pl))

    fused = Program(
        layout=layout,
        cycles=_merge_streams(parts),
        input_map={k: v for p in parts for k, v in p.input_map.items()},
        output_map={k: v for p in parts for k, v in p.output_map.items()},
        name=name)
    fused.validate()
    return fused, placements
