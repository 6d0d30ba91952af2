"""Def-use analysis over the :class:`~repro_torch.core.program.Program` IR.

The executor semantics (see ``core/executor.py``) induce the following
event model, which every pass in this package reasons over:

* time ``-1``      — program inputs are loaded into ``input_map`` columns;
* init cycle ``t`` — a **SET** (full def, value 1) of each listed cell;
* compute cycle ``t`` — each op *reads* its ``ins`` and performs a
  read-modify-write on ``out`` (``out <- out AND gate(ins)``), i.e. the
  output column is both a use (of the old value) and a def;
* time ``T = n_cycles`` — every ``output_map`` column is read.

Ops within one compute cycle are simultaneous: all reads observe the
pre-cycle state, all writes land afterwards.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.core.program import Cycle, Program

__all__ = ["EV_LOAD", "EV_SET", "EV_RMW", "EV_READ", "EV_OUT",
           "Event", "DepGraph", "cycle_reads", "cycle_writes", "op_span"]

# Event kinds, in intra-cycle "happens-before" order where it matters:
EV_LOAD = "load"    # input load (def), time -1
EV_SET = "set"      # INIT (full def)
EV_RMW = "rmw"      # compute write: use of old value + def of new
EV_READ = "read"    # compute input use
EV_OUT = "out"      # program-output use, time n_cycles


@dataclass(frozen=True)
class Event:
    """One access of a column at cycle ``t`` (load, set, rmw, read, out)."""

    t: int
    kind: str

    @property
    def is_def(self) -> bool:
        """Whether the event writes the cell."""
        return self.kind in (EV_LOAD, EV_SET, EV_RMW)

    @property
    def is_use(self) -> bool:
        """Whether the event reads the cell."""
        return self.kind in (EV_RMW, EV_READ, EV_OUT)


def cycle_reads(cyc: Cycle) -> Set[int]:
    """Columns whose pre-cycle value is observed by this cycle."""
    if cyc.is_init:
        return set()
    r: Set[int] = set()
    for op in cyc.ops:
        r.update(op.ins)
        r.add(op.out)          # RMW: the old output value is ANDed in
    return r


def cycle_writes(cyc: Cycle) -> Set[int]:
    """Columns whose value changes (or may change) after this cycle."""
    if cyc.is_init:
        return set(cyc.init_cells)
    return {op.out for op in cyc.ops}


def op_span(layout, op) -> Tuple[int, int]:
    """The contiguous partition span an op electrically engages."""
    ps = [layout.partition_of(c) for c in op.cols]
    return min(ps), max(ps)


@dataclass
class DepGraph:
    """Per-column, time-ordered event lists plus per-cycle read/write sets."""

    prog: Program
    events: Dict[int, List[Event]] = field(default_factory=dict)
    reads: List[Set[int]] = field(default_factory=list)
    writes: List[Set[int]] = field(default_factory=list)

    @classmethod
    def build(cls, prog: Program) -> "DepGraph":
        """Collect every column's events from ``prog``."""
        g = cls(prog)
        ev = g.events

        def add(col: int, t: int, kind: str) -> None:
            ev.setdefault(col, []).append(Event(t, kind))

        for cols in prog.input_map.values():
            for c in cols:
                add(c, -1, EV_LOAD)
        for t, cyc in enumerate(prog.cycles):
            g.reads.append(cycle_reads(cyc))
            g.writes.append(cycle_writes(cyc))
            if cyc.is_init:
                for c in cyc.init_cells:
                    add(c, t, EV_SET)
                continue
            for op in cyc.ops:
                for c in op.ins:
                    add(c, t, EV_READ)
                add(op.out, t, EV_RMW)
        T = prog.n_cycles
        for cols in prog.output_map.values():
            for c in cols:
                add(c, T, EV_OUT)
        # Within one cycle a column sees at most {reads..., one RMW}; put
        # the RMW last so "uses before the next SET" scans stay simple.
        order = {EV_LOAD: 0, EV_SET: 0, EV_READ: 1, EV_RMW: 2, EV_OUT: 3}
        for c in ev:
            ev[c].sort(key=lambda e: (e.t, order[e.kind]))
        return g

    # ------------------------------------------------------------ queries --
    def col_events(self, col: int) -> List[Event]:
        """Events of column ``col`` in cycle order."""
        return self.events.get(col, [])

    def used_between(self, col: int, after_t: int, before_t: int) -> bool:
        """Any use of ``col`` at a time ``t`` with after_t < t < before_t?"""
        for e in self.col_events(col):
            if e.t <= after_t:
                continue
            if e.t >= before_t:
                break
            if e.is_use:
                return True
        return False

    def next_set_time(self, col: int, after_t: int) -> int:
        """Time of the next SET of ``col`` strictly after ``after_t``
        (``n_cycles + 1`` if none)."""
        for e in self.col_events(col):
            if e.t > after_t and e.kind == EV_SET:
                return e.t
        return self.prog.n_cycles + 1

    def last_write_before(self, col: int, t: int) -> int:
        """Time of the last def of ``col`` strictly before cycle ``t``
        (-2 if never written)."""
        best = -2
        for e in self.col_events(col):
            if e.t >= t:
                break
            if e.is_def:
                best = e.t
        return best


def find_seg_index(starts: Sequence[int], t: int) -> int:
    """Index of the live segment covering time ``t`` given sorted segment
    start times (the last start <= t)."""
    i = bisect.bisect_right(starts, t) - 1
    return max(i, 0)
