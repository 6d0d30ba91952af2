"""Cross-cycle liveness: live *segments* per column.

A segment is one value-lifetime of a physical column: it starts at a def
that does not depend on the previous content (input load at ``t = -1`` or
an INIT SET) — or, conservatively, at a read-modify-write landing on a
never-written column ("virgin RMW", whose result depends on the crossbar
reset state) — and extends through every later RMW/read up to the last
use before the next SET. Program outputs keep their final segment alive
to ``t = n_cycles``.

Segments are what the column-remapping pass allocates: two segments may
share a physical column iff their ``[start, end]`` windows are disjoint
and they live in the same partition (moving a cell across partitions
would change every engaged span that touches it).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.core.program import Program

from .depgraph import EV_LOAD, EV_RMW, EV_SET, DepGraph

__all__ = ["Segment", "live_segments", "dead_sets"]


@dataclass
class Segment:
    """One live range of a column: a definition and its uses."""

    col: int              # original column
    pid: int              # partition (immovable)
    start: int            # def time (-1 for input loads)
    end: int              # last use time (== start for dead defs)
    pinned: bool          # must stay on `col` (inputs, outputs, virgin RMW)
    n_uses: int = 0
    placed: int = field(default=-1)  # filled by the remapper

    @property
    def dead(self) -> bool:
        """Whether no cycle reads the value defined here."""
        return self.n_uses == 0


def live_segments(prog: Program, graph: DepGraph = None) -> Dict[int, List[Segment]]:
    """Per-column, time-ordered live segments (see module docstring)."""
    g = graph or DepGraph.build(prog)
    lay = prog.layout
    out_cols = {c for cols in prog.output_map.values() for c in cols}
    T = prog.n_cycles
    segs: Dict[int, List[Segment]] = {}
    for col, events in g.events.items():
        pid = lay.partition_of(col)
        cur: Segment = None
        lst: List[Segment] = []
        for e in events:
            if e.kind in (EV_LOAD, EV_SET):
                cur = Segment(col, pid, e.t, e.t, pinned=(e.kind == EV_LOAD))
                lst.append(cur)
            elif e.kind == EV_RMW:
                if cur is None:      # virgin RMW: depends on reset-0 state
                    cur = Segment(col, pid, e.t, e.t, pinned=True)
                    lst.append(cur)
                else:
                    cur.n_uses += 1  # reads the old value...
                cur.end = e.t        # ...and defines the new one
            else:                    # EV_READ / EV_OUT
                if cur is None:      # read-before-write: validator rejects
                    cur = Segment(col, pid, e.t, e.t, pinned=True)
                    lst.append(cur)
                cur.end = e.t
                cur.n_uses += 1
        if lst and col in out_cols:
            lst[-1].pinned = True
            lst[-1].end = T
        segs[col] = lst
    return segs


def dead_sets(prog: Program, graph: DepGraph = None) -> List[tuple]:
    """All ``(cycle, col)`` INIT entries whose SET value is never observed:
    no read, no RMW, and not a program output, before the next SET (or
    program end). Removing them is behavior-preserving for every input."""
    g = graph or DepGraph.build(prog)
    out: List[tuple] = []
    for t, cyc in enumerate(prog.cycles):
        if not cyc.is_init:
            continue
        for c in cyc.init_cells:
            nxt = g.next_set_time(c, t)
            if not g.used_between(c, t, nxt):
                # EV_OUT events live at n_cycles; used_between covers them
                # unless a later SET redefines the column first.
                out.append((t, c))
    return out
