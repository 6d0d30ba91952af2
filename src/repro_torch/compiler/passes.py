"""Optimization passes over the Program IR.

The pipeline (:func:`optimize`) runs, in order:

0. **op fusion** (opt-in, ``PassConfig.fuse``) — FELIX-style gate-set
   strength reduction: a NOT whose operand is itself a fresh NOT of a
   SET-initialized cell collapses to a single-cycle copy (``OR(x, x)``,
   legal in FELIX's one-cycle OR), and a MIN3 with a provably-SET input
   narrows to the 2-input NOR it computes. Producer NOTs whose value is
   then never observed are deleted (general dead-op elimination), which
   is what removes RIME's per-stage complement relay cycle.
1. **dead-INIT elimination** — drop SETs whose value is never observed
   before the cell's next SET (or program end); init cycles that empty
   out disappear, shrinking latency, and cells that were *only* ever
   SET stop counting toward area.
2. **INIT coalescing** — adjacent init cycles merge into one batched SET
   (standard MAGIC accounting: one cycle regardless of cell count).
3. **cycle compaction / scheduling** — ``PassConfig.scheduler`` picks
   the algorithm:

   * ``"greedy"`` (default): greedily hoist each op into the earliest
     preceding compute cycle where (a) no intervening cycle writes the
     op's inputs or output or reads its output, (b) the destination
     cycle's engaged partition spans stay pairwise disjoint, and (c) no
     other op already writes the same column there. Emptied cycles are
     dropped. This is what reclaims e.g. RIME's trailing serial
     ``s0 <- 0`` cycle per stage.
   * ``"list"``: the critical-path list scheduler (:mod:`.schedule`)
     reschedules the whole program from scratch over the hazard DAG.
     The pipeline runs greedy compaction alongside and keeps whichever
     schedule is shorter, so ``"list"`` is never worse than
     ``"greedy"`` (``OptStats.list_cycles`` / ``greedy_cycles`` /
     ``scheduler_used`` record both counts and the winner).
4. **column remapping** — linear-scan allocation of live segments
   (:mod:`.liveness`) onto same-partition columns whose lifetimes ended,
   then a layout rebuild that drops unused columns. Inputs, outputs and
   virgin-RMW segments are pinned.

Every pass is independently toggleable via :class:`PassConfig`;
:func:`optimize` re-validates the program after each pass, and callers
are expected to run :mod:`.verify` for end-to-end differential proof.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Set, Tuple

from repro_torch import obs
from repro_torch.core.isa import Gate, Op
from repro_torch.core.program import Cycle, Layout, Program

from .depgraph import (EV_SET, DepGraph, cycle_reads, cycle_writes,
                       find_seg_index, op_span)
from .liveness import dead_sets, live_segments

__all__ = ["PassConfig", "OptStats", "optimize", "fuse_ops",
           "eliminate_dead_inits", "coalesce_inits", "compact_cycles",
           "remap_columns", "SCHEDULERS"]

SCHEDULERS = ("greedy", "list")


@dataclass(frozen=True)
class PassConfig:
    """Which passes run. Frozen so configs can key the program cache.

    ``fuse`` opts into the FELIX-gate-set fusion pass (off by default:
    it may introduce OR/NOR ops, which would break MultPIM's NOT/MIN3
    fair-comparison claim if applied blindly). ``scheduler`` picks the
    compaction algorithm — ``"greedy"`` backward hoist or the
    ``"list"`` critical-path scheduler (see module docstring).
    """

    dead_init: bool = True
    coalesce: bool = True
    compact: bool = True
    remap: bool = True
    fuse: bool = False
    scheduler: str = "greedy"

    def key(self) -> Tuple:
        """Hashable tuple of every pass switch (part of the cache key)."""
        return (self.dead_init, self.coalesce, self.compact, self.remap,
                self.fuse, self.scheduler)

    @classmethod
    def from_key(cls, key: Tuple) -> "PassConfig":
        """Inverse of :meth:`key` (kept adjacent so adding a pass field
        updates both in one place)."""
        return cls(*key)


@dataclass
class OptStats:
    """What the pass pipeline did to one program."""

    name: str = ""
    cycles_before: int = 0
    cycles_after: int = 0
    cols_before: int = 0          # n_memristors (distinct used columns)
    cols_after: int = 0
    init_sets_removed: int = 0
    init_cycles_merged: int = 0
    ops_hoisted: int = 0
    cycles_dropped: int = 0
    cols_reused: int = 0
    ops_fused: int = 0            # fuse pass: rewritten gates
    ops_deleted: int = 0          # fuse pass: dead producer ops removed
    list_cycles: int = 0          # scheduler="list": list-scheduled count
    greedy_cycles: int = 0        # scheduler="list": greedy count alongside
    scheduler_used: str = ""      # which schedule the pipeline kept

    @property
    def cycles_saved(self) -> int:
        """Cycles removed by the pipeline."""
        return self.cycles_before - self.cycles_after

    @property
    def cols_saved(self) -> int:
        """Columns removed by the pipeline."""
        return self.cols_before - self.cols_after

    def summary(self) -> str:
        """One-line human-readable summary."""
        return (f"{self.name}: cycles {self.cycles_before}->"
                f"{self.cycles_after}, cols {self.cols_before}->"
                f"{self.cols_after} (inits-{self.init_sets_removed}, "
                f"hoisted {self.ops_hoisted}, reused {self.cols_reused})")


def _rebuild(prog: Program, cycles: List[Cycle],
             layout: Optional[Layout] = None,
             input_map: Optional[Dict[str, List[int]]] = None,
             output_map: Optional[Dict[str, List[int]]] = None) -> Program:
    return Program(layout=layout or prog.layout, cycles=cycles,
                   input_map=input_map or prog.input_map,
                   output_map=output_map or prog.output_map,
                   name=prog.name)


# -------------------------------------------------------- op fusion ----
def _def_index(prog: Program) -> Dict[int, List[Tuple[int, str, Optional[Op]]]]:
    """Per-column, time-ordered defs: ``col -> [(t, kind, op)]`` with
    ``kind`` in ``{"load", "set", "op"}`` (loads at t = -1)."""
    defs: Dict[int, List[Tuple[int, str, Optional[Op]]]] = {}
    for cols in prog.input_map.values():
        for c in cols:
            defs.setdefault(c, []).append((-1, "load", None))
    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            for c in cyc.init_cells:
                defs.setdefault(c, []).append((t, "set", None))
            continue
        for op in cyc.ops:
            defs.setdefault(op.out, []).append((t, "op", op))
    return defs


def _last_def_before(defs, col: int, t: int):
    """Most recent def of ``col`` strictly before cycle ``t`` (ops within
    a cycle observe pre-cycle state), or None."""
    lst = defs.get(col)
    if not lst:
        return None
    # (t,) sorts before any (t, kind, op) entry, so this finds the first
    # def at time >= t without ever comparing the non-time fields (and
    # without bisect's key= kwarg, which needs Python 3.10+).
    i = bisect.bisect_left(lst, (t,)) - 1
    return lst[i] if i >= 0 else None


def fuse_ops(prog: Program, stats: OptStats) -> Program:
    """FELIX-style chain fusion + dead-op cleanup (``PassConfig.fuse``).

    Rewrites (each independently behavior-preserving for *all* inputs,
    and differentially verified like every pass):

    * **NOT -> NOT**: ``z <- NOT(y)`` where ``y``'s most recent def is
      ``y <- NOT(x)`` landing on a fresh SET cell (so ``y`` holds exactly
      ``NOT(x)``) and ``x`` is not redefined in between becomes
      ``z <- OR(x, x)`` — a single-cycle copy, realizable as FELIX's
      one-cycle OR with both inputs on the same cell.
    * **NOT -> MIN3 / MIN3-with-SET**: a MIN3 input whose most recent
      def is a SET is constantly 1 at read time, and
      ``Min3(p, q, 1) == NOR(p, q)`` — the op narrows to the 2-input
      MAGIC NOR, dropping the dependency on the helper SET.

    After rewriting, producer ops whose written value is never observed
    (no read/RMW/output use before the cell's next SET or program end)
    are deleted to a fixpoint — this is what actually removes cycles:
    e.g. RIME's per-stage complement relay (``t2 <- NOT(tmp)`` feeding
    only ``dst <- NOT(t2)``) collapses into direct copies, emptying the
    complement cycle and (via dead-INIT) its re-init cycle.
    """
    defs = _def_index(prog)
    lay = prog.layout
    cycles: List[Cycle] = []
    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            cycles.append(cyc)
            continue
        ops: List[Op] = []
        for op in cyc.ops:
            new_op = op
            if op.gate == Gate.NOT:
                d = _last_def_before(defs, op.ins[0], t)
                if d is not None and d[1] == "op" and d[2].gate == Gate.NOT:
                    t1, producer = d[0], d[2]
                    y_prev = _last_def_before(defs, op.ins[0], t1)
                    x = producer.ins[0]
                    x_def = _last_def_before(defs, x, t)
                    if (y_prev is not None and y_prev[1] == "set"
                            and (x_def is None or x_def[0] < t1)):
                        new_op = Op(Gate.OR, (x, x), op.out,
                                    note=f"{op.note}|fuse:not-not")
            elif op.gate == Gate.MIN3:
                fresh = next(
                    (c for c in op.ins
                     if (d := _last_def_before(defs, c, t)) is not None
                     and d[1] == "set"), None)
                if fresh is not None:
                    rest = list(op.ins)
                    rest.remove(fresh)
                    new_op = Op(Gate.NOR, tuple(rest), op.out,
                                note=f"{op.note}|fuse:min3-set")
            if new_op is not op and new_op.gate == Gate.OR:
                # A NOT->NOT rewrite reads a *different* column, which can
                # widen the op's engaged span; keep it only if it stays
                # disjoint from every sibling op's span (siblings are
                # checked against their current form — MIN3 narrowing only
                # ever shrinks spans, so it needs no such guard).
                lo, hi = op_span(lay, new_op)
                sibs = ops + cyc.ops[len(ops) + 1:]
                if any(not (hi < a or lo > b)
                       for a, b in (op_span(lay, o) for o in sibs)):
                    new_op = op
            if new_op is not op:
                stats.ops_fused += 1
            ops.append(new_op)
        cycles.append(Cycle(ops=ops, note=cyc.note))
    cur = _rebuild(prog, cycles)

    # Dead-op elimination to a fixpoint: deleting an op leaves its output
    # cell holding the previous value, which is unobservable when no use
    # lands before the next SET (outputs are protected by their EV_OUT
    # use; an RMW's read of the old value counts as a use).
    while True:
        g = DepGraph.build(cur)

        def value_unobserved(col: int, t: int) -> bool:
            for e in g.col_events(col):
                if e.t <= t:
                    continue
                if e.is_use:
                    return False
                if e.kind == EV_SET:
                    return True
            return True

        kept: List[Cycle] = []
        removed = 0
        for t, cyc in enumerate(cur.cycles):
            if cyc.is_init:
                kept.append(cyc)
                continue
            ops = [op for op in cyc.ops
                   if not value_unobserved(op.out, t)]
            removed += len(cyc.ops) - len(ops)
            if ops:
                kept.append(Cycle(ops=ops, note=cyc.note))
            else:
                stats.cycles_dropped += 1
        if not removed:
            break
        stats.ops_deleted += removed
        cur = _rebuild(cur, kept)
    return cur


# ------------------------------------------------------- dead-INIT ----
def eliminate_dead_inits(prog: Program, stats: OptStats) -> Program:
    """Drop INIT cells whose SET value is never read."""
    dead = set(dead_sets(prog))
    if not dead:
        return prog
    cycles: List[Cycle] = []
    for t, cyc in enumerate(prog.cycles):
        if not cyc.is_init:
            cycles.append(cyc)
            continue
        keep = [c for c in cyc.init_cells if (t, c) not in dead]
        stats.init_sets_removed += len(cyc.init_cells) - len(keep)
        if keep:
            cycles.append(Cycle(init_cells=keep, note=cyc.note))
        else:
            stats.cycles_dropped += 1
    return _rebuild(prog, cycles)


# ------------------------------------------------------- coalescing ----
def coalesce_inits(prog: Program, stats: OptStats) -> Program:
    """Merge adjacent INIT cycles into one."""
    cycles: List[Cycle] = []
    for cyc in prog.cycles:
        if cyc.is_init and cycles and cycles[-1].is_init:
            prev = cycles[-1]
            merged = sorted(set(prev.init_cells) | set(cyc.init_cells))
            note = prev.note if prev.note == cyc.note else \
                f"{prev.note}+{cyc.note}"
            cycles[-1] = Cycle(init_cells=merged, note=note)
            stats.init_cycles_merged += 1
            continue
        cycles.append(cyc)
    return _rebuild(prog, cycles)


# ------------------------------------------------------- compaction ----
def compact_cycles(prog: Program, stats: OptStats) -> Program:
    """Greedily hoist ops into earlier cycles where hazards allow."""
    lay = prog.layout
    cycles = [Cycle(ops=list(c.ops), init_cells=list(c.init_cells),
                    note=c.note) for c in prog.cycles]
    reads = [cycle_reads(c) for c in cycles]
    writes = [cycle_writes(c) for c in cycles]
    spans: List[List[Tuple[int, int]]] = [
        [op_span(lay, op) for op in c.ops] for c in cycles]
    touched: List[Set[int]] = [{op.out for op in c.ops} for c in cycles]

    def fits(u: int, span: Tuple[int, int], out: int) -> bool:
        if cycles[u].is_init or out in touched[u]:
            return False
        lo, hi = span
        return all(hi < a or lo > b for a, b in spans[u])

    def refresh(t: int) -> None:
        reads[t] = cycle_reads(cycles[t])
        writes[t] = cycle_writes(cycles[t])
        spans[t] = [op_span(lay, op) for op in cycles[t].ops]
        touched[t] = {op.out for op in cycles[t].ops}

    for t in range(len(cycles)):
        if cycles[t].is_init:
            continue
        for op in list(cycles[t].ops):
            cols = set(op.ins) | {op.out}
            span = op_span(lay, op)
            best = -1
            u = t - 1
            while u >= 0:
                # Crossing cycle u requires: u neither writes any column
                # the op reads/writes, nor reads the op's output (the op's
                # write would become visible to u too early).
                if writes[u] & cols or op.out in reads[u]:
                    break
                if fits(u, span, op.out):
                    best = u
                u -= 1
            if best >= 0:
                cycles[t].ops.remove(op)
                cycles[best].ops.append(op)
                stats.ops_hoisted += 1
                refresh(t)
                refresh(best)
    kept = [c for c in cycles if c.ops or c.init_cells]
    stats.cycles_dropped += len(cycles) - len(kept)
    return _rebuild(prog, kept)


# --------------------------------------------------- column remapping ----
def remap_columns(prog: Program, stats: OptStats) -> Program:
    """Reuse columns across non-overlapping live segments."""
    lay = prog.layout
    segs = live_segments(prog)
    if not segs:
        return prog
    # Conservative per-column busy horizon: a column can host a foreign
    # segment only after *all* of its own original segments are over, so
    # placements can never collide with not-yet-processed native segments.
    busy: Dict[int, int] = {col: max(s.end for s in lst)
                            for col, lst in segs.items() if lst}
    by_partition: Dict[int, List[int]] = {}
    for col in busy:
        by_partition.setdefault(lay.partition_of(col), []).append(col)
    for cols in by_partition.values():
        cols.sort()

    ordered = sorted((s for lst in segs.values() for s in lst),
                     key=lambda s: (s.start, s.end, s.col))
    for s in ordered:
        if s.pinned:
            s.placed = s.col
            busy[s.col] = max(busy[s.col], s.end)
            continue
        host = s.col
        for cand in by_partition[s.pid]:
            if cand != s.col and busy[cand] < s.start:
                host = cand
                break
        if host != s.col:
            stats.cols_reused += 1
        s.placed = host
        busy[host] = max(busy[host], s.end)

    used_hosts = sorted({s.placed for lst in segs.values() for s in lst})
    if len(used_hosts) == lay.n_cols and stats.cols_reused == 0:
        return prog

    new_lay = Layout()
    for _ in range(lay.n_partitions):
        new_lay.new_partition()
    new_of: Dict[int, int] = {}
    for old in used_hosts:
        new_of[old] = new_lay.add_cell(lay.partition_of(old), f"c{old}")

    starts = {col: [s.start for s in lst] for col, lst in segs.items()}

    def mapped(col: int, t: int) -> int:
        s = segs[col][find_seg_index(starts[col], t)]
        return new_of[s.placed]

    cycles: List[Cycle] = []
    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            cycles.append(Cycle(
                init_cells=sorted({mapped(c, t) for c in cyc.init_cells}),
                note=cyc.note))
            continue
        ops = [replace(op, ins=tuple(mapped(c, t) for c in op.ins),
                       out=mapped(op.out, t)) for op in cyc.ops]
        cycles.append(Cycle(ops=ops, note=cyc.note))
    T = prog.n_cycles
    input_map = {k: [mapped(c, -1) for c in v]
                 for k, v in prog.input_map.items()}
    output_map = {k: [mapped(c, T) for c in v]
                  for k, v in prog.output_map.items()}
    return _rebuild(prog, cycles, layout=new_lay,
                    input_map=input_map, output_map=output_map)


# -------------------------------------------------------- pipeline ----
def optimize(prog: Program, config: Optional[PassConfig] = None
             ) -> Tuple[Program, OptStats]:
    """Run the pass pipeline; returns (optimized program, stats).

    The result is re-validated after every pass; use
    :func:`repro_torch.compiler.verify.verify_equivalence` for the differential
    bit-exactness proof against the original.
    """
    cfg = config or PassConfig()
    if cfg.scheduler not in SCHEDULERS:
        raise ValueError(f"unknown scheduler '{cfg.scheduler}' "
                         f"(known: {SCHEDULERS})")
    stats = OptStats(name=prog.name,
                     cycles_before=prog.n_cycles,
                     cols_before=prog.n_memristors)
    cur = prog

    # Each pass runs inside a span recording wall time *and* its cycle
    # delta, so a trace shows both where compile time goes and which
    # pass actually bought schedule length.
    def run_pass(pname, fn):
        nonlocal cur
        before = cur.n_cycles
        with obs.span(f"compile.{pname}", cycles_before=before) as sp:
            cur = fn(cur, stats)
            cur.validate()
            sp.set(cycles_after=cur.n_cycles,
                   cycle_delta=before - cur.n_cycles)

    with obs.span("compile.optimize", program=prog.name,
                  cycles_before=prog.n_cycles,
                  scheduler=cfg.scheduler) as top:
        if cfg.fuse:
            run_pass("fuse", fuse_ops)
        if cfg.dead_init:
            run_pass("dead_init", eliminate_dead_inits)
        if cfg.coalesce:
            run_pass("coalesce", coalesce_inits)
        if cfg.compact:
            if cfg.scheduler == "list":
                before = cur.n_cycles
                with obs.span("compile.compact",
                              cycles_before=before) as sp:
                    from .schedule import list_schedule
                    with obs.span("compile.list_schedule"):
                        listed = list_schedule(cur)
                        listed.validate()
                    greedy_stats = OptStats()
                    with obs.span("compile.greedy_compact"):
                        greedy = compact_cycles(cur, greedy_stats)
                        greedy.validate()
                    stats.list_cycles = listed.n_cycles
                    stats.greedy_cycles = greedy.n_cycles
                    # Never worse than greedy: keep the shorter schedule.
                    if listed.n_cycles <= greedy.n_cycles:
                        stats.scheduler_used = "list"
                        cur = listed
                    else:
                        stats.scheduler_used = "greedy"
                        stats.ops_hoisted = greedy_stats.ops_hoisted
                        stats.cycles_dropped += greedy_stats.cycles_dropped
                        cur = greedy
                    sp.set(cycles_after=cur.n_cycles,
                           cycle_delta=before - cur.n_cycles,
                           scheduler_used=stats.scheduler_used)
            else:
                stats.scheduler_used = "greedy"
                run_pass("compact", compact_cycles)
        if cfg.remap:
            run_pass("remap", remap_columns)
        stats.cycles_after = cur.n_cycles
        stats.cols_after = cur.n_memristors
        top.set(cycles_after=stats.cycles_after,
                cycles_saved=stats.cycles_saved,
                cols_saved=stats.cols_saved)
    return cur, stats
