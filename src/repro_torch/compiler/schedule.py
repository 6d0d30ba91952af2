"""Priority list scheduler over the Program dep graph.

``compact_cycles`` (:mod:`.passes`) is a greedy *backward hoist*: it
keeps the original cycle skeleton and pulls individual ops earlier one
at a time, with conservative crossing windows. That reclaims serial
tails (RIME's ``s0 <- 0``) but cannot re-derive a genuinely different
cycle structure — e.g. the ragged broadcast trees that non-power-of-two
N produce, where the best packing interleaves ops from *different*
original cycles. This module reschedules the whole program from scratch:

1. **Op graph** (:func:`build_op_graph`): one node per compute op and one
   per INIT'd cell (splitting batched SETs lets the scheduler re-batch
   them freely). Edges are the per-column hazards — RAW (def -> use),
   WAR (use -> next def) and WAW (def -> def). Every edge forces a
   strictly later cycle: under the memristive-partition model two ops
   sharing *any* column both electrically engage that column's
   partition, so their spans overlap and they can never share a cycle —
   there is no exploitable same-cycle WAR slack to model.

2. **Priorities** (:func:`critical_path`): classic critical-path length,
   the longest hazard-path from a node to any sink. Ops on the critical
   path are placed first; off-path ops fill remaining span-disjoint
   slots of the same cycle.

3. **Scheduling** (:func:`list_schedule`): two complementary strategies,
   with ``strategy="auto"`` (the pipeline default) running both and
   keeping the shorter schedule:

   * ``"asap"`` — forward list scheduling with just-in-time init
     batching: cycles are emitted in order; each takes the ready set
     and packs it by descending critical-path priority subject to the
     ISA's per-cycle legality (engaged partition spans pairwise
     disjoint). A ready SET triggers an init cycle only when it is
     *blocking* (some successor has it as last unscheduled predecessor)
     and its chain outranks the compute frontier; the init cycle then
     batches every ready SET (standard MAGIC accounting: one cycle
     regardless of cell count). Wins big on serial-movement programs
     (RIME), but its aggressive cross-stage packing desynchronizes
     *lockstep* stage schedules (MultPIM's N staggered partitions), so
     SETs of one stage become ready at different times and the
     per-stage batched INIT fragments into several init cycles.
   * ``"stabbed"`` — the ALAP/slack-aware init batcher that closes that
     desync. Phase 1 list-schedules the *compute ops only*, in
     original-cycle-major order (which preserves lockstep stage
     alignment) over the SET-contracted hazard DAG (each SET node is
     replaced by direct pred -> succ edges). Phase 2 computes every
     SET's legal *boundary window* — strictly after its last scheduled
     predecessor, strictly before its first scheduled consumer — and
     places inits by greedy interval stabbing at window deadlines: the
     classic earliest-deadline stab is the minimum number of init
     cycles for the chosen op schedule, and stabbing at the deadline is
     exactly ALAP placement, so SETs with slack ride along with later
     urgent SETs for free. Ties greedy compaction on MultPIM's
     lockstep schedules and strictly beats it on Haj-Ali and the MAC.

The result preserves program semantics by construction (hazard edges
are exactly the executor's visibility rules) and is differentially
verified against the unoptimized build like every other pass — see
:func:`repro_torch.compiler.verify.verify_equivalence`. The pipeline
(:func:`repro_torch.compiler.passes.optimize` with
``PassConfig(scheduler="list")``) additionally never returns a schedule
longer than greedy compaction's: it runs both and keeps the shorter
(:data:`~repro_torch.compiler.passes.OptStats.scheduler_used` records which
won).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.isa import Op
from repro_torch.core.program import Cycle, Program

from .depgraph import op_span

__all__ = ["ScheduleNode", "build_op_graph", "critical_path",
           "list_schedule", "STRATEGIES"]

STRATEGIES = ("asap", "stabbed", "auto")


@dataclass
class ScheduleNode:
    """One schedulable unit: a compute op, or a single cell's SET."""

    idx: int
    orig_t: int                 # original cycle (stable tie-break)
    op: Optional[Op] = None     # compute node when set
    set_col: int = -1           # INIT node when >= 0

    @property
    def is_set(self) -> bool:
        """Whether this node is a SET (init) rather than an op."""
        return self.op is None


def build_op_graph(prog: Program
                   ) -> Tuple[List[ScheduleNode], List[Set[int]]]:
    """-> ``(nodes, succs)``: hazard DAG over ops and per-cell SETs.

    ``succs[i]`` holds successor node indices; every edge means "at
    least one cycle later". Edges always point from a lower to a higher
    node index (nodes are created in program order), so index order is a
    topological order.
    """
    nodes: List[ScheduleNode] = []
    succs: List[Set[int]] = []

    def new_node(**kw) -> ScheduleNode:
        n = ScheduleNode(idx=len(nodes), **kw)
        nodes.append(n)
        succs.append(set())
        return n

    last_def: Dict[int, int] = {}        # col -> defining node idx
    readers: Dict[int, List[int]] = {}   # col -> reads since last def

    def define(col: int, d: int) -> None:
        prev = last_def.get(col)
        if prev is not None and prev != d:          # WAW
            succs[prev].add(d)
        for r in readers.get(col, ()):              # WAR
            if r != d:
                succs[r].add(d)
        last_def[col] = d
        readers[col] = []

    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            for c in cyc.init_cells:
                define(c, new_node(orig_t=t, set_col=c).idx)
            continue
        cyc_nodes = [new_node(orig_t=t, op=op) for op in cyc.ops]
        # All reads first: ops within a cycle observe pre-cycle state.
        # The RMW output is a read of its own old value too.
        for u in cyc_nodes:
            for c in set(u.op.ins) | {u.op.out}:
                d = last_def.get(c)
                if d is not None:                   # RAW
                    succs[d].add(u.idx)
                readers.setdefault(c, []).append(u.idx)
        for u in cyc_nodes:
            define(u.op.out, u.idx)
    return nodes, succs


def critical_path(succs: List[Set[int]]) -> List[int]:
    """Longest hazard-path length from each node to any sink (edges are
    unit weight). Computed in reverse index order — a topological order
    by construction of :func:`build_op_graph`."""
    prio = [0] * len(succs)
    for i in range(len(succs) - 1, -1, -1):
        if succs[i]:
            prio[i] = 1 + max(prio[j] for j in succs[i])
    return prio


def list_schedule(prog: Program, strategy: str = "auto") -> Program:
    """Reschedule ``prog`` from scratch (see module docstring).

    ``strategy`` is ``"asap"`` (forward list scheduling, just-in-time
    init batching), ``"stabbed"`` (lockstep-aligned op schedule +
    ALAP interval-stabbed init batching; falls back to ``"asap"`` when
    its SET-contraction precondition fails, see
    :func:`_stabbed_schedule`), or ``"auto"`` (run both, keep the
    shorter — the default and what the pass pipeline uses).

    Returns a new :class:`Program` over the same layout and I/O maps;
    the caller is expected to validate and differentially verify it.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy '{strategy}' "
                         f"(known: {STRATEGIES})")
    nodes, succs = build_op_graph(prog)
    if strategy == "asap":
        return _asap_schedule(prog, nodes, succs)
    stab = _stabbed_schedule(prog, nodes, succs)
    if strategy == "stabbed":
        return stab if stab is not None else _asap_schedule(prog, nodes,
                                                            succs)
    asap = _asap_schedule(prog, nodes, succs)
    if stab is not None and stab.n_cycles < asap.n_cycles:
        return stab
    return asap


# ------------------------------------------------------------- asap ----
def _asap_schedule(prog: Program, nodes: List[ScheduleNode],
                   succs: List[Set[int]]) -> Program:
    """Forward priority-list pass with just-in-time init batching."""
    n_nodes = len(nodes)
    prio = critical_path(succs)
    npred = [0] * n_nodes
    for i in range(n_nodes):
        for j in succs[i]:
            npred[j] += 1
    est = [0] * n_nodes                     # earliest legal cycle
    released = {i for i in range(n_nodes) if npred[i] == 0}
    lay = prog.layout

    def order(i: int) -> Tuple[int, int, int]:
        return (-prio[i], nodes[i].orig_t, i)

    cycles: List[Cycle] = []
    t = 0
    scheduled = 0
    while scheduled < n_nodes:
        cand = [i for i in released if est[i] <= t]
        if not cand:
            t = min(est[i] for i in released)
            cand = [i for i in released if est[i] <= t]
        op_cand = [i for i in cand if not nodes[i].is_set]
        set_cand = [i for i in cand if nodes[i].is_set]
        placed: List[int] = []

        # Just-in-time init batching. An init cycle batches any number
        # of SETs but silences every compute op for a cycle, so a ready
        # SET is worth emitting only when it is *blocking* — some
        # successor has this SET as its last unscheduled hazard
        # predecessor and could otherwise start next cycle — and its
        # chain outranks the compute frontier. A SET whose successors
        # are still blocked on other work has free slack: postponing it
        # batches it into a later init cycle at no cost.
        def blocking(i: int) -> bool:
            return any(npred[j] == 1 and est[j] <= t + 1
                       for j in succs[i])

        urgent = [i for i in set_cand if blocking(i)]
        if op_cand and (not urgent
                        or max(prio[i] for i in op_cand)
                        >= max(prio[i] for i in urgent)):
            spans: List[Tuple[int, int]] = []
            for i in sorted(op_cand, key=order):
                lo, hi = op_span(lay, nodes[i].op)
                if all(hi < a or lo > b for a, b in spans):
                    spans.append((lo, hi))
                    placed.append(i)
            cycles.append(Cycle(ops=[nodes[i].op for i in placed],
                                note="ls"))
        else:
            placed = set_cand
            cycles.append(Cycle(
                init_cells=sorted(nodes[i].set_col for i in placed),
                note="ls:init"))
        for i in placed:
            released.discard(i)
            scheduled += 1
            for j in succs[i]:
                npred[j] -= 1
                if est[j] < t + 1:
                    est[j] = t + 1
                if npred[j] == 0:
                    released.add(j)
        t += 1
    return Program(layout=lay, cycles=cycles,
                   input_map=prog.input_map, output_map=prog.output_map,
                   name=prog.name)


# ---------------------------------------------------------- stabbed ----
def _stabbed_schedule(prog: Program, nodes: List[ScheduleNode],
                      succs: List[Set[int]]) -> Optional[Program]:
    """Lockstep-aligned op schedule + ALAP interval-stabbed inits.

    Phase 1 list-schedules the compute ops only, over the
    SET-*contracted* DAG (every SET node replaced by direct
    pred -> succ edges) in original-cycle-major order, which keeps
    lockstep stage schedules aligned instead of packing stages into
    each other. Phase 2 gives every SET its boundary window — the init
    must land strictly after its last scheduled predecessor's cycle and
    strictly before its first scheduled consumer's — and stabs the
    windows greedily at their deadlines: minimum init cycles for this
    op schedule, each placed ALAP so slack SETs batch with later urgent
    ones.

    Contraction drops SET -> SET hazard edges on the assumption that
    every such edge is *mediated* by a reader (SET, read, re-SET — true
    whenever dead-INIT elimination ran, since an unread SET is dead);
    the resulting windows are then provably ordered. The assumption is
    checked exactly — any SET -> SET edge whose windows could collide
    returns ``None`` and the caller falls back to ASAP scheduling.
    """
    n_nodes = len(nodes)
    preds: List[Set[int]] = [set() for _ in range(n_nodes)]
    for i, js in enumerate(succs):
        for j in js:
            preds[j].add(i)
    set_ids = [i for i in range(n_nodes) if nodes[i].is_set]
    ss_edges = [(i, j) for i in set_ids for j in succs[i]
                if nodes[j].is_set]

    # SET-contracted successor sets over compute ops.
    csuccs: List[Set[int]] = [set() for _ in range(n_nodes)]
    for i in range(n_nodes):
        if nodes[i].is_set:
            continue
        for j in succs[i]:
            if nodes[j].is_set:
                csuccs[i] |= {k for k in succs[j] if not nodes[k].is_set}
                csuccs[i].discard(i)
            else:
                csuccs[i].add(j)

    op_ids = [i for i in range(n_nodes) if not nodes[i].is_set]
    prio = critical_path(csuccs)
    npred = [0] * n_nodes
    for i in op_ids:
        for j in csuccs[i]:
            npred[j] += 1
    est = [0] * n_nodes
    released = {i for i in op_ids if npred[i] == 0}
    lay = prog.layout

    def order(i: int) -> Tuple[int, int, int]:
        # Original-cycle-major: preserves lockstep stage alignment;
        # critical path only breaks ties within a stage.
        return (nodes[i].orig_t, -prio[i], i)

    place: Dict[int, int] = {}
    op_cycles: List[List[Op]] = []
    t = 0
    scheduled = 0
    while scheduled < len(op_ids):
        cand = [i for i in released if est[i] <= t]
        if not cand:
            t = min(est[i] for i in released)
            cand = [i for i in released if est[i] <= t]
        spans: List[Tuple[int, int]] = []
        placed: List[int] = []
        for i in sorted(cand, key=order):
            lo, hi = op_span(lay, nodes[i].op)
            if all(hi < a or lo > b for a, b in spans):
                spans.append((lo, hi))
                placed.append(i)
        op_cycles.append([nodes[i].op for i in placed])
        for i in placed:
            place[i] = t
            released.discard(i)
            scheduled += 1
            for j in csuccs[i]:
                npred[j] -= 1
                if est[j] < t + 1:
                    est[j] = t + 1
                if npred[j] == 0:
                    released.add(j)
        t += 1

    # Boundary windows: boundary b = an init cycle inserted between op
    # cycles b-1 and b (0 = before everything, T = after everything).
    n_op_cycles = len(op_cycles)
    lo_w: Dict[int, int] = {}
    hi_w: Dict[int, int] = {}
    for i in set_ids:
        lo_w[i] = max((place[p] + 1 for p in preds[i]
                       if not nodes[p].is_set), default=0)
        hi_w[i] = min((place[s] for s in succs[i]
                       if not nodes[s].is_set), default=n_op_cycles)
        if lo_w[i] > hi_w[i]:          # contraction precondition failed
            return None
    for i, j in ss_edges:
        if hi_w[i] >= lo_w[j]:         # unmediated SET -> SET ordering
            return None

    # Greedy deadline stabbing: provably minimal boundary count, and
    # each stab sits at a window deadline — i.e. ALAP init placement.
    stabs: Dict[int, List[int]] = {}
    cur: Optional[int] = None
    for hi, _lo, i in sorted((hi_w[i], lo_w[i], i) for i in set_ids):
        if cur is None or cur < lo_w[i]:
            cur = hi
        stabs.setdefault(cur, []).append(nodes[i].set_col)

    cycles: List[Cycle] = []
    for b in range(n_op_cycles + 1):
        if b in stabs:
            cycles.append(Cycle(init_cells=sorted(set(stabs[b])),
                                note="ls:init"))
        if b < n_op_cycles:
            cycles.append(Cycle(ops=op_cycles[b], note="ls:stab"))
    return Program(layout=lay, cycles=cycles,
                   input_map=prog.input_map, output_map=prog.output_map,
                   name=prog.name)
