"""MultPIM: the paper's N-bit single-row multiplier (Algorithm 1).

Carry-save add-shift (CSAS) over N partitions, one full-adder unit per
partition. Partition ``pid`` (0-based; the paper's ``p_{pid+1}``) stores
``a'_{N-1-pid}`` for the whole run. Stage ``k`` (1..N) broadcasts ``b_k``
(log2 N-cycle NOT tree, Section III-A), forms partial products in place
(optimization IV-B2), runs the 4-cycle FA in every partition (both carry
polarities are kept, Section IV-B1), and shifts sums to the next partition
in 2 cycles (Section III-B), emitting one product bit per stage. Stages
N+1..2N propagate the remaining carries with half-adders (zero partial
product), 6 cycles each.

Cycle budget (compiler-counted, asserted in tests == Table I):

    setup                      3                (batched INIT; s<-0; c<-0)
    copy a                     N                (serial NOTs from p_0)
    first N stages             N * (ceil(log2 N) + 7)
                               = init 1 + bcast log2N + pp 1 + FA 3 + shift 2
    last N stages              N * 6
                               = init 1 + FA 3 + shift 2
    total                      N*log2(N) + 14N + 3      [Table I]

(The paper's Section V-A prose says "log2 N + 8" per first-stage but its
own component list — (log2 N + 1) + 5 + 1 — sums to log2 N + 7, which is
what Table I's closed form requires. We match Table I.)

Area: compiler-counted distinct cells; ~14.5N vs the paper's 14N-7 (we
keep the top partition's degenerate FA generic and do not merge p_0/p_1,
trading <= 0.6N memristors for a simpler, fully-validated schedule; the
partition count is N vs the paper's N-1 for the same reason). Both
numbers are reported side by side in EXPERIMENTS.md.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from .isa import Gate, Op
from .program import Layout, Program, ProgramBuilder

__all__ = ["multpim_multiplier", "multpim_multiplier_compiled",
           "broadcast_schedule", "multpim_latency_formula",
           "multpim_area_formula"]


def multpim_latency_formula(n: int) -> int:
    """Table I closed form."""
    return n * math.ceil(math.log2(n)) + 14 * n + 3


def multpim_area_formula(n: int) -> int:
    """Table II closed form."""
    return 14 * n - 7


def broadcast_schedule(n: int) -> List[List[Tuple[int, int]]]:
    """Section III-A recursive-doubling broadcast over partitions 0..n-1.

    Partition 0 is the root (it holds the bit). Returns per-level lists of
    ``(src_pid, dst_pid)``; ``ceil(log2 n)`` levels; spans within a level
    are disjoint (validated by the program validator).
    """
    levels: List[List[Tuple[int, int]]] = [[] for _ in range(max(1, math.ceil(math.log2(n))) if n > 1 else 0)]

    def cover(lo: int, hi: int, src: int, level: int):
        if lo == hi:
            return
        mid = (lo + hi + 1) // 2
        levels[level].append((src, mid))
        cover(lo, mid - 1, src, level + 1)
        cover(mid, hi, mid, level + 1)

    if n > 1:
        cover(0, n - 1, 0, 0)
    return levels


def multpim_multiplier_compiled(n: int, skip_last_stages: bool = False) -> Program:
    """:func:`multpim_multiplier` routed through the shared engine:
    optimized, differentially verified against the raw build and
    memoized per OpSpec — see :meth:`repro_torch.engine.Engine.compile`."""
    from repro_torch.engine import get_engine   # lazy: avoids import cycle
    return get_engine().compile(
        "multpim", n,
        flags={"skip_last_stages": True} if skip_last_stages else None,
    ).program


@dataclass
class _Unit:
    """Column indices of one partition's FA unit."""
    a: int              # a'_{N-1-pid}
    b: int              # broadcast landing cell (-1 for pid 0: uses input col)
    ab: int             # partial-product cell (-1 for even-parity receivers)
    s: Tuple[int, int]  # alternating sum latches
    c: Tuple[int, int]  # carry latches (A, B buffers)
    cn: Tuple[int, int]  # carry-complement latches
    t2: int
    zero: int           # -1 for pid 0 (never needs it)


def multpim_multiplier(n: int, skip_last_stages: bool = False,
                       name: Optional[str] = None) -> Program:
    """Build the MultPIM program for ``n``-bit inputs.

    ``skip_last_stages`` stops after the first N stages (used by the
    Section VI MAC variant, which keeps the accumulator in carry-save
    form); outputs then include the final sum/carry latches.
    """
    if n < 2:
        raise ValueError("n >= 2")
    log_n = math.ceil(math.log2(n))
    lay = Layout()

    # Partition 0 hosts the input region (paper: p_0 merged into p_1);
    # partition n-1 hosts the output region (p_{N+1} merged into p_N).
    pids = [lay.new_partition() for _ in range(n)]

    a_in = [lay.add_cell(0, f"in_a{j}") for j in range(n)]
    b_in = [lay.add_cell(0, f"in_b{j}") for j in range(n)]

    # Broadcast tree: parity (number of NOT hops from the root input cell)
    levels = broadcast_schedule(n)
    parity = {0: 0}
    for lvl in levels:
        for src, dst in lvl:
            parity[dst] = parity[src] ^ 1

    units: List[_Unit] = []
    for pid in pids:
        a = lay.add_cell(pid, "a")
        b = lay.add_cell(pid, "b") if pid != 0 else -1
        # Odd parity -> cell holds b'_k -> needs a separate pp cell.
        ab = lay.add_cell(pid, "ab") if parity[pid] == 1 else -1
        s = (lay.add_cell(pid, "s0"), lay.add_cell(pid, "s1"))
        c = (lay.add_cell(pid, "cA"), lay.add_cell(pid, "cB"))
        cn = (lay.add_cell(pid, "cAn"), lay.add_cell(pid, "cBn"))
        t2 = lay.add_cell(pid, "t2")
        zero = lay.add_cell(pid, "zero") if pid != 0 else -1
        units.append(_Unit(a, b, ab, s, c, cn, t2, zero))

    n_out = n if skip_last_stages else 2 * n
    out_cols = [lay.add_cell(n - 1, f"out{j}") for j in range(n_out)]

    pb = ProgramBuilder(lay, name=name or f"multpim_{n}")
    pb.declare_input("a", a_in)
    pb.declare_input("b", b_in)

    # ------------------------------------------------------- setup: 3 ----
    all_unit_cells = []
    for u in units:
        all_unit_cells += [u.a, u.s[0], u.s[1], u.c[0], u.c[1],
                           u.cn[0], u.cn[1], u.t2]
        if u.b >= 0:
            all_unit_cells.append(u.b)
        if u.ab >= 0:
            all_unit_cells.append(u.ab)
        if u.zero >= 0:
            all_unit_cells.append(u.zero)
    pb.init(all_unit_cells, note="setup:init-all")
    pb.cycle([Op(Gate.NOT, (u.t2,), u.s[0], note="s<-0") for u in units],
             note="setup:s=0")
    pb.cycle([Op(Gate.NOT, (u.t2,), u.c[0], note="c<-0") for u in units],
             note="setup:c=0")

    # ------------------------------------------------------ copy a: N ----
    # Serial: cycle j copies a_{N-j} into partition j-1 (as complement).
    # Co-scheduled in cycle 1: partitions 1..N-1 manufacture their
    # constant-0 cell (NOT of the still-initialized t2), legal because the
    # copy op only engages the partition span [0, 0].
    for j in range(n):
        ops = [Op(Gate.NOT, (a_in[n - 1 - j],), units[j].a, note=f"copy a{n-1-j}")]
        if j == 0:
            ops += [Op(Gate.NOT, (u.t2,), u.zero, note="zero<-0")
                    for u in units[1:]]
        pb.cycle(ops, note=f"copy:{j}")

    # ------------------------------------------- first N stages ----------
    for k in range(1, n + 1):
        rs, ws = (k - 1) % 2, k % 2          # read/write sum parity
        rc, wc = (k - 1) % 2, k % 2          # read/write carry buffer
        stage = f"S{k}"

        # 1 init cycle: every cell written this stage.
        init_cells = [out_cols[k - 1]]
        for pid, u in enumerate(units):
            init_cells += [u.cn[wc], u.c[wc], u.t2, u.s[ws]]
            if u.b >= 0:
                init_cells.append(u.b)
            if u.ab >= 0:
                init_cells.append(u.ab)
        pb.init(init_cells, note=f"{stage}:init")

        # log2 N broadcast cycles (NOT tree rooted at the input b_k cell).
        for li, lvl in enumerate(levels):
            ops = []
            for src, dst in lvl:
                src_col = b_in[k - 1] if src == 0 else units[src].b
                ops.append(Op(Gate.NOT, (src_col,), units[dst].b,
                              note=f"{stage}:bcast{li}"))
            pb.cycle(ops, note=f"{stage}:bcast{li}")

        # 1 partial-product cycle (optimization IV-B2).
        pp_col: List[int] = []
        ops = []
        for pid, u in enumerate(units):
            land = b_in[k - 1] if pid == 0 else u.b
            if parity[pid] == 0:
                # landed true b_k: no-init NOT(a') into the landing cell
                # -> b_k AND a  (X-MAGIC AND-with-old-value semantics).
                ops.append(Op(Gate.NOT, (u.a,), land, note=f"{stage}:pp"))
                pp_col.append(land)
            else:
                # landed b'_k: Min3(a', b', <SET cell>) = a AND b.
                ops.append(Op(Gate.MIN3, (u.a, land, u.t2), u.ab,
                              note=f"{stage}:pp"))
                pp_col.append(u.ab)
        pb.cycle(ops, note=f"{stage}:pp")

        # 3 FA cycles (both carry polarities kept: eq. (1) output is the
        # next stage's carry complement for free).
        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.c[rc]), u.cn[wc],
                     note=f"{stage}:t1") for pid, u in enumerate(units)],
                 note=f"{stage}:t1")
        pb.cycle([Op(Gate.NOT, (u.cn[wc],), u.c[wc], note=f"{stage}:cw")
                  for u in units], note=f"{stage}:cnot")
        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.cn[rc]), u.t2,
                     note=f"{stage}:t2") for pid, u in enumerate(units)],
                 note=f"{stage}:t2")

        # 2 shift cycles (Section III-B): Sout = Min3(c_out, c_in', t2)
        # computed directly into the right neighbour's sum latch.
        def sout_op(pid: int) -> Op:
            u = units[pid]
            dst = units[pid + 1].s[ws] if pid + 1 < n else out_cols[k - 1]
            return Op(Gate.MIN3, (u.c[wc], u.cn[rc], u.t2), dst,
                      note=f"{stage}:sout{pid}")

        ph1 = [sout_op(pid) for pid in range(0, n, 2)]
        pb.cycle(ph1, note=f"{stage}:shift1")
        ph2 = [sout_op(pid) for pid in range(1, n, 2)]
        # Partition 0's next-stage sum-in is 0 (nothing above the MSB):
        # NOT of its read-buffer carry complement (provably 1) -> 0.
        ph2.append(Op(Gate.NOT, (units[0].cn[rc],), units[0].s[ws],
                      note=f"{stage}:s0<-0"))
        pb.cycle(ph2, note=f"{stage}:shift2")

    if skip_last_stages:
        pb.declare_output("lo", out_cols[:n])
        fs, fc = n % 2, n % 2
        pb.declare_output("s_latch", [u.s[fs] for u in units])
        pb.declare_output("c_latch", [u.c[fc] for u in units])
        pb.declare_output("cn_latch", [u.cn[fc] for u in units])
        return pb.build()

    # -------------------------------------------- last N stages ----------
    # Half-adders: same FA with the partial product replaced by the
    # constant-0 cell. Partition 0 is fully drained (its sum and carry are
    # both 0 after stage N... its carry is always 0 and its sum-in is 0),
    # so it degenerates: it only feeds a 0 into partition 1's sum latch.
    for k in range(n + 1, 2 * n + 1):
        rs, ws = (k - 1) % 2, k % 2
        rc, wc = (k - 1) % 2, k % 2
        stage = f"H{k}"

        init_cells = [out_cols[k - 1]]
        for u in units[1:]:
            init_cells += [u.cn[wc], u.c[wc], u.t2, u.s[ws]]
        pb.init(init_cells, note=f"{stage}:init")

        pb.cycle([Op(Gate.MIN3, (u.s[rs], u.zero, u.c[rc]), u.cn[wc],
                     note=f"{stage}:t1") for u in units[1:]],
                 note=f"{stage}:t1")
        pb.cycle([Op(Gate.NOT, (u.cn[wc],), u.c[wc]) for u in units[1:]],
                 note=f"{stage}:cnot")
        pb.cycle([Op(Gate.MIN3, (u.s[rs], u.zero, u.cn[rc]), u.t2)
                  for u in units[1:]], note=f"{stage}:t2")

        def sout_op_ha(pid: int) -> Op:
            u = units[pid]
            dst = units[pid + 1].s[ws] if pid + 1 < n else out_cols[k - 1]
            if pid == 0:
                # degenerate: sum-in for partition 1 is 0 = NOT(known-1).
                return Op(Gate.NOT, (u.cn[rc],), dst, note=f"{stage}:sout0")
            return Op(Gate.MIN3, (u.c[wc], u.cn[rc], u.t2), dst,
                      note=f"{stage}:sout{pid}")

        pb.cycle([sout_op_ha(pid) for pid in range(0, n, 2)],
                 note=f"{stage}:shift1")
        pb.cycle([sout_op_ha(pid) for pid in range(1, n, 2)],
                 note=f"{stage}:shift2")

    pb.declare_output("out", out_cols)
    return pb.build()
