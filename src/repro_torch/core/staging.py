"""In-crossbar staging and recombination micro-programs.

These close the carry-save MAC chain's last two host round-trips as real,
verified PIM programs (ROADMAP "packed recombination kernel" follow-on):

* :func:`stage_program` — the **inter-pass restage**. A MAC pass leaves
  ``s = lo + (s_hi << n)`` and ``c = c_hi << n`` in carry-save form; the
  next pass wants its latch pre-loads ``un = NOT((s >> n) + (c >> n))``
  and ``s_lo = s mod 2^n`` (while ``c_lo`` of the next pass is always 0,
  because ``c``'s low half is zero by construction — so ``c_lo``/
  ``c_lo_n`` are constants, state initialization rather than compute).
  The program ripples ``s_hi + c_hi`` with the Section IV-B1 full adder
  (complement chained for free), NOTs each sum bit into ``un``, and
  copies ``lo`` into the ``s_lo`` staging cells on a second partition
  lane that rides the same cycles. Measured cost ``5N + 1`` cycles —
  strictly below the analytic host-staging budget
  :func:`repro_torch.core.matvec.STAGING_CYCLES` (= ``8N + 2``) it replaces.

* :func:`recomb_program` — the **final recombination** at drain. The
  token value ``(s + c) mod 2^(2N)`` equals ``lo + (((s_hi + c_hi) mod
  2^N) << N)``, so one N-bit ripple over the carry-save upper halves
  plus the low word is the whole merge: output ``out`` is the final
  2N-bit product-sum directly. Measured cost ``4N + 1`` cycles —
  strictly below the analytic ``5 * 2N`` ripple charge it replaces.

Overflow semantics: the ripple in ``stage`` drops the carry out of bit
N-1, i.e. the u-stream wraps mod ``2^N``. The host marshalling path
(:meth:`repro_torch.engine.Engine.mac_inputs`) raises :class:`OverflowError`
instead; callers keep the same no-overflow precondition (running inner
product fits in 2N bits) that the paper's Section VI feed requires.

Both kinds register in the compiler cache (``"stage"`` / ``"recomb"``),
so they are optimized, differentially verified, disk-spilled, and
cycle-accounted exactly like every other program family.
"""
from __future__ import annotations

from typing import List, Optional

from .adders import multpim_fa_ops
from .isa import Gate, Op
from .program import Layout, Program, ProgramBuilder

__all__ = ["stage_program", "recomb_program"]


def _paired_cycles(pb: ProgramBuilder, main_ops: List[Op],
                   side_ops: List[Op], note: str) -> None:
    """Emit ``main_ops`` one per cycle, each cycle also carrying one
    pending ``side_ops`` entry (a disjoint-partition lane), until the
    side queue drains. The side lane rides for free: spans in distinct
    partitions never conflict."""
    for op in main_ops:
        ops = [op]
        if side_ops:
            ops.append(side_ops.pop(0))
        pb.cycle(ops, note=f"{note}:{op.note or op.gate.name}")


def _ripple_un(pb: ProgramBuilder, n: int, sh: List[int], ch: List[int],
               sbar: List[int], coutn: List[int], cout: List[int],
               t2: List[int], one: int, u0: int,
               un: Optional[List[int]], side_ops: List[Op],
               note: str) -> None:
    """Ripple ``sh + ch`` (LE cell lists) with the 4-cycle MultPIM FA;
    sum bits land in ``sbar``. When ``un`` is given, each sum bit is
    additionally NOTed into it (the complemented u-stream feed). Side
    ops (a disjoint partition lane) ride along one per cycle."""
    # Bit 0 half adder: u = NOR(a,b), c1' = Min3(a,b,u), c1 = NOT(c1'),
    # s0 = NOR(c1,u) — same construction as repro_torch.core.adders.
    bit0 = [
        Op(Gate.MIN3, (sh[0], ch[0], one), u0, note="u=NOR"),
        Op(Gate.MIN3, (sh[0], ch[0], u0), coutn[0], note="c1'"),
        Op(Gate.NOT, (coutn[0],), cout[0], note="c1"),
        Op(Gate.MIN3, (cout[0], u0, one), sbar[0], note="s0"),
    ]
    if un is not None:
        bit0.append(Op(Gate.NOT, (sbar[0],), un[0], note="un0"))
    _paired_cycles(pb, bit0, side_ops, f"{note}0")
    for j in range(1, n):
        ops = multpim_fa_ops(sh[j], ch[j], cout[j - 1], coutn[j - 1],
                             t2[j], coutn[j], cout[j], sbar[j],
                             note=f"{note}{j}")
        if un is not None:
            ops.append(Op(Gate.NOT, (sbar[j],), un[j], note=f"un{j}"))
        _paired_cycles(pb, ops, side_ops, f"{note}{j}")


def _copy_lane(lay: Layout, pid: int, n: int, src_name: str
               ) -> "tuple[List[int], List[Op]]":
    """Allocate ``src``/``tmp``/``dst`` cell triples in partition ``pid``
    and return (src_cells, dst_cells, init_cells, copy_ops): each copy is
    two NOTs through a scratch cell (stateful logic has no direct MOV)."""
    src = [lay.add_cell(pid, f"{src_name}{j}") for j in range(n)]
    tmp = [lay.add_cell(pid, f"{src_name}_t{j}") for j in range(n)]
    dst = [lay.add_cell(pid, f"{src_name}_o{j}") for j in range(n)]
    ops: List[Op] = []
    for j in range(n):
        ops.append(Op(Gate.NOT, (src[j],), tmp[j], note=f"cp{j}a"))
        ops.append(Op(Gate.NOT, (tmp[j],), dst[j], note=f"cp{j}b"))
    return src, dst, tmp, ops


def stage_program(n: int) -> Program:
    """Inter-pass restage: ``(s_hi, c_hi, lo) -> (un, s_lo)``.

    ``un = NOT((s_hi + c_hi) mod 2^n)`` — the complemented u-stream the
    next MAC pass feeds one bit per stage; ``s_lo`` — the emitted low
    word copied into the next pass's sum-latch staging cells. The carry
    latch constants (``c_lo = 0``, ``c_lo_n = 1``) are state
    initialization, charged to the pass's alloc/INIT, not to this
    program. ``1 + 5N`` cycles, two partitions (adder + copy lane).
    """
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    p_add = lay.new_partition()
    p_cp = lay.new_partition()
    sh = [lay.add_cell(p_add, f"sh{j}") for j in range(n)]
    ch = [lay.add_cell(p_add, f"ch{j}") for j in range(n)]
    un = [lay.add_cell(p_add, f"un{j}") for j in range(n)]
    sbar = [lay.add_cell(p_add, f"sb{j}") for j in range(n)]
    coutn = [lay.add_cell(p_add, f"cn{j}") for j in range(n)]
    cout = [lay.add_cell(p_add, f"c{j}") for j in range(n)]
    t2 = [lay.add_cell(p_add, f"t2_{j}") if j else -1 for j in range(n)]
    one = lay.add_cell(p_add, "one")
    u0 = lay.add_cell(p_add, "u0")
    lo, slo, tmp, copies = _copy_lane(lay, p_cp, n, "lo")

    pb = ProgramBuilder(lay, name=f"stage_{n}")
    pb.declare_input("s_hi", sh)
    pb.declare_input("c_hi", ch)
    pb.declare_input("lo", lo)
    pb.init(un + sbar + coutn + cout + t2[1:] + [one, u0] + tmp + slo,
            note="init")
    _ripple_un(pb, n, sh, ch, sbar, coutn, cout, t2, one, u0, un,
               copies, "fa")
    assert not copies, "copy lane did not drain into the adder cycles"
    pb.declare_output("un", un)
    pb.declare_output("s_lo", slo)
    return pb.build()


def recomb_program(n: int) -> Program:
    """Final recombination at drain: ``(s_hi, c_hi, lo) -> out``.

    ``out = lo + (((s_hi + c_hi) mod 2^n) << n)`` — equal to
    ``(s + c) mod 2^(2n)`` for the carry-save pair a MAC pass leaves
    (``s = lo + (s_hi << n)``, ``c = c_hi << n``), i.e. the emitted
    token itself. ``1 + 4N`` cycles, two partitions (adder + copy lane).
    """
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    p_add = lay.new_partition()
    p_cp = lay.new_partition()
    sh = [lay.add_cell(p_add, f"sh{j}") for j in range(n)]
    ch = [lay.add_cell(p_add, f"ch{j}") for j in range(n)]
    s = [lay.add_cell(p_add, f"s{j}") for j in range(n)]
    coutn = [lay.add_cell(p_add, f"cn{j}") for j in range(n)]
    cout = [lay.add_cell(p_add, f"c{j}") for j in range(n)]
    t2 = [lay.add_cell(p_add, f"t2_{j}") if j else -1 for j in range(n)]
    one = lay.add_cell(p_add, "one")
    u0 = lay.add_cell(p_add, "u0")
    lo, lo_out, tmp, copies = _copy_lane(lay, p_cp, n, "lo")

    pb = ProgramBuilder(lay, name=f"recomb_{n}")
    pb.declare_input("s_hi", sh)
    pb.declare_input("c_hi", ch)
    pb.declare_input("lo", lo)
    pb.init(s + coutn + cout + t2[1:] + [one, u0] + tmp + lo_out,
            note="init")
    _ripple_un(pb, n, sh, ch, s, coutn, cout, t2, one, u0, None,
               copies, "fa")
    assert not copies, "copy lane did not drain into the adder cycles"
    pb.declare_output("out", lo_out + s)
    return pb.build()
