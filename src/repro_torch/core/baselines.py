"""Baseline in-memory multipliers the paper compares against.

* ``hajali_multiplier`` — Haj-Ali et al. [19]: single-partition
  shift-and-add with MAGIC NOT/NOR only. Cited latency 13N^2 - 14N + 6,
  area 20N - 5. Our reconstruction is functionally exact and lands in the
  same quadratic regime (the cited closed forms drive the comparison
  tables; measured counts are reported alongside).

* ``rime_multiplier`` — RIME [22]: partitioned multiplier whose bottleneck
  is *serial* inter-partition data movement (81% of its latency, per the
  MultPIM paper). Cited latency 2N^2 + 16N - 19, area 15N - 12, N-1
  partitions, gate set NOT/NOR/NAND/Min3. We reconstruct the structure
  (serial broadcast, serial sum shift, partition-parallel FAs) to
  demonstrate exactly the bottleneck MultPIM's Section III techniques
  remove; the gate-exact RIME schedule is not reproduced (upper-bound
  measured count, cited form used in tables).

Both produce bit-exact products (validated against ``a*b`` in tests).
"""
from __future__ import annotations

from typing import List

from .isa import Gate, Op
from .multpim import _Unit
from .program import Layout, Program, ProgramBuilder

__all__ = ["hajali_multiplier", "rime_multiplier",
           "hajali_multiplier_compiled", "rime_multiplier_compiled",
           "hajali_latency_formula", "hajali_area_formula",
           "rime_latency_formula", "rime_area_formula"]


def hajali_multiplier_compiled(n: int) -> Program:
    """:func:`hajali_multiplier` through the shared engine (optimized,
    differentially verified, memoized per OpSpec)."""
    from repro_torch.engine import get_engine   # lazy: avoids import cycle
    return get_engine().compile("hajali", n).program


def rime_multiplier_compiled(n: int) -> Program:
    """:func:`rime_multiplier` through the shared engine — the compaction
    pass removes RIME's serial-movement cycles (1043 -> 563 at N=16)."""
    from repro_torch.engine import get_engine   # lazy: avoids import cycle
    return get_engine().compile("rime", n).program


def hajali_latency_formula(n: int) -> int:
    """Haj-Ali et al. multiplier latency in cycles."""
    return 13 * n * n - 14 * n + 6


def hajali_area_formula(n: int) -> int:
    """Haj-Ali et al. multiplier area in memristors."""
    return 20 * n - 5


def rime_latency_formula(n: int) -> int:
    """RIME multiplier latency in cycles."""
    return 2 * n * n + 16 * n - 19


def rime_area_formula(n: int) -> int:
    """RIME multiplier area in memristors."""
    return 15 * n - 12


# ----------------------------------------------------------- Haj-Ali ----
def _nor_fa(pb, a, b, c, scratch, s_out, c_out, note=""):
    """Classic 9-gate NOR full adder (inputs true, outputs true).

    ``scratch``: 7 fresh cells n1..n7 (n6/n7 feed S; n1/n5 feed Cout).
    """
    n1, n2, n3, n4, n5, n6, n7 = scratch
    pb.cycle([Op(Gate.NOR, (a, b), n1)], note=f"{note}n1")
    pb.cycle([Op(Gate.NOR, (a, n1), n2)], note=f"{note}n2")
    pb.cycle([Op(Gate.NOR, (b, n1), n3)], note=f"{note}n3")
    pb.cycle([Op(Gate.NOR, (n2, n3), n4)], note=f"{note}n4")   # xnor(a,b)
    pb.cycle([Op(Gate.NOR, (n4, c), n5)], note=f"{note}n5")
    pb.cycle([Op(Gate.NOR, (n4, n5), n6)], note=f"{note}n6")
    pb.cycle([Op(Gate.NOR, (c, n5), n7)], note=f"{note}n7")
    pb.cycle([Op(Gate.NOR, (n6, n7), s_out)], note=f"{note}S")
    pb.cycle([Op(Gate.NOR, (n1, n5), c_out)], note=f"{note}C")


def hajali_multiplier(n: int) -> Program:
    """Single-row, single-partition NOT/NOR shift-and-add multiplier.

    Invariant: after iteration i, acc slot t holds product weight i+t+1
    (lower weights already emitted to the output cells).
    """
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    p = lay.new_partition()
    a = [lay.add_cell(p, f"a{j}") for j in range(n)]
    b = [lay.add_cell(p, f"b{j}") for j in range(n)]
    an = [lay.add_cell(p, f"an{j}") for j in range(n)]
    bn = lay.add_cell(p, "bn")
    pp = [lay.add_cell(p, f"pp{j}") for j in range(n)]
    accA = [lay.add_cell(p, f"accA{j}") for j in range(n)]
    accB = [lay.add_cell(p, f"accB{j}") for j in range(n)]
    fasc = [[lay.add_cell(p, f"fa{j}_{t}") for t in range(7)] for j in range(n)]
    xtr = lay.add_cell(p, "xtr")
    car = [lay.add_cell(p, f"car{j}") for j in range(n + 1)]
    out = [lay.add_cell(p, f"out{j}") for j in range(2 * n)]

    pb = ProgramBuilder(lay, name=f"hajali_{n}")
    pb.declare_input("a", a)
    pb.declare_input("b", b)

    pb.init(an + [bn], note="setup")
    for j in range(n):
        pb.cycle([Op(Gate.NOT, (a[j],), an[j])], note=f"a'{j}")

    banks = [accA, accB]
    for i in range(n):
        acc_w = banks[i % 2]       # written this iteration
        acc_r = banks[(i + 1) % 2]  # read this iteration (i >= 1)
        flat = [c for sc in fasc for c in sc]
        if i == 0:
            # pp0 weight t: t=0 -> out[0] (final), t>=1 -> acc slot t-1.
            pb.init([bn] + acc_w + [out[0], car[0]], note="it0:init")
            pb.cycle([Op(Gate.NOT, (b[0],), bn)], note="b'0")
            pb.cycle([Op(Gate.NOR, (an[0], bn), out[0])], note="pp0_0")
            for t in range(1, n):
                pb.cycle([Op(Gate.NOR, (an[t], bn), acc_w[t - 1])],
                         note=f"pp0_{t}")
            # top slot (weight n) = 0:
            pb.cycle([Op(Gate.NOT, (car[0],), acc_w[n - 1])], note="top0=0")
            continue
        pb.init([bn] + pp + flat + acc_w + car + [out[i], xtr],
                note=f"it{i}:init")
        pb.cycle([Op(Gate.NOT, (b[i],), bn)], note=f"b'{i}")
        for t in range(n):
            pb.cycle([Op(Gate.NOR, (an[t], bn), pp[t])], note=f"pp{i}_{t}")
        # carry-in = 0 (fresh SET cell negated into car[0]... car[0] was
        # just initialized; negate an initialized scratch to get 0):
        pb.cycle([Op(Gate.NOT, (fasc[0][0],), car[0])], note=f"it{i}:c0")
        for t in range(n):
            s_dst = out[i] if t == 0 else acc_w[t - 1]
            _nor_fa(pb, pp[t], acc_r[t], car[t],
                    fasc[t] if t > 0 else fasc[0][1:] + [xtr],
                    s_dst, car[t + 1], note=f"it{i}fa{t}:")
        # top slot (weight i+n) = final carry (copy, 2 NOTs):
        pb.cycle([Op(Gate.NOT, (car[n],), fasc[0][0])], note=f"it{i}:cw'")
        pb.cycle([Op(Gate.NOT, (fasc[0][0],), acc_w[n - 1])],
                 note=f"it{i}:top")

    # remaining bank holds weights n..2n-1 -> out[n..2n-1] (2-NOT copies)
    acc_f = banks[(n - 1) % 2]
    pb.init([fasc[t][0] for t in range(n)] + out[n:], note="fin:init")
    for t in range(n):
        pb.cycle([Op(Gate.NOT, (acc_f[t],), fasc[t][0])])
        pb.cycle([Op(Gate.NOT, (fasc[t][0],), out[n + t])])

    pb.declare_output("out", out)
    return pb.build()


# -------------------------------------------------------------- RIME ----
def rime_multiplier(n: int) -> Program:
    """Structural RIME reconstruction: partitioned CSAS with *serial*
    broadcast and *serial* sum movement (the pre-MultPIM state of the
    art's bottleneck), partition-parallel Min3 FAs."""
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    pids = [lay.new_partition() for _ in range(n)]
    a_in = [lay.add_cell(0, f"in_a{j}") for j in range(n)]
    b_in = [lay.add_cell(0, f"in_b{j}") for j in range(n)]

    units: List[_Unit] = []
    for pid in pids:
        ac = lay.add_cell(pid, "a")
        bc = lay.add_cell(pid, "b") if pid != 0 else -1
        ab = lay.add_cell(pid, "ab") if pid % 2 == 1 else -1
        s = (lay.add_cell(pid, "s0"), lay.add_cell(pid, "s1"))
        c = (lay.add_cell(pid, "cA"), lay.add_cell(pid, "cB"))
        cn = (lay.add_cell(pid, "cAn"), lay.add_cell(pid, "cBn"))
        t2 = lay.add_cell(pid, "t2")
        zero = lay.add_cell(pid, "zero") if pid != 0 else -1
        units.append(_Unit(ac, bc, ab, s, c, cn, t2, zero))
    tmp = [lay.add_cell(pid, "tmp") for pid in pids]  # serial-shift relay
    out_cols = [lay.add_cell(n - 1, f"out{j}") for j in range(2 * n)]

    pb = ProgramBuilder(lay, name=f"rime_{n}")
    pb.declare_input("a", a_in)
    pb.declare_input("b", b_in)

    cells = []
    for u in units:
        cells += [u.a, u.s[0], u.s[1], u.c[0], u.c[1], u.cn[0], u.cn[1], u.t2]
        if u.b >= 0:
            cells.append(u.b)
        if u.ab >= 0:
            cells.append(u.ab)
        if u.zero >= 0:
            cells.append(u.zero)
    pb.init(cells + tmp, note="setup")
    pb.cycle([Op(Gate.NOT, (u.t2,), u.s[0]) for u in units], note="s=0")
    pb.cycle([Op(Gate.NOT, (u.t2,), u.c[0]) for u in units], note="c=0")

    for j in range(n):
        ops = [Op(Gate.NOT, (a_in[n - 1 - j],), units[j].a)]
        if j == 0:
            ops += [Op(Gate.NOT, (u.t2,), u.zero) for u in units[1:]]
        pb.cycle(ops, note=f"copy:{j}")

    def stage(k: int, with_pp: bool):
        rs, ws = (k - 1) % 2, k % 2
        rc, wc = (k - 1) % 2, k % 2
        init_cells = [out_cols[k - 1]]
        for pid, u in enumerate(units):
            init_cells += [u.cn[wc], u.c[wc], u.t2, u.s[ws], tmp[pid]]
            if with_pp and u.b >= 0:
                init_cells.append(u.b)
            if with_pp and u.ab >= 0:
                init_cells.append(u.ab)
        pb.init(init_cells, note=f"R{k}:init")

        pp_col = []
        if with_pp:
            # serial broadcast: NOT chain hop by hop (Fig. 3(a) naive);
            # polarity at pid = pid mod 2 hops.
            for pid in range(1, n):
                src = b_in[k - 1] if pid == 1 else units[pid - 1].b
                pb.cycle([Op(Gate.NOT, (src,), units[pid].b)],
                         note=f"R{k}:bcast{pid}")
            ops = []
            for pid, u in enumerate(units):
                land = b_in[k - 1] if pid == 0 else u.b
                if pid % 2 == 0:      # holds true b_k: no-init AND
                    ops.append(Op(Gate.NOT, (u.a,), land))
                    pp_col.append(land)
                else:                 # holds b'_k
                    ops.append(Op(Gate.MIN3, (u.a, land, u.t2), u.ab))
                    pp_col.append(u.ab)
            pb.cycle(ops, note=f"R{k}:pp")
        else:
            pp_col = [u.zero for u in units]

        # partition-parallel FA (sum lands locally in tmp, complemented)
        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.c[rc]), u.cn[wc])
                  for pid, u in enumerate(units) if with_pp or pid > 0],
                 note=f"R{k}:t1")
        pb.cycle([Op(Gate.NOT, (u.cn[wc],), u.c[wc])
                  for pid, u in enumerate(units) if with_pp or pid > 0],
                 note=f"R{k}:cnot")
        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.cn[rc]), u.t2)
                  for pid, u in enumerate(units) if with_pp or pid > 0],
                 note=f"R{k}:t2")
        # local sum into relay, batched (intra-partition):
        sum_ops = [Op(Gate.MIN3, (u.c[wc], u.cn[rc], u.t2), tmp[pid])
                   for pid, u in enumerate(units) if with_pp or pid > 0]
        if not with_pp:  # drain: partition 0 relays a 0
            sum_ops.append(Op(Gate.NOT, (units[0].cn[rc],), tmp[0]))
        pb.cycle(sum_ops, note=f"R{k}:sum")
        # batched local complement:
        pb.init([u.t2 for u in units], note=f"R{k}:reinit-t2")
        pb.cycle([Op(Gate.NOT, (tmp[pid],), u.t2)
                  for pid, u in enumerate(units)], note=f"R{k}:compl")
        # *serial* cross-partition movement, one hop per cycle (this is
        # the bottleneck MultPIM's 2-cycle shift removes):
        for pid in range(n - 1, -1, -1):
            dst = units[pid + 1].s[ws] if pid + 1 < n else out_cols[k - 1]
            pb.cycle([Op(Gate.NOT, (units[pid].t2,), dst)],
                     note=f"R{k}:mv{pid}")
        # partition 0 sum-in = 0 for next stage (rides last move's cycle
        # only if spans disjoint; keep it serial for the upper bound):
        pb.cycle([Op(Gate.NOT, (units[0].cn[rc],), units[0].s[ws])],
                 note=f"R{k}:s0")

    for k in range(1, n + 1):
        stage(k, with_pp=True)
    for k in range(n + 1, 2 * n + 1):
        stage(k, with_pp=False)

    pb.declare_output("out", out_cols)
    return pb.build()
