"""Full-adder designs and N-bit ripple adders as PIM programs.

The paper's novel full adder (Section IV-B1):

    Cout = Min3'(A, B, Cin)                                   (1)
    Sout = Min3(Cout, Cin', Min3(A, B, Cin'))                 (2)

* 5 cycles with NOT/Min3 and 3 intermediates (Cin' computed);
* 4 cycles when Cin' is already stored (the trick MultPIM uses by keeping
  both carry polarities: eq. (1)'s Min3 *is* the next Cin').

The previous state of the art (FELIX) needs 6 cycles with
NOT/OR/NAND/Min3. Footnote 6: N-bit ripple addition in 5N cycles and
3N+5 memristors (vs FELIX 7N and 3N+2), including initialization.
The 3N+5 decomposes as 2N input cells + N sum cells + 5 rotating work
cells (two carry/carry' buffer pairs + one t2), which is how
:func:`ripple_adder` lays it out.
"""
from __future__ import annotations

from typing import List

from .isa import Gate, Op
from .program import Layout, Program, ProgramBuilder

__all__ = [
    "multpim_fa_ops",
    "full_adder_program",
    "felix_full_adder_program",
    "ripple_adder",
    "FA_CYCLES_MULTPIM",
    "FA_CYCLES_MULTPIM_PRENEG",
    "FA_CYCLES_FELIX",
]

FA_CYCLES_MULTPIM = 5          # NOT/Min3, Cin' computed
FA_CYCLES_MULTPIM_PRENEG = 4   # NOT/Min3, Cin' given
FA_CYCLES_FELIX = 6            # NOT/OR/NAND/Min3 (prior art)


def multpim_fa_ops(a: int, b: int, cin: int, cin_n: int,
                   t2: int, cout_n: int, cout: int, s_out: int,
                   note: str = "") -> List[Op]:
    """The 4-cycle MultPIM FA (Cin' pre-stored), one op per cycle.

    Writes: ``cout_n`` (= Min3(a,b,cin), the next stage's carry
    complement), ``cout``, ``t2`` (scratch), ``s_out``. All four output
    cells must be freshly initialized.
    """
    return [
        Op(Gate.MIN3, (a, b, cin), cout_n, note=f"{note}:t1"),
        Op(Gate.NOT, (cout_n,), cout, note=f"{note}:cout"),
        Op(Gate.MIN3, (a, b, cin_n), t2, note=f"{note}:t2"),
        Op(Gate.MIN3, (cout, cin_n, t2), s_out, note=f"{note}:sum"),
    ]


def full_adder_program(preneg: bool = False) -> Program:
    """Standalone 1-bit FA program (the Section IV-B1 object of study).

    Cycle count (excluding the single batched INIT, matching the paper's
    "without init." accounting): 5, or 4 with ``preneg`` (Cin' given).
    """
    lay = Layout()
    p = lay.new_partition()
    a = lay.add_cell(p, "a")
    b = lay.add_cell(p, "b")
    cin = lay.add_cell(p, "cin")
    cin_n = lay.add_cell(p, "cin_n")
    t2 = lay.add_cell(p, "t2")
    cout_n = lay.add_cell(p, "cout_n")
    cout = lay.add_cell(p, "cout")
    s = lay.add_cell(p, "s")

    pb = ProgramBuilder(lay, name=f"multpim_fa{'_preneg' if preneg else ''}")
    pb.declare_input("a", [a])
    pb.declare_input("b", [b])
    pb.declare_input("cin", [cin])
    if preneg:
        pb.declare_input("cin_n", [cin_n])
        pb.init([t2, cout_n, cout, s], note="init")
    else:
        pb.init([cin_n, t2, cout_n, cout, s], note="init")
        pb.cycle([Op(Gate.NOT, (cin,), cin_n)], note="cin'")
    for op in multpim_fa_ops(a, b, cin, cin_n, t2, cout_n, cout, s):
        pb.cycle([op], note=op.note)
    pb.declare_output("s", [s])
    pb.declare_output("cout", [cout])
    pb.declare_output("cout_n", [cout_n])
    return pb.build()


def felix_full_adder_program() -> Program:
    """Prior-art FELIX-gate-set FA (NOT/OR/NAND + no-init AND writes).

    The MultPIM paper cites FELIX's FA at **6 cycles** (without init) with
    2 intermediates; the closed-form tables in our benchmarks use that
    cited count. This executable reference is a 7-compute-cycle
    construction we can *verify* from FELIX's published primitives (OR,
    NAND, and the skip-initialization AND trick):

        1: X    = OR(A, B)
        2: X   &= NAND(A, B)          # no-init -> X = A xor B  (=h)
        3: Y    = NAND(A, B)
        4: Y   &= NAND(Cin, X)        # no-init -> Y = Cout'
           (Cout = A.B + Cin.h  =>  Cout' = NAND(A,B) . NAND(Cin,h))
        5: cout = NOT(Y)
        6: Z    = OR(X, Cin)
        7: Z   &= NAND(X, Cin)        # no-init -> Z = S = h xor Cin

    The one-cycle gap vs the cited count is disclosed in EXPERIMENTS.md;
    every comparison table reports both "cited" and "measured" columns.
    """
    lay = Layout()
    p = lay.new_partition()
    a = lay.add_cell(p, "a")
    b = lay.add_cell(p, "b")
    cin = lay.add_cell(p, "cin")
    x = lay.add_cell(p, "x")
    y = lay.add_cell(p, "y")
    z = lay.add_cell(p, "z")
    cout = lay.add_cell(p, "cout")

    pb = ProgramBuilder(lay, name="felix_fa")
    pb.declare_input("a", [a])
    pb.declare_input("b", [b])
    pb.declare_input("cin", [cin])
    pb.init([x, y, z, cout], note="init")
    pb.cycle([Op(Gate.OR, (a, b), x)], note="or")
    pb.cycle([Op(Gate.NAND, (a, b), x)], note="h (no-init AND)")
    pb.cycle([Op(Gate.NAND, (a, b), y)], note="nand")
    pb.cycle([Op(Gate.NAND, (cin, x), y)], note="cout' (no-init AND)")
    pb.cycle([Op(Gate.NOT, (y,), cout)], note="cout")
    pb.cycle([Op(Gate.OR, (x, cin), z)], note="or2")
    pb.cycle([Op(Gate.NAND, (x, cin), z)], note="S (no-init AND)")
    pb.declare_output("s", [z])
    pb.declare_output("cout", [cout])
    return pb.build()


def ripple_adder(n_bits: int, gate_set: str = "multpim") -> Program:
    """N-bit ripple-carry adder, single row (no partitions needed).

    ``multpim``: 5 cycles/bit (1 batched init + 4 compute, carry
    complement chained for free) -> 5N total, 3N+5 memristors.
    ``felix``: 7 cycles/bit -> 7N total (prior art, for the comparison
    benchmark).
    """
    lay = Layout()
    p = lay.new_partition()
    a = [lay.add_cell(p, f"a{i}") for i in range(n_bits)]
    b = [lay.add_cell(p, f"b{i}") for i in range(n_bits)]
    s = [lay.add_cell(p, f"s{i}") for i in range(n_bits)]
    # 5 rotating work cells: two (carry, carry') pairs + one t2.
    cA = lay.add_cell(p, "cA")
    cAn = lay.add_cell(p, "cAn")
    cB = lay.add_cell(p, "cB")
    cBn = lay.add_cell(p, "cBn")
    t2 = lay.add_cell(p, "t2")

    pb = ProgramBuilder(lay, name=f"ripple_adder_{gate_set}_{n_bits}")
    pb.declare_input("a", a)
    pb.declare_input("b", b)

    pairs = [(cA, cAn), (cB, cBn)]
    if gate_set == "multpim":
        # Bit 0 is a half adder: u = NOR(a,b) = Min3(a,b,<SET cell>),
        # C1' = Min3(a,b,u), C1 = NOT(C1'), S0 = NOR(C1,u) = Min3(C1,u,<SET>).
        # 1 init + 4 compute = 5 cycles; bits 1..N-1 chain the carry
        # complement for free (4-cycle FA) -> exactly 5N cycles total and
        # 3N+5 memristors (cA/cAn/cB/cBn/t2 are the 5 work cells).
        u, one = cA, cAn       # bit-0 roles for the A-pair
        c1, c1n = cB, cBn
        pb.init([cA, cAn, cB, cBn, s[0]], note="init0")
        pb.cycle([Op(Gate.MIN3, (a[0], b[0], one), u)], note="u=NOR(a0,b0)")
        pb.cycle([Op(Gate.MIN3, (a[0], b[0], u), c1n)], note="c1'")
        pb.cycle([Op(Gate.NOT, (c1n,), c1)], note="c1")
        pb.cycle([Op(Gate.MIN3, (c1, u, one), s[0])], note="s0=NOR(c1,u)")
        for i in range(1, n_bits):
            c_in, c_in_n = pairs[i % 2]
            c_out, c_out_n = pairs[(i + 1) % 2]
            pb.init([c_out, c_out_n, t2, s[i]], note=f"init{i}")
            for op in multpim_fa_ops(a[i], b[i], c_in, c_in_n,
                                     t2, c_out_n, c_out, s[i], note=f"fa{i}"):
                pb.cycle([op], note=op.note)
    elif gate_set == "felix":
        # Prior art (cited 7N; measured 8N with our verifiable 7-cycle FA
        # + 1 init/bit; both reported in the benchmark).
        for i in range(n_bits):
            c_in = pairs[i % 2][0]
            c_out = pairs[(i + 1) % 2][0]
            x, y = cAn if i % 2 == 0 else cBn, t2  # rotating scratch
            pb.init([x, y, c_out, s[i]] + ([cA] if i == 0 else []),
                    note=f"init{i}")
            if i == 0:
                # c0 = 0: NOT of a freshly-SET cell.
                pb.cycle([Op(Gate.NOT, (x,), cA)], note="c0=0")
            pb.cycle([Op(Gate.OR, (a[i], b[i]), x)], note="or")
            pb.cycle([Op(Gate.NAND, (a[i], b[i]), x)], note="h")
            pb.cycle([Op(Gate.NAND, (a[i], b[i]), y)], note="nand")
            pb.cycle([Op(Gate.NAND, (c_in, x), y)], note="cout'")
            pb.cycle([Op(Gate.NOT, (y,), c_out)], note="cout")
            pb.cycle([Op(Gate.OR, (x, c_in), s[i])], note="or2")
            pb.cycle([Op(Gate.NAND, (x, c_in), s[i])], note="S")
    else:
        raise ValueError(gate_set)

    pb.declare_output("s", s)
    pb.declare_output("cout", [pairs[n_bits % 2][0]])
    return pb.build()
