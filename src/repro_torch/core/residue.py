"""In-crossbar residue-check programs (the detection half of
:mod:`repro_torch.faults`).

:func:`residue_program` reads the same carry-save state a drain reads
(``s_hi``, ``c_hi``, ``lo`` — the MAC pass outputs) and computes the
accumulated value's residues modulo 3 and modulo 7 in spare columns:

* the value is ``v = lo + (((s_hi + c_hi) mod 2^n) << n)`` — one N-bit
  ripple over the carry-save upper halves (the same Section IV-B1 adder
  ``recomb`` uses) recovers its bit planes;
* ``v mod (2^k - 1)`` folds out of the bits digit-serially: group the
  2N value bits into base-``2^k`` digits and accumulate them through a
  k-bit **end-around-carry** adder chain (the carry out of bit k-1
  feeds back into bit 0 — valid because ``2^k === 1 (mod 2^k - 1)``).
  ``k=2`` gives mod 3, ``k=3`` gives mod 7.

The result is *non-canonical* one's-complement style: ``2^k - 1`` is an
alternate representation of 0 (``r3`` may read 3, ``r7`` may read 7).
The host reduces before comparing (:func:`repro_torch.faults.decode_residues`).

A corrupted accumulator escapes both residues with probability 1/21; the
resident executor combines this with an exact host-boundary check on the
drained token itself, so the residue pair is the *device-side* tripwire
that catches corruption at every drain without trusting the drain path.

Registered in the compiler cache as ``"residue"``, so it is optimized,
differentially verified, disk-spilled, and cycle-accounted like every
other program family.
"""
from __future__ import annotations

from typing import List

from .adders import multpim_fa_ops
from .isa import Gate, Op
from .program import Layout, Program, ProgramBuilder

__all__ = ["residue_program", "RESIDUE_MODULI"]

# The compiled check pair: (output name, modulus bit width k); the
# modulus itself is 2^k - 1.
RESIDUE_MODULI = (("r3", 2), ("r7", 3))


def _half_add(pb: ProgramBuilder, lay: Layout, p: int, a: int, b: int,
              one: int, tag: str) -> "tuple[int, int, int]":
    """MultPIM-style half adder: returns ``(sum, carry, carry_n)`` cells
    (4 fresh cells, 1 init + 4 compute cycles)."""
    u = lay.add_cell(p, f"{tag}_u")
    cn = lay.add_cell(p, f"{tag}_cn")
    c = lay.add_cell(p, f"{tag}_c")
    s = lay.add_cell(p, f"{tag}_s")
    pb.init([u, cn, c, s], note=f"{tag}:init")
    pb.cycle([Op(Gate.MIN3, (a, b, one), u)], note=f"{tag}:u")
    pb.cycle([Op(Gate.MIN3, (a, b, u), cn)], note=f"{tag}:c'")
    pb.cycle([Op(Gate.NOT, (cn,), c)], note=f"{tag}:c")
    pb.cycle([Op(Gate.MIN3, (c, u, one), s)], note=f"{tag}:s")
    return s, c, cn


def _full_add(pb: ProgramBuilder, lay: Layout, p: int, a: int, b: int,
              cin: int, cin_n: int, tag: str) -> "tuple[int, int, int]":
    """4-cycle MultPIM FA (carry complement pre-stored): returns
    ``(sum, carry, carry_n)`` cells."""
    t2 = lay.add_cell(p, f"{tag}_t2")
    cn = lay.add_cell(p, f"{tag}_cn")
    c = lay.add_cell(p, f"{tag}_c")
    s = lay.add_cell(p, f"{tag}_s")
    pb.init([t2, cn, c, s], note=f"{tag}:init")
    for op in multpim_fa_ops(a, b, cin, cin_n, t2, cn, c, s, note=tag):
        pb.cycle([op], note=op.note)
    return s, c, cn


def _xor(pb: ProgramBuilder, lay: Layout, p: int, a: int, b: int,
         tag: str) -> int:
    """No-init-AND XOR: ``OR(a,b)`` then ``NAND(a,b)`` AND-written into
    one fresh cell (FELIX's trick; 1 init + 2 compute cycles)."""
    x = lay.add_cell(p, f"{tag}_x")
    pb.init([x], note=f"{tag}:init")
    pb.cycle([Op(Gate.OR, (a, b), x)], note=f"{tag}:or")
    pb.cycle([Op(Gate.NAND, (a, b), x)], note=f"{tag}:nand")
    return x


def _eac_add(pb: ProgramBuilder, lay: Layout, p: int, k: int,
             acc: List[int], dig: List[int], one: int,
             tag: str) -> List[int]:
    """One end-around-carry step of the mod-``2^k - 1`` fold:
    ``acc + dig``, carry out of bit k-1 folded back into bit 0.
    Both operands are < 2^k, so the fold never re-carries out of bit
    k-1 (``acc + dig <= 2^(k+1) - 2`` pins the folded sum below
    ``2^k``); the last bit is therefore a plain XOR."""
    # Plain k-bit add: HA on bit 0, FAs above.
    s0, c, cn = _half_add(pb, lay, p, acc[0], dig[0], one, f"{tag}a0")
    s = [s0]
    for j in range(1, k):
        sj, c, cn = _full_add(pb, lay, p, acc[j], dig[j], c, cn,
                              f"{tag}a{j}")
        s.append(sj)
    # End-around: fold the carry back into bit 0 and ripple it up.
    t0, e, en = _half_add(pb, lay, p, s[0], c, one, f"{tag}e0")
    out = [t0]
    for j in range(1, k - 1):
        tj, e, en = _half_add(pb, lay, p, s[j], e, one, f"{tag}e{j}")
        out.append(tj)
    out.append(_xor(pb, lay, p, s[k - 1], e, f"{tag}e{k - 1}"))
    return out


def _fold_mod(pb: ProgramBuilder, lay: Layout, p: int, k: int,
              vbits: List[int], zero: int, one: int,
              tag: str) -> List[int]:
    """Digit-serial fold of ``vbits`` (LE) mod ``2^k - 1``: chunk into
    base-``2^k`` digits (zero-padded tail) and EAC-accumulate. The
    first digit's cells seed the accumulator directly — digits are only
    ever read."""
    digits = []
    for i in range(0, len(vbits), k):
        chunk = vbits[i:i + k]
        digits.append(chunk + [zero] * (k - len(chunk)))
    acc = digits[0]
    for i, dig in enumerate(digits[1:], start=1):
        acc = _eac_add(pb, lay, p, k, acc, dig, one, f"{tag}d{i}")
    return acc


def residue_program(n: int) -> Program:
    """Drain-time residue check: ``(s_hi, c_hi, lo) -> (r3, r7)``.

    Reads the carry-save state a MAC pass leaves (same inputs as
    ``recomb``), recovers the value's 2N bit planes with one N-bit
    ripple, and folds them mod 3 (2-bit output ``r3``) and mod 7
    (3-bit output ``r7``) — both non-canonical (``2^k - 1 === 0``), see
    the module doc. Single partition, one op per cycle; the pass
    pipeline packs and verifies it like any other program.
    """
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    p = lay.new_partition()
    sh = [lay.add_cell(p, f"sh{j}") for j in range(n)]
    ch = [lay.add_cell(p, f"ch{j}") for j in range(n)]
    lo = [lay.add_cell(p, f"lo{j}") for j in range(n)]
    s = [lay.add_cell(p, f"s{j}") for j in range(n)]
    coutn = [lay.add_cell(p, f"cn{j}") for j in range(n)]
    cout = [lay.add_cell(p, f"c{j}") for j in range(n)]
    t2 = [lay.add_cell(p, f"t2_{j}") if j else -1 for j in range(n)]
    one = lay.add_cell(p, "one")
    u0 = lay.add_cell(p, "u0")
    zero = lay.add_cell(p, "zero")

    pb = ProgramBuilder(lay, name=f"residue_{n}")
    pb.declare_input("s_hi", sh)
    pb.declare_input("c_hi", ch)
    pb.declare_input("lo", lo)
    pb.init(s + coutn + cout + t2[1:] + [one, u0, zero], note="init")
    # zero = NOT(SET cell): the constant-0 pad for ragged digits.
    pb.cycle([Op(Gate.NOT, (one,), zero)], note="zero")

    # s = (s_hi + c_hi) mod 2^n — the same ripple recomb runs.
    from .staging import _ripple_un
    _ripple_un(pb, n, sh, ch, s, coutn, cout, t2, one, u0, None, [], "fa")

    vbits = lo + s                     # the 2N-bit value, little-endian
    r3 = _fold_mod(pb, lay, p, 2, vbits, zero, one, "m3")
    r7 = _fold_mod(pb, lay, p, 3, vbits, zero, one, "m7")
    pb.declare_output("r3", r3)
    pb.declare_output("r7", r7)
    return pb.build()
