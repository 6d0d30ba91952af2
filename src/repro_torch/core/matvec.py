"""Section VI: MultPIM optimized for matrix-vector multiplication.

The MAC primitive computes, fully in carry-save (redundant) form,

    s_o + c_o = a * b + s_i + c_i        (mod 2^(2N), no carry propagation)

by running only Initialization + the First N Stages of MultPIM with:

* sum latches pre-loaded with the *lower* N bits of ``s_i`` (partition
  ``pid`` holds bit ``N-1-pid``),
* carry latches pre-loaded with the lower N bits of ``c_i`` (same
  ``pid -> bit N-1-pid`` mapping: the carry-in of a full adder carries
  the same weight as its sum-in), complements alongside (the FA keeps
  both polarities anyway),
* the upper contributions fed one bit per stage into partition 0's sum
  slot (the paper's "feeding p_1 the upper bits of s_i and c_i"):
  ``u = (s_i >> N) + (c_i >> N)``, stored complemented so the
  feed rides the existing shift-phase-2 NOT for free. ``u < 2^N`` is the
  no-overflow precondition (guaranteed when the running inner product
  fits in 2N bits).

Outputs: ``lo`` (final product bits 0..N-1), ``s_hi``/``c_hi`` (+
complement) = the carry-save upper halves, which chain into the next
MAC. Measured cost: ``1 + N + N*(ceil(log2 N) + 7)`` cycles =
``N log2 N + 8N + 1`` — the paper's per-product figure
``N log2 N + 11N + 9`` additionally charges inter-product staging; both
are reported by the Table III benchmark.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from .isa import Gate, Op
from .multpim import _Unit, broadcast_schedule
from .program import Layout, Program, ProgramBuilder

__all__ = ["multpim_mac", "compiled_mac", "mac_run", "inner_product", "matvec",
           "mac_latency_formula", "matvec_latency_formula",
           "floatpim_matvec_latency", "matvec_area_formula",
           "floatpim_matvec_area", "STAGING_CYCLES"]


def mac_latency_formula(n: int) -> int:
    """Paper Section VI per-product cost (includes staging)."""
    return n * math.ceil(math.log2(n)) + 11 * n + 9


def matvec_latency_formula(n_elems: int, n_bits: int) -> int:
    """Paper: n*(N log2 N + 11N + 9) + 4N - 4 per output row."""
    return n_elems * mac_latency_formula(n_bits) + 4 * n_bits - 4


def floatpim_matvec_latency(n_elems: int, n_bits: int) -> int:
    """Paper: FloatPIM-style n*(13N^2 + 12N + 6)."""
    return n_elems * (13 * n_bits * n_bits + 12 * n_bits + 6)


def matvec_area_formula(m_rows: int, n_elems: int, n_bits: int) -> Tuple[int, int]:
    """Crossbar footprint (rows, cols) of the MultPIM mat-vec."""
    return (m_rows, 2 * n_elems * n_bits + 14 * n_bits + 5)


def floatpim_matvec_area(m_rows: int, n_elems: int, n_bits: int) -> Tuple[int, int]:
    """Crossbar footprint (rows, cols) of the FloatPIM mat-vec."""
    return (m_rows, 4 * n_elems * n_bits + 22 * n_bits - 5)


def STAGING_CYCLES(n: int) -> int:
    """Host-assisted inter-product staging budget we charge per MAC when
    reporting end-to-end numbers (documented in EXPERIMENTS.md):
    N serial extractions of the sum upper half, N of the carry upper
    half, a 5N-cycle in-row ripple recombination into the u-stream, N+2
    for re-loading the emitted low bits into the sum latches."""
    return 8 * n + 2


def multpim_mac(n: int) -> Program:
    """Build the fused multiply-accumulate MAC program (one product)."""
    if n < 2:
        raise ValueError("n >= 2")
    lay = Layout()
    pids = [lay.new_partition() for _ in range(n)]

    a_in = [lay.add_cell(0, f"in_a{j}") for j in range(n)]
    b_in = [lay.add_cell(0, f"in_b{j}") for j in range(n)]
    un_in = [lay.add_cell(0, f"in_un{j}") for j in range(n)]  # u', LE

    levels = broadcast_schedule(n)
    parity = {0: 0}
    for lvl in levels:
        for src, dst in lvl:
            parity[dst] = parity[src] ^ 1

    units: List[_Unit] = []
    for pid in pids:
        a = lay.add_cell(pid, "a")
        b = lay.add_cell(pid, "b") if pid != 0 else -1
        ab = lay.add_cell(pid, "ab") if parity[pid] == 1 else -1
        s = (lay.add_cell(pid, "s0"), lay.add_cell(pid, "s1"))
        c = (lay.add_cell(pid, "cA"), lay.add_cell(pid, "cB"))
        cn = (lay.add_cell(pid, "cAn"), lay.add_cell(pid, "cBn"))
        t2 = lay.add_cell(pid, "t2")
        units.append(_Unit(a, b, ab, s, c, cn, t2, -1))

    out_cols = [lay.add_cell(n - 1, f"out{j}") for j in range(n)]

    pb = ProgramBuilder(lay, name=f"multpim_mac_{n}")
    pb.declare_input("a", a_in)
    pb.declare_input("b", b_in)
    pb.declare_input("un", un_in)
    # Latch pre-loads (physically: left in place by the previous MAC).
    pb.declare_input("s_lo", [units[n - 1 - j].s[0] for j in range(n)])
    pb.declare_input("c_lo", [units[n - 1 - j].c[0] for j in range(n)])
    pb.declare_input("c_lo_n", [units[n - 1 - j].cn[0] for j in range(n)])

    # ------------------------------------------------- setup: 1 cycle ----
    work = []
    for u in units:
        work += [u.a, u.s[1], u.c[1], u.cn[1], u.t2]
        if u.b >= 0:
            work.append(u.b)
        if u.ab >= 0:
            work.append(u.ab)
    pb.init(work, note="setup:init-work")

    # ---------------------------------------------------- copy a: N ------
    for j in range(n):
        pb.cycle([Op(Gate.NOT, (a_in[n - 1 - j],), units[j].a,
                     note=f"copy a{n-1-j}")], note=f"copy:{j}")

    # ------------------------------------------- N stages (as MultPIM) ---
    for k in range(1, n + 1):
        rs, ws = (k - 1) % 2, k % 2
        rc, wc = (k - 1) % 2, k % 2
        stage = f"S{k}"

        init_cells = [out_cols[k - 1]]
        for u in units:
            init_cells += [u.cn[wc], u.c[wc], u.t2, u.s[ws]]
            if u.b >= 0:
                init_cells.append(u.b)
            if u.ab >= 0:
                init_cells.append(u.ab)
        pb.init(init_cells, note=f"{stage}:init")

        for li, lvl in enumerate(levels):
            pb.cycle([Op(Gate.NOT,
                         ((b_in[k - 1] if src == 0 else units[src].b),),
                         units[dst].b, note=f"{stage}:bcast")
                      for src, dst in lvl], note=f"{stage}:bcast{li}")

        pp_col: List[int] = []
        ops = []
        for pid, u in enumerate(units):
            land = b_in[k - 1] if pid == 0 else u.b
            if parity[pid] == 0:
                ops.append(Op(Gate.NOT, (u.a,), land, note=f"{stage}:pp"))
                pp_col.append(land)
            else:
                ops.append(Op(Gate.MIN3, (u.a, land, u.t2), u.ab,
                              note=f"{stage}:pp"))
                pp_col.append(u.ab)
        pb.cycle(ops, note=f"{stage}:pp")

        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.c[rc]), u.cn[wc])
                  for pid, u in enumerate(units)], note=f"{stage}:t1")
        pb.cycle([Op(Gate.NOT, (u.cn[wc],), u.c[wc]) for u in units],
                 note=f"{stage}:cnot")
        pb.cycle([Op(Gate.MIN3, (u.s[rs], pp_col[pid], u.cn[rc]), u.t2)
                  for pid, u in enumerate(units)], note=f"{stage}:t2")

        def sout_op(pid: int) -> Op:
            u = units[pid]
            dst = units[pid + 1].s[ws] if pid + 1 < n else out_cols[k - 1]
            return Op(Gate.MIN3, (u.c[wc], u.cn[rc], u.t2), dst,
                      note=f"{stage}:sout{pid}")

        pb.cycle([sout_op(pid) for pid in range(0, n, 2)],
                 note=f"{stage}:shift1")
        ph2 = [sout_op(pid) for pid in range(1, n, 2)]
        # Feed the u-stream: partition 0's next sum-in = u bit k-1
        # (stored complemented -> plain NOT; replaces the 0-feed).
        ph2.append(Op(Gate.NOT, (un_in[k - 1],), units[0].s[ws],
                      note=f"{stage}:feed-u"))
        pb.cycle(ph2, note=f"{stage}:shift2")

    fs = n % 2
    pb.declare_output("lo", out_cols)
    pb.declare_output("s_hi", [units[n - 1 - j].s[fs] for j in range(n)])
    pb.declare_output("c_hi", [units[n - 1 - j].c[fs] for j in range(n)])
    pb.declare_output("c_hi_n", [units[n - 1 - j].cn[fs] for j in range(n)])
    return pb.build()


# -------------------------------------------------------------------------
# Host-assisted chaining — DEPRECATION SHIMS. The execution paths below
# moved into :mod:`repro_torch.engine` (Engine.mac / Engine.inner_product /
# Engine.matvec run through the shared OpSpec-keyed program cache on a
# pluggable backend); these wrappers keep the original signatures for
# existing callers and the tier-1 tests.
# -------------------------------------------------------------------------
def mac_run(prog: Program, n: int, a, b, s_i, c_i) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Execute one MAC on (rows,) integer arrays; returns (lo, s_hi, c_hi).

    Deprecated shim: prefer ``repro_torch.engine.get_engine().mac(...)``. The
    explicitly-passed ``prog`` is honored (it may be a raw, uncompiled
    build), executed through an engine Executable.
    """
    from repro_torch.compiler.cache import CompiledEntry
    from repro_torch.engine import get_engine
    from repro_torch.engine.executable import Executable
    eng = get_engine()
    exe = Executable(CompiledEntry.adhoc(prog), eng.backend,
                     crossbar=eng.crossbar, engine=eng)
    return eng._mac_on(exe, n, a, b, s_i, c_i)


def compiled_mac(n: int) -> Program:
    """The MAC program via the shared engine: built, optimized,
    differentially verified and memoized once per ``n`` — repeated
    matvec/inner_product calls skip the rebuild entirely."""
    from repro_torch.engine import get_engine   # lazy: no core->engine import cycle
    return get_engine().compile("mac", n).program


def inner_product(a_vec, x_vec, n: int, *, use_compiler: bool = True,
                  k=None) -> Tuple[np.ndarray, int]:
    """Full-precision fixed-point inner product per crossbar row.

    Deprecated shim for ``repro_torch.engine.Engine.inner_product`` (same
    signature and numerics; see that method for the contract — ``k``
    is the co-scheduled MAC group size, default engine policy).
    """
    from repro_torch.engine import get_engine
    return get_engine().inner_product(a_vec, x_vec, n,
                                      use_compiler=use_compiler, k=k)


def matvec(A, x, n: int, *, use_compiler: bool = True,
           k=None) -> Tuple[np.ndarray, int]:
    """A (m, e) ints, x (e,) ints -> (m,) inner products.

    Deprecated shim for ``repro_torch.engine.Engine.matvec`` (each matrix row
    is an independent crossbar row, exactly the paper's Fig. 5 layout;
    ``k`` co-schedules the MAC stream — see ``Engine.inner_product``).
    """
    from repro_torch.engine import get_engine
    return get_engine().matvec(A, x, n, use_compiler=use_compiler, k=k)
