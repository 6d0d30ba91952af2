"""Program executors: the numpy reference and the packed program tables.

Crossbar state is a ``(rows, cols)`` tensor of {0,1}. Rows are the free
SIMD axis of stateful logic: the same single-row program executes on every
row simultaneously (this is exactly how the paper batches element-wise
vector multiplication, Section II-A), so `rows` is our batch dimension.

Write semantics are faithful to MAGIC/X-MAGIC: a compute gate can only
pull its output cell toward 0, i.e. ``new = old AND gate(inputs)``; INIT
SETs cells to 1. No-init AND (MultPIM optimization IV-B2) falls out for
free.

:func:`pack_program` turns the schedule into dense tables; the same
tables drive the PyTorch plain versions and the CUDA kernels
(:mod:`repro_torch.kernels.crossbar_step`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .isa import Gate
from .program import Program

__all__ = ["run_numpy", "PackedProgram", "pack_program",
           "gate_eval_packed"]


def gate_eval_packed(xp, gid, x0, x1, x2, flip=None):
    """Word-wide bitwise gate evaluation over bit-plane packed rows,
    shared by the numpy and jnp packed interpreters (``xp`` is the array
    namespace — ``numpy`` for the host interpreter).

    ``gid`` broadcasts against the ``(W, M)`` packed-word operands
    ``x0/x1/x2``. Every gate is a pure lanewise bitwise identity — MIN3
    (minority-of-3) is the complement of the 3-input majority
    ``(x0&x1)|(x0&x2)|(x1&x2)`` — so one expression serves all 32/64
    packed rows of a word at once. NOP (and any unknown id) yields
    all-ones, the AND-write identity.

    ``flip`` (optional packed words, same shape rules as the operands)
    XORs transient faults into the gate result *before* the AND-write —
    the :mod:`repro_torch.faults` injection point. Flips are drawn only on
    real gate slots, so NOP padding stays all-ones.
    """
    full = ~x0.dtype.type(0)
    maj = (x0 & x1) | (x0 & x2) | (x1 & x2)
    out = xp.where(gid == int(Gate.NOT), ~x0,
          xp.where(gid == int(Gate.NOR), ~(x0 | x1),
          xp.where(gid == int(Gate.MIN3), ~maj,
          xp.where(gid == int(Gate.NAND), ~(x0 & x1),
          xp.where(gid == int(Gate.OR), x0 | x1,
          xp.where(gid == int(Gate.COPY), x0, full))))))
    out = out.astype(x0.dtype)
    if flip is not None:
        out = out ^ flip.astype(x0.dtype)
    return out


# ---------------------------------------------------------------- numpy ----
def run_numpy(prog: Program, inputs: Dict[str, np.ndarray], rows: Optional[int] = None
              ) -> Dict[str, np.ndarray]:
    """Execute on numpy. ``inputs[name]`` is ``(rows, n_bits)`` {0,1}.

    Returns ``{name: (rows, n_bits) uint8}`` for each program output.
    """
    first = next(iter(inputs.values()))
    R = first.shape[0] if rows is None else rows
    state = np.zeros((R, prog.layout.n_cols), dtype=np.uint8)
    for name, cols in prog.input_map.items():
        bits = np.asarray(inputs[name], dtype=np.uint8)
        if bits.shape != (R, len(cols)):
            raise ValueError(f"input {name}: want {(R, len(cols))}, got {bits.shape}")
        state[:, cols] = bits

    for cyc in prog.cycles:
        if cyc.is_init:
            state[:, cyc.init_cells] = 1
            continue
        # Gather all inputs first (ops within a cycle are simultaneous).
        results = []
        for op in cyc.ops:
            xs = [state[:, c] for c in op.ins]
            if op.gate == Gate.NOT:
                r = 1 - xs[0]
            elif op.gate == Gate.NOR:
                r = (xs[0] | xs[1]) ^ 1
            elif op.gate == Gate.MIN3:
                r = ((xs[0] + xs[1] + xs[2]) <= 1).astype(np.uint8)
            elif op.gate == Gate.NAND:
                r = (xs[0] & xs[1]) ^ 1
            elif op.gate == Gate.OR:
                r = xs[0] | xs[1]
            elif op.gate == Gate.COPY:
                r = xs[0]
            elif op.gate == Gate.NOP:
                r = np.ones(R, dtype=np.uint8)
            else:  # pragma: no cover
                raise ValueError(op.gate)
            results.append((op.out, r.astype(np.uint8)))
        for out, r in results:
            state[:, out] &= r

    return {name: state[:, cols].copy() for name, cols in prog.output_map.items()}


# --------------------------------------------------------------- tables ----
@dataclass
class PackedProgram:
    """Dense tables for the packed executors and the CUDA kernels.

    Shapes (T = cycles, M = max ops per cycle, C = padded columns):

    * ``gate_id``  (T, M) int32 — ``Gate`` value, NOP-padded
    * ``in_cols``  (T, M, 3) int32 — input columns (unused -> scratch col)
    * ``out_col``  (T, M) int32 — output column (NOP ops -> scratch col)
    * ``init_mask`` (T, C) bool — cells SET this cycle

    Column ``C-1`` is a scratch column: NOP results (constant 1) are
    AND-written there, making padding side-effect free.
    """

    gate_id: np.ndarray
    in_cols: np.ndarray
    out_col: np.ndarray
    init_mask: np.ndarray
    n_cols: int            # real (unpadded) columns
    scratch_col: int

    @property
    def n_cycles(self) -> int:
        """Number of cycles T."""
        return self.gate_id.shape[0]

    @property
    def max_ops(self) -> int:
        """Ops per cycle M (NOP-padded)."""
        return self.gate_id.shape[1]


def pack_program(prog: Program, pad_cols_to: Optional[int] = None) -> PackedProgram:
    """Dense tables of ``prog`` (see :class:`PackedProgram`)."""
    T = prog.n_cycles
    M = max(1, max((len(c.ops) for c in prog.cycles), default=1))
    C = prog.layout.n_cols + 1  # + scratch
    if pad_cols_to is not None:
        C = max(C, pad_cols_to)
    scratch = C - 1

    gate_id = np.zeros((T, M), dtype=np.int32)
    in_cols = np.full((T, M, 3), scratch, dtype=np.int32)
    out_col = np.full((T, M), scratch, dtype=np.int32)
    init_mask = np.zeros((T, C), dtype=bool)

    for t, cyc in enumerate(prog.cycles):
        if cyc.is_init:
            init_mask[t, cyc.init_cells] = True
            continue
        for m, op in enumerate(cyc.ops):
            gate_id[t, m] = int(op.gate)
            for j, c in enumerate(op.ins):
                in_cols[t, m, j] = c
            out_col[t, m] = op.out
    return PackedProgram(gate_id, in_cols, out_col, init_mask,
                         n_cols=prog.layout.n_cols, scratch_col=scratch)
