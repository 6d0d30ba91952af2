"""Plain PyTorch versions of the port's kernels (the yardsticks).

The twins of ``repro.kernels.ref``: the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernels of
:mod:`repro_torch.kernels.crossbar_step` and
:mod:`repro_torch.kernels.bitserial_matmul` against them on the card.

* :func:`crossbar_run_ref` — the per-cell scan: state is ``(rows, C)``
  uint8 {0,1}, one column per cell, one loop step per cycle.
* :func:`crossbar_run_ref_packed` — the bit-plane packed scan: rows are
  packed 32 per word (:func:`repro_torch.core.bits.pack_rows`), held as
  **int32** because torch on the CPU implements neither ``~`` nor ``<<``
  for uint32; every gate evaluates word-wide with bitwise ops, and the
  loop runs over the macro-fused tables
  (:mod:`repro_torch.compiler.macrocycle`).
* :func:`crossbar_run_ref_packed_faulty` — one pass of the packed scan
  with a fault model's masks threaded through, cycle at a time: the
  twin of the reference's ``_faulty_scan``. It is not a kernel's plain
  version but the port's fault-injecting executor on any device: the
  reference runs its jnp scan, not the Pallas kernel, under a fault
  model, and the port runs this scan, not K1.
* :func:`bitserial_matmul_ref` — the bit-plane matmul
  ``sum_j 2^j (X_j @ W)`` in float32.

Cycle rules, as in the reference's interpreter
(``repro.core.executor``): OR in the cycle's init words, gather every
operand from the pre-cycle state, evaluate, then AND every result into
its output column (MAGIC's pull-down write): two ops of one cycle that
write one column leave the AND of both. The per-cell scan reduces with
a scatter minimum; the packed scan, which has no bitwise-AND scatter,
writes a cycle's results with one index write where its real ops write
distinct columns (every compiled program; NOP slots that share the
scratch column write all-ones and do not count) and op by op in the
cycles where they do not (found once per table, see
:class:`PackedTables`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.compiler.macrocycle import fuse_macrocycles
from repro_torch.core.executor import PackedProgram
from repro_torch.core.isa import Gate

__all__ = ["crossbar_run_ref", "crossbar_run_ref_packed",
           "crossbar_run_ref_packed_faulty", "bitserial_matmul_ref",
           "packed_scan_body", "packed_device_tables", "gate_eval_packed",
           "PackedTables"]


def gate_eval_packed(gid: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                     x2: torch.Tensor) -> torch.Tensor:
    """Word-wide gate evaluation on int32 words (any id broadcasting
    against the operands). MIN3 is the complement of the 3-input
    majority; NOP (and any unknown id) yields all-ones (``-1``), the
    AND-write identity."""
    maj = (x0 & x1) | (x0 & x2) | (x1 & x2)
    out = torch.full_like(x0, -1)
    out = torch.where(gid == int(Gate.COPY), x0, out)
    out = torch.where(gid == int(Gate.OR), x0 | x1, out)
    out = torch.where(gid == int(Gate.NAND), ~(x0 & x1), out)
    out = torch.where(gid == int(Gate.MIN3), ~maj, out)
    out = torch.where(gid == int(Gate.NOR), ~(x0 | x1), out)
    return torch.where(gid == int(Gate.NOT), ~x0, out)


def _gate_eval_bits(gid: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Per-cell gate evaluation on int32 {0,1} operands."""
    s2 = x0 + x1
    s3 = s2 + x2
    out = torch.ones_like(x0)
    out = torch.where(gid == int(Gate.COPY), x0, out)
    out = torch.where(gid == int(Gate.OR), (s2 >= 1).to(x0.dtype), out)
    out = torch.where(gid == int(Gate.NAND), 1 - x0 * x1, out)
    out = torch.where(gid == int(Gate.MIN3), (s3 <= 1).to(x0.dtype), out)
    out = torch.where(gid == int(Gate.NOR), (s2 == 0).to(x0.dtype), out)
    return torch.where(gid == int(Gate.NOT), 1 - x0, out)


def crossbar_run_ref(state_bits: torch.Tensor,
                     packed: PackedProgram) -> torch.Tensor:
    """Per-cell executor: ``state_bits`` ``(rows, C)`` uint8 {0,1} at
    the table width ``C``; returns the final state, uint8, on the same
    device."""
    c = packed.init_mask.shape[1]
    if state_bits.dim() != 2 or state_bits.shape[1] != c:
        raise ValueError(f"state must be (rows, {c}), got "
                         f"{tuple(state_bits.shape)}")
    tabs = packed_device_tables(packed, 1, state_bits.device)
    st = state_bits.to(torch.uint8).clone()
    one = torch.ones((), dtype=torch.uint8, device=st.device)
    init_mask = torch.as_tensor(packed.init_mask, device=st.device)
    for t in range(packed.n_cycles):
        st = torch.where(init_mask[t][None, :], one, st)
        ics, ocs = tabs.in_cols[t, 0], tabs.out_col[t, 0]
        x0 = st[:, ics[:, 0]].to(torch.int32)
        x1 = st[:, ics[:, 1]].to(torch.int32)
        x2 = st[:, ics[:, 2]].to(torch.int32)
        res = _gate_eval_bits(tabs.gate_id[t, 0][None, :], x0, x1, x2)
        st.scatter_reduce_(1, ocs[None, :].expand(st.shape[0], -1),
                           res.to(torch.uint8), "amin", include_self=True)
    return st


@dataclass(frozen=True)
class PackedTables:
    """Macro-fused tables on one device: ``gate_id`` ``(Tm, K, M)``
    int32, ``in_cols`` ``(Tm, K, M, 3)`` and ``out_col`` ``(Tm, K, M)``
    int64 (index tensors), ``init_words`` ``(Tm, K, C)`` int32
    (all-ones where a cell is SET). ``serial`` maps each fused cycle
    ``(t, j)`` where two real ops write one column, or a real op writes
    a column that a NOP slot also names, to its real ``(slot, column)``
    pairs, which the scan AND-writes one by one."""

    gate_id: torch.Tensor
    in_cols: torch.Tensor
    out_col: torch.Tensor
    init_words: torch.Tensor
    factor: int
    serial: "dict[tuple[int, int], tuple[tuple[int, int], ...]]"


def _serial_cycles(gate_id, out_col) -> "dict":
    """The fused cycles of ``(Tm, K, M)`` tables whose real ops share an
    output column (with each other or with a NOP slot), each with its
    real ``(slot, column)`` pairs in slot order."""
    serial = {}
    for t, j in zip(*np.nonzero((gate_id != 0).any(axis=2))):
        real = gate_id[t, j] != 0
        outs = out_col[t, j]
        mine = outs[real]
        if np.unique(mine).size < mine.size or np.isin(
                mine, outs[~real]).any():
            slots = np.nonzero(real)[0]
            serial[(int(t), int(j))] = tuple(
                (int(m), int(outs[m])) for m in slots)
    return serial


def packed_device_tables(packed: PackedProgram, macro: int,
                         device) -> PackedTables:
    """The macro-fused tables as tensors on ``device``, memoized on the
    packed program per ``(factor, device)``: repeated passes of one
    program upload nothing."""
    mt = fuse_macrocycles(packed, macro)
    device = torch.device(device)
    cache = getattr(packed, "_torch_ref_tables", None)
    if cache is None:
        cache = {}
        packed._torch_ref_tables = cache
    key = (mt.factor, str(device))
    tabs = cache.get(key)
    if tabs is None:
        tabs = PackedTables(
            gate_id=torch.as_tensor(mt.gate_id, device=device),
            in_cols=torch.as_tensor(mt.in_cols, device=device).long(),
            out_col=torch.as_tensor(mt.out_col, device=device).long(),
            init_words=torch.as_tensor(mt.init_words.view("int32"),
                                       device=device),
            factor=mt.factor,
            serial=_serial_cycles(mt.gate_id, mt.out_col))
        cache[key] = tabs
    return tabs


def packed_scan_body(st: torch.Tensor, tabs: PackedTables) -> torch.Tensor:
    """The packed loop itself over ``st`` ``(W, C)`` int32 words at the
    table width; updates ``st`` in place and returns it."""
    for t in range(tabs.gate_id.shape[0]):
        for j in range(tabs.factor):
            ics, ocs = tabs.in_cols[t, j], tabs.out_col[t, j]
            st |= tabs.init_words[t, j][None, :]
            # All gathers before the write: ops in a cycle observe the
            # pre-cycle state.
            x0 = st[:, ics[:, 0]]
            x1 = st[:, ics[:, 1]]
            x2 = st[:, ics[:, 2]]
            res = gate_eval_packed(tabs.gate_id[t, j][None, :], x0, x1, x2)
            _and_write(st, tabs, t, j, ocs, res)
    return st


def _and_write(st: torch.Tensor, tabs: PackedTables, t: int, j: int,
               ocs: torch.Tensor, res: torch.Tensor) -> None:
    """AND fused cycle ``(t, j)``'s results into their output columns:
    one index write, or op by op where real ops share a column."""
    serial = tabs.serial.get((t, j))
    if serial is None:
        st[:, ocs] = st[:, ocs] & res
    else:
        for m, o in serial:
            st[:, o] &= res[:, m]


def crossbar_run_ref_packed(state_words: torch.Tensor,
                            packed: PackedProgram,
                            macro: int = 1) -> torch.Tensor:
    """Bit-plane packed executor: ``state_words`` ``(W, C)`` int32 at
    the table width ``C``; returns the final words as a new tensor on
    the same device. ``macro`` is the macro-cycle fusion factor; the
    result does not depend on it."""
    c = packed.init_mask.shape[1]
    if (state_words.dim() != 2 or state_words.shape[1] != c
            or state_words.dtype != torch.int32):
        raise ValueError(f"state must be (W, {c}) int32, got "
                         f"{tuple(state_words.shape)} {state_words.dtype}")
    crossbar_run_ref_packed.calls += 1
    tabs = packed_device_tables(packed, macro, state_words.device)
    return packed_scan_body(state_words.clone(), tabs)


crossbar_run_ref_packed.calls = 0


def crossbar_run_ref_packed_faulty(state_words: torch.Tensor,
                                   packed: PackedProgram, model,
                                   rows: int) -> torch.Tensor:
    """One *faulty* pass of ``packed`` over ``state_words`` ``(W, C)``
    int32 at the table width, ``rows`` crossbar rows packed 32 per word,
    on the state's device; returns the final words as a new tensor.

    Draws the pass's fault tensors from ``model``
    (:func:`repro_torch.faults.pass_fault_tensors`, which advances the
    model's pass counter) and runs the tables cycle at a time (flip
    sites index per-cycle tables, so macro fusion does not apply). Per
    cycle, as the reference's ``_faulty_scan`` and the numpy
    ``numpy_kernel_packed_faulty``: OR in the init words, gather, XOR
    the cycle's flip words into the gate results, AND every result into
    its column, then enforce the stuck maps ``(st & ~sa0) | sa1``, which
    also apply once to the loaded state. Cycles without a flip skip the
    XOR, and a model without stuck cells skips the stuck maps: neither
    changes a bit.
    """
    from repro_torch.faults.inject import pass_fault_tensors
    c = packed.init_mask.shape[1]
    w = -(-rows // 32)
    if (state_words.dim() != 2 or tuple(state_words.shape) != (w, c)
            or state_words.dtype != torch.int32):
        raise ValueError(f"state must be ({w}, {c}) int32, got "
                         f"{tuple(state_words.shape)} {state_words.dtype}")
    crossbar_run_ref_packed_faulty.calls += 1
    dev = state_words.device
    flips, sa0, sa1 = pass_fault_tensors(model, packed, rows, 32)
    hit = np.flatnonzero(flips.reshape(flips.shape[0], -1).any(axis=1))
    flip_at = dict(zip(hit.tolist(), torch.from_numpy(
        np.ascontiguousarray(flips[hit]).view(np.int32)).to(dev)))
    stuck = bool(sa0.any() or sa1.any())
    if stuck:
        keep = ~torch.from_numpy(sa0.view(np.int32)).to(dev)
        set1 = torch.from_numpy(sa1.view(np.int32)).to(dev)
    tabs = packed_device_tables(packed, 1, dev)
    st = state_words.clone()
    if stuck:
        st &= keep
        st |= set1
    for t in range(tabs.gate_id.shape[0]):
        ics, ocs = tabs.in_cols[t, 0], tabs.out_col[t, 0]
        st |= tabs.init_words[t, 0][None, :]
        x0 = st[:, ics[:, 0]]
        x1 = st[:, ics[:, 1]]
        x2 = st[:, ics[:, 2]]
        res = gate_eval_packed(tabs.gate_id[t, 0][None, :], x0, x1, x2)
        flip = flip_at.get(t)
        if flip is not None:
            res = res ^ flip
        _and_write(st, tabs, t, 0, ocs, res)
        if stuck:
            st &= keep
            st |= set1
    return st


crossbar_run_ref_packed_faulty.calls = 0


def bitserial_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                         n_bits: int = 8) -> torch.Tensor:
    """Bit-plane decomposition twin of K3: ``x`` (M, K) int32, ``w``
    (K, N) float32 -> float32 (M, N) ``sum_j 2^j (X_j @ W)`` over the
    ``n_bits`` low bit planes ``X_j = (x >> j) & 1`` of ``x``."""
    w = w.to(torch.float32)
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(n_bits):
        plane = ((x >> j) & 1).to(torch.float32)
        acc += (2.0 ** j) * plane @ w
    return acc
