"""Plain PyTorch versions of the crossbar kernels (the yardsticks).

The twins of ``repro.kernels.ref``: the CPU tests hold them against the
JAX package, and ``chip_smoke.py`` holds the CUDA kernels of
:mod:`repro_torch.kernels.crossbar_step` against them on the card.

* :func:`crossbar_run_ref` — the per-cell scan: state is ``(rows, C)``
  uint8 {0,1}, one column per cell, one loop step per cycle.
* :func:`crossbar_run_ref_packed` — the bit-plane packed scan: rows are
  packed 32 per word (:func:`repro_torch.core.bits.pack_rows`), held as
  **int32** because torch on the CPU implements neither ``~`` nor ``<<``
  for uint32; every gate evaluates word-wide with bitwise ops, and the
  loop runs over the macro-fused tables
  (:mod:`repro_torch.compiler.macrocycle`).

Cycle rules, as in the reference: OR in the cycle's init words, gather
every operand from the pre-cycle state, evaluate, then AND-write. Only
the scratch column ever receives duplicate writes (NOP padding, whose
all-ones results leave it unchanged), so an index write of
``old & res`` is exact.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.compiler.macrocycle import fuse_macrocycles
from repro_torch.core.executor import PackedProgram
from repro_torch.core.isa import Gate

__all__ = ["crossbar_run_ref", "crossbar_run_ref_packed",
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
        st[:, ocs] = torch.minimum(st[:, ocs], res.to(torch.uint8))
    return st


@dataclass(frozen=True)
class PackedTables:
    """Macro-fused tables on one device: ``gate_id`` ``(Tm, K, M)``
    int32, ``in_cols`` ``(Tm, K, M, 3)`` and ``out_col`` ``(Tm, K, M)``
    int64 (index tensors), ``init_words`` ``(Tm, K, C)`` int32
    (all-ones where a cell is SET)."""

    gate_id: torch.Tensor
    in_cols: torch.Tensor
    out_col: torch.Tensor
    init_words: torch.Tensor
    factor: int


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
            factor=mt.factor)
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
            st[:, ocs] = st[:, ocs] & res
    return st


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
