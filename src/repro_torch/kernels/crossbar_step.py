"""Wrappers of the Hopper crossbar kernels K1 (packed) and K2 (unpacked).

``crossbar_run_packed`` runs a compiled program over bit-plane packed
``(W, C)`` int32 words (32 crossbar rows per word) and
``crossbar_run`` over unpacked ``(rows, C)`` uint8 {0,1} state. For a
CUDA tensor each launches its kernel from ``csrc/crossbar_step.cu``
(built at first use, :mod:`repro_torch.kernels._build`) on the current
stream, without synchronising, and adds one to its ``launches`` count.
For a CPU tensor each runs its plain PyTorch version
(:mod:`repro_torch.kernels.ref`) — only because the tensor lies on the
CPU; there is no fallback from the card to the host.

The kernels read their tables from the device. They are built once per
``(program, device)`` and memoized on the
:class:`~repro_torch.core.executor.PackedProgram`, as the reference
package memoizes its Pallas tables: repeated passes upload nothing.
Both kernels read one compact command stream (:func:`command_stream`,
built from :func:`encode_records`' one 64-bit record per real op, NOP
slots dropped, and the init cells) and run one engine over a tile of
bit-plane words: K1 loads the tile from packed words, K2 packs 32 rows
of bytes into each word inside the kernel and unpacks them on the way
out. Neither uses macro-cycle fusion, which would only add padding;
``macro`` matters only to the CPU twin.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.executor import PackedProgram
from repro_torch.core.isa import GATE_ARITY, Gate

from .ref import crossbar_run_ref, crossbar_run_ref_packed

__all__ = ["crossbar_run_packed", "crossbar_run", "kernel_tables",
           "KernelTables", "encode_records", "decode_records",
           "command_stream", "DEFAULT_WORD_BLOCK", "MAX_RECORD_COLS"]

# 32-row words per block, for both kernels (one lane per word, four warps
# sharing them); the kernels halve it until the block's shared memory
# fits. The tile needs (C + 2) * 4 bytes per word, so at C = 460 three
# 32-word K1 blocks share an SM.
DEFAULT_WORD_BLOCK = 32
_MAX_WORDS = 32
# A record's column fields are 12 bits, and the kernels add two constant
# columns (all zeros at C, all ones at C + 1): tables of C + 2 > 4096
# raise.
MAX_RECORD_COLS = 4096 - 2

# K1's record form of each gate: result = maj(a, b, c) ^ inv, with the
# operands named by which of (in0, in1, in2, ZERO, ONES) they take.
_IN0, _IN1, _IN2, _ZERO, _ONES = range(5)
_RECORD_FORM = {          # gate id: (a, b, c, inv)
    1: (_IN0, _IN0, _IN0, 1),     # NOT  = ~x0
    2: (_IN0, _IN1, _ONES, 1),    # NOR  = ~maj(x0, x1, 1)
    3: (_IN0, _IN1, _IN2, 1),     # MIN3 = ~maj(x0, x1, x2)
    4: (_IN0, _IN1, _ZERO, 1),    # NAND = ~maj(x0, x1, 0)
    5: (_IN0, _IN1, _ONES, 0),    # OR   = maj(x0, x1, 1)
    6: (_IN0, _IN0, _IN0, 0),     # COPY = x0
}


@dataclass(frozen=True)
class KernelTables:
    """Tables on one device, as the kernels read them.

    ``stream`` the int64 command stream both kernels read, on the
    device (see :func:`command_stream`), ``n_steps`` its steps and
    ``max_step`` the most entries of one step; ``n_records`` the real
    ops in it (see :func:`encode_records`), ``max_ops`` the most of them
    in one cycle; ``held`` when some cycle reads a column that it writes
    or writes one twice; the init cells it was built from as host CSR,
    ``init_ptr`` ``(T + 1,)`` and ``init_cols`` int32 numpy arrays."""

    init_ptr: np.ndarray
    init_cols: np.ndarray
    n_cols: int
    n_records: int
    n_init: int
    max_ops: int
    held: bool
    stream: torch.Tensor
    n_steps: int
    max_step: int


def encode_records(packed: PackedProgram) -> "tuple[np.ndarray, ...]":
    """K1's op stream of ``packed``: ``(records, op_ptr, max_ops,
    held)``.

    One int64 record per real (non-NOP) slot, in cycle and slot order.
    Bits 0-11 ``a``, 12-14 the gate id, 19 ``inv``, 20-31 ``b``, 32-43
    ``c``, 52-63 the output column; the kernel computes
    ``maj(s[a], s[b], s[c]) ^ (inv ? ~0 : 0)``, which equals the gate on
    the slot's operands (``_RECORD_FORM``; column ``C`` is all zeros and
    ``C + 1`` all ones in the kernel's tile). ``held`` is True when some
    cycle has an op that reads a column written in the same cycle, or
    two ops that write one column: the kernel must then finish the
    cycle's gathers before its writes, and AND them in turn. Raises
    ``ValueError`` when ``C + 2`` columns do not fit the 12-bit
    fields."""
    gate = np.asarray(packed.gate_id)
    ins = np.asarray(packed.in_cols).astype(np.int64)
    outc = np.asarray(packed.out_col).astype(np.int64)
    t, _ = gate.shape
    c = packed.init_mask.shape[1]
    if c > MAX_RECORD_COLS:
        raise ValueError(f"K1 records hold 12-bit columns: {c} columns "
                         f"(+2 constant) exceed {MAX_RECORD_COLS + 2}")
    real = gate != 0
    unknown = set(np.unique(gate[real]).tolist()) - set(_RECORD_FORM)
    if unknown:
        raise ValueError(f"K1 has no record form for gate ids {unknown}")
    tt, mm = np.nonzero(real)              # row-major: cycle, then slot
    g = gate[tt, mm].astype(np.int64)
    choices = np.stack([ins[tt, mm, 0], ins[tt, mm, 1], ins[tt, mm, 2],
                        np.full(g.shape, c), np.full(g.shape, c + 1)])
    form = np.array([_RECORD_FORM.get(k, (0, 0, 0, 0)) for k in range(8)],
                    np.int64)[g]
    pick = np.arange(g.size)
    a, b, cc = (choices[form[:, j], pick] for j in range(3))
    o = outc[tt, mm]
    rec = (a | (g << 12) | (form[:, 3] << 19) | (b << 20) | (cc << 32)
           | (o << 52))
    counts = real.sum(axis=1)
    ptr = np.zeros(t + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    held = False
    for k in range(t):
        sl = real[k]
        if sl.any():
            outs = outc[k, sl]
            ar = np.array([GATE_ARITY[Gate(int(x))] for x in gate[k, sl]])
            reads = ins[k, sl][np.arange(3)[None, :] < ar[:, None]]
            if np.unique(outs).size < outs.size or np.isin(reads, outs).any():
                held = True
                break
    return (rec.astype(np.uint64).view(np.int64), ptr.astype(np.int32),
            int(counts.max(initial=0)), held)



def decode_records(records: np.ndarray) -> "tuple[np.ndarray, ...]":
    """``(gate, in_cols (R, 3), out_col, inv)`` of K1 records, in the
    record form: the first ``arity`` operands of each op are the slot's
    own, the rest the form's (see :func:`encode_records`)."""
    r = np.asarray(records).view(np.uint64)
    field = np.uint64(0xFFF)
    ins = np.stack([r & field, (r >> np.uint64(20)) & field,
                    (r >> np.uint64(32)) & field], axis=1)
    return ((r >> np.uint64(12)) & np.uint64(7)).astype(np.int32), \
        ins.astype(np.int32), (r >> np.uint64(52)).astype(np.int32), \
        ((r >> np.uint64(19)) & np.uint64(1)).astype(np.int32)


_SET_FIELDS = (0, 20, 32, 52)    # bit offsets of a record's 4 columns


def command_stream(records: np.ndarray, op_ptr: np.ndarray,
                   init_ptr: np.ndarray, init_cols: np.ndarray,
                   n_cols: int) -> "tuple[np.ndarray, int, int]":
    """K1's command stream: ``(stream, n_steps, max_step)``.

    One step per cycle that has work (NOP-only cycles are dropped): a
    header holding its count of SET entries (low 32 bits) and of ops
    (high 32 bits), its SET entries, then its op records, all int64. A
    SET entry names 4 columns in the bit fields of a record's 4 columns,
    padded with the all-ones column ``C + 1`` (setting it changes
    nothing). ``max_step`` is the most entries of one step, header
    included."""
    out = []
    max_step = 0
    for t in range(op_ptr.size - 1):
        cols = init_cols[init_ptr[t]:init_ptr[t + 1]].astype(np.int64)
        ops = records[op_ptr[t]:op_ptr[t + 1]]
        if cols.size == 0 and ops.size == 0:
            continue
        n_set = -(-cols.size // 4)
        sets = np.full(n_set * 4, n_cols + 1, np.int64)
        sets[:cols.size] = cols
        sets = sets.reshape(n_set, 4)
        entries = np.zeros(n_set, np.int64)
        for j, f in enumerate(_SET_FIELDS):
            entries |= sets[:, j] << np.int64(f)
        head = np.int64(n_set) | (np.int64(ops.size) << np.int64(32))
        out.append(np.concatenate([[head], entries, ops]).astype(np.int64))
        max_step = max(max_step, out[-1].size)
    stream = np.concatenate(out) if out else np.zeros(1, np.int64)
    return stream, len(out), max_step


def kernel_tables(packed: PackedProgram, device) -> KernelTables:
    """The kernels' tables for ``packed`` on ``device``, memoized on the
    packed program per device. Raises ``ValueError`` (from
    :func:`encode_records`) for tables too wide for the records."""
    device = torch.device(device)
    cache = getattr(packed, "_torch_kernel_tables", None)
    if cache is None:
        cache = {}
        packed._torch_kernel_tables = cache
    tabs = cache.get(str(device))
    if tabs is None:
        t = packed.gate_id.shape[0]
        ptr = np.zeros(t + 1, np.int32)
        np.cumsum(packed.init_mask.sum(axis=1), out=ptr[1:])
        cols = np.nonzero(packed.init_mask)[1].astype(np.int32)
        c = packed.init_mask.shape[1]
        records, op_ptr, max_ops, held = encode_records(packed)
        stream, n_steps, max_step = command_stream(records, op_ptr, ptr,
                                                   cols, c)

        tabs = KernelTables(
            init_ptr=ptr, init_cols=cols, n_cols=c,
            n_records=int(records.size), n_init=int(cols.size),
            max_ops=max_ops, held=held,
            stream=torch.as_tensor(stream, device=device),
            n_steps=n_steps, max_step=max_step)
        cache[str(device)] = tabs
    return tabs


def _check(state: torch.Tensor, dtype: torch.dtype, n_cols: int,
           what: str) -> None:
    if state.dtype != dtype or state.dim() != 2 or state.shape[1] != n_cols:
        raise ValueError(f"{what}: state must be (n, {n_cols}) {dtype}, "
                         f"got {tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous():
        raise ValueError(f"{what}: state must be contiguous")
    if state.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {state.device}")


def _call(entry: str, state: torch.Tensor, *args) -> torch.Tensor:
    """Launch ``entry`` on ``state``'s device and stream with ``(state,
    out, rows, cols, *args, stream)``; returns ``out``. Tensors in
    ``args`` go as device pointers, ints as ints."""
    from ._build import load_library
    if state.numel() >= 2 ** 31:
        raise ValueError("state too large for 32-bit indexing")
    lib = load_library()
    ptr = ctypes.c_void_p
    with torch.cuda.device(state.device):
        out = torch.empty_like(state)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        err = getattr(lib, entry)(
            ptr(state.data_ptr()), ptr(out.data_ptr()),
            state.shape[0], state.shape[1],
            *[ptr(a.data_ptr()) if isinstance(a, torch.Tensor) else a
              for a in args], ptr(stream))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def _run(entry: str, state: torch.Tensor, packed: PackedProgram,
         words: int) -> torch.Tensor:
    """Launch ``entry`` (K1 or K2) over ``state`` with ``packed``'s
    command stream and ``words`` 32-row words per block (at most 32; the
    kernel halves it until the block's shared memory fits). Raises
    ``ValueError`` before any launch for tables too wide for the
    records."""
    tabs = kernel_tables(packed, state.device)
    return _call(entry, state, tabs.stream, tabs.stream.numel(),
                 tabs.n_steps, tabs.max_step, int(tabs.held), tabs.max_ops,
                 max(1, min(words, _MAX_WORDS)))


def crossbar_run_packed(state_words: torch.Tensor, packed: PackedProgram,
                        *, macro: int = 1,
                        word_block: Optional[int] = None) -> torch.Tensor:
    """K1: run ``packed`` over ``(W, C)`` int32 words at the table
    width ``C``; returns the final words as a new tensor. ``macro`` is
    the CPU twin's macro-cycle fusion factor (the result does not
    depend on it, and the kernel does not use it); ``word_block`` the
    words per CUDA block (default and most 32), which the kernel halves
    until the block's shared memory fits."""
    c = packed.init_mask.shape[1]
    _check(state_words, torch.int32, c, "crossbar_run_packed")
    if state_words.device.type == "cpu":
        return crossbar_run_ref_packed(state_words, packed, macro)
    out = _run("k1_packed", state_words, packed,
               int(word_block or DEFAULT_WORD_BLOCK))
    crossbar_run_packed.launches += 1
    return out


def crossbar_run(state_bits: torch.Tensor, packed: PackedProgram, *,
                 word_block: Optional[int] = None) -> torch.Tensor:
    """K2: run ``packed`` over ``(rows, C)`` uint8 {0,1} state at the
    table width ``C``; returns the final state as a new uint8 tensor.
    ``word_block`` is the 32-row words per CUDA block, as for
    :func:`crossbar_run_packed`. The kernel copies the state in 16-byte
    pieces: a state that does not start on a 16-byte boundary (a view at
    an offset) is copied to one that does first."""
    c = packed.init_mask.shape[1]
    _check(state_bits, torch.uint8, c, "crossbar_run")
    if state_bits.device.type == "cpu":
        return crossbar_run_ref(state_bits, packed)
    if state_bits.data_ptr() % 16:
        state_bits = state_bits.clone()
    out = _run("k2_unpacked", state_bits, packed,
               int(word_block or DEFAULT_WORD_BLOCK))
    crossbar_run.launches += 1
    return out


crossbar_run_packed.launches = 0
crossbar_run.launches = 0
