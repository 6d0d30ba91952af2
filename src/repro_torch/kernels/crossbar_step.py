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
The kernels take the unfused ``(T, M)`` tables: they skip NOP slots, so
macro-cycle fusion would only add padding; ``macro`` matters only to
the CPU twin.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.executor import PackedProgram

from .ref import crossbar_run_ref, crossbar_run_ref_packed

__all__ = ["crossbar_run_packed", "crossbar_run", "kernel_tables",
           "KernelTables", "block_size", "MAX_SMEM_BYTES",
           "DEFAULT_WORD_BLOCK", "DEFAULT_ROW_BLOCK"]

# Dynamic shared memory one block may use on the H100 (227 KB).
MAX_SMEM_BYTES = 232448
# Words per block for K1 (one thread per word) and rows per block for
# K2 (one thread per row). K1 needs C * 4 bytes of shared memory per
# word, so at C = 460 one 32-word warp per block lets 3 blocks share an
# SM; K2 needs C bytes per row.
DEFAULT_WORD_BLOCK = 32
DEFAULT_ROW_BLOCK = 128
_MAX_THREADS = 256
_MAX_OPS = 128


@dataclass(frozen=True)
class KernelTables:
    """Slot tables on one device, as the kernels read them:
    ``gate``/``in0``/``in1``/``in2``/``out`` ``(T, M)`` int32, and the
    init cells as CSR (``init_ptr`` ``(T + 1,)``, ``init_cols``) int32."""

    gate: torch.Tensor
    in0: torch.Tensor
    in1: torch.Tensor
    in2: torch.Tensor
    out: torch.Tensor
    init_ptr: torch.Tensor
    init_cols: torch.Tensor
    n_slots: int
    m_ops: int
    n_cols: int


def kernel_tables(packed: PackedProgram, device) -> KernelTables:
    """The kernels' tables for ``packed`` on ``device``, memoized on the
    packed program per device."""
    device = torch.device(device)
    cache = getattr(packed, "_torch_kernel_tables", None)
    if cache is None:
        cache = {}
        packed._torch_kernel_tables = cache
    tabs = cache.get(str(device))
    if tabs is None:
        t, m = packed.gate_id.shape
        ptr = np.zeros(t + 1, np.int32)
        np.cumsum(packed.init_mask.sum(axis=1), out=ptr[1:])
        cols = np.nonzero(packed.init_mask)[1].astype(np.int32)

        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                                   device=device)

        tabs = KernelTables(
            gate=up(packed.gate_id),
            in0=up(packed.in_cols[:, :, 0]), in1=up(packed.in_cols[:, :, 1]),
            in2=up(packed.in_cols[:, :, 2]),
            out=up(packed.out_col),
            init_ptr=up(ptr), init_cols=up(cols if cols.size else [0]),
            n_slots=t, m_ops=m, n_cols=packed.init_mask.shape[1])
        cache[str(device)] = tabs
    return tabs


def block_size(requested: Optional[int], n_cols: int, cell_bytes: int,
               default: int) -> int:
    """Threads (words or rows) per block: ``requested`` (or
    ``default``), capped at 256 and halved until the ``[C][B+1]``
    shared-memory tile fits in 227 KB."""
    b = max(1, min(int(requested or default), _MAX_THREADS))
    while b > 1 and n_cols * (b + 1) * cell_bytes > MAX_SMEM_BYTES:
        b //= 2
    if n_cols * (b + 1) * cell_bytes > MAX_SMEM_BYTES:
        raise ValueError(f"{n_cols} columns do not fit in shared memory")
    return b


def _check(state: torch.Tensor, dtype: torch.dtype, n_cols: int,
           what: str) -> None:
    if state.dtype != dtype or state.dim() != 2 or state.shape[1] != n_cols:
        raise ValueError(f"{what}: state must be (n, {n_cols}) {dtype}, "
                         f"got {tuple(state.shape)} {state.dtype}")
    if not state.is_contiguous():
        raise ValueError(f"{what}: state must be contiguous")
    if state.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{what}: unsupported device {state.device}")


def _launch(entry: str, state: torch.Tensor, tabs: KernelTables,
            block: int) -> torch.Tensor:
    from ._build import load_library
    if tabs.m_ops > _MAX_OPS:
        raise ValueError(f"{tabs.m_ops} ops per cycle exceed the kernel's "
                         f"{_MAX_OPS}")
    if state.numel() >= 2 ** 31:
        raise ValueError("state too large for 32-bit indexing")
    lib = load_library()
    with torch.cuda.device(state.device):
        out = torch.empty_like(state)
        stream = torch.cuda.current_stream(state.device).cuda_stream
        ptr = ctypes.c_void_p
        err = getattr(lib, entry)(
            ptr(state.data_ptr()), ptr(out.data_ptr()),
            state.shape[0], state.shape[1],
            ptr(tabs.gate.data_ptr()), ptr(tabs.in0.data_ptr()),
            ptr(tabs.in1.data_ptr()), ptr(tabs.in2.data_ptr()),
            ptr(tabs.out.data_ptr()), ptr(tabs.init_ptr.data_ptr()),
            ptr(tabs.init_cols.data_ptr()),
            tabs.n_slots, tabs.m_ops, block, ptr(stream))
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return out


def crossbar_run_packed(state_words: torch.Tensor, packed: PackedProgram,
                        *, macro: int = 1,
                        word_block: Optional[int] = None) -> torch.Tensor:
    """K1: run ``packed`` over ``(W, C)`` int32 words at the table
    width ``C``; returns the final words as a new tensor. ``macro`` is
    the CPU twin's macro-cycle fusion factor (the result does not
    depend on it, and the kernel does not use it); ``word_block`` the
    words per CUDA block (default 32)."""
    c = packed.init_mask.shape[1]
    _check(state_words, torch.int32, c, "crossbar_run_packed")
    if state_words.device.type == "cpu":
        return crossbar_run_ref_packed(state_words, packed, macro)
    tabs = kernel_tables(packed, state_words.device)
    block = block_size(word_block, c, 4, DEFAULT_WORD_BLOCK)
    out = _launch("k1_packed", state_words, tabs, block)
    crossbar_run_packed.launches += 1
    return out


def crossbar_run(state_bits: torch.Tensor, packed: PackedProgram, *,
                 row_block: Optional[int] = None) -> torch.Tensor:
    """K2: run ``packed`` over ``(rows, C)`` uint8 {0,1} state at the
    table width ``C``; returns the final state as a new uint8 tensor.
    ``row_block`` is the rows per CUDA block (default 128)."""
    c = packed.init_mask.shape[1]
    _check(state_bits, torch.uint8, c, "crossbar_run")
    if state_bits.device.type == "cpu":
        return crossbar_run_ref(state_bits, packed)
    tabs = kernel_tables(packed, state_bits.device)
    block = block_size(row_block, c, 1, DEFAULT_ROW_BLOCK)
    out = _launch("k2_unpacked", state_bits, tabs, block)
    crossbar_run.launches += 1
    return out


crossbar_run_packed.launches = 0
crossbar_run.launches = 0
