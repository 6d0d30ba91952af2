"""Fault injection into the packed executors — the one shared path.

Every backend that injects faults routes through
:func:`pass_fault_tensors`: it allocates the pass index (monotone per
model), builds the dense per-pass flip table in that backend's word
size, and fetches the epoch's stuck-at masks. Because the flip sites
are drawn in word-size-independent ``(cycle, op-slot, row)`` space and
the stuck maps in ``(row, col)`` space, numpy (64-bit words) and
torch (32-bit words) inject **bit-identical** faults for the same
model state — the cross-backend determinism the test suite asserts.

The faulty cycle semantics (identical in
:func:`numpy_kernel_packed_faulty` here and the torch scan in
:func:`repro_torch.kernels.ref.crossbar_run_ref_packed_faulty`):

1. batched SET of the cycle's init cells (word-wide OR);
2. gather inputs, evaluate gates, XOR the cycle's flip words into the
   result (:func:`repro_torch.core.executor.gate_eval_packed` with ``flip=``);
3. AND-write the results (flips on already-zero cells are masked — the
   write could not have changed them);
4. enforce the stuck maps: ``state = (state & ~sa0) | sa1`` (also
   applied once to the loaded state, so stuck cells never present a
   clean value).

Fault injection always runs the tables cycle-at-a-time (macro fusion
is bypassed): flip draws are per *cycle* and fusing would change which
table the sites index.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.executor import PackedProgram, gate_eval_packed

from .model import FaultModel

__all__ = ["pass_fault_tensors", "apply_stuck",
           "numpy_kernel_packed_faulty"]


def pass_fault_tensors(model: FaultModel, packed: PackedProgram,
                       rows: int, word_bits: int
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(flips, sa0, sa1)`` for the next pass of ``packed`` over
    ``rows`` lanes: ``flips`` is ``(T, W, M)`` packed words, the stuck
    maps are ``(W, C)`` packed words at the full table width."""
    pass_idx = model.next_pass()
    flips = model.flip_words(pass_idx, packed.gate_id, rows, word_bits)
    sa0, sa1 = model.stuck_words(rows, packed.init_mask.shape[1],
                                 model.epoch(pass_idx), word_bits)
    return flips, sa0, sa1


def apply_stuck(st: np.ndarray, sa0: np.ndarray,
                sa1: np.ndarray) -> np.ndarray:
    """Enforce the stuck maps on a packed state."""
    return (st & ~sa0) | sa1


def numpy_kernel_packed_faulty(packed: PackedProgram, st: np.ndarray,
                               flips: np.ndarray, sa0: np.ndarray,
                               sa1: np.ndarray) -> np.ndarray:
    """The packed numpy interpreter loop with fault injection — the
    faulty twin of ``NumpyBackend._kernel_packed``. ``st`` ``(W, C)``
    words are mutated in place and returned."""
    full = ~st.dtype.type(0)
    gate_id, in_cols, out_col = (packed.gate_id, packed.in_cols,
                                 packed.out_col)
    st[...] = apply_stuck(st, sa0, sa1)
    for t in range(packed.n_cycles):
        imask = packed.init_mask[t]
        if imask.any():
            st[:, imask] = full
            st[...] = apply_stuck(st, sa0, sa1)
            continue
        gid, ics, ocs = gate_id[t], in_cols[t], out_col[t]
        res = gate_eval_packed(np, gid[None, :], st[:, ics[:, 0]],
                               st[:, ics[:, 1]], st[:, ics[:, 2]],
                               flip=flips[t])
        np.bitwise_and.at(st, (slice(None), ocs), res)
        st[...] = apply_stuck(st, sa0, sa1)
    return st
