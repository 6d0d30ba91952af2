"""Carry compiled tables, packed state, quantized operands, model
parameters and decode states across packages.

This system has no trained weights: what crosses between the JAX
reference package and the port is the compiled program tables, the
bit-plane packed crossbar state, the quantized operands of the PIM
linear layers, and the model zoo's (seeded, random) parameter and decode
state trees. All cross as plain numpy arrays, so nothing here imports
the reference package or JAX.

* :func:`packed_from_arrays` rebuilds a
  :class:`~repro_torch.core.executor.PackedProgram` from the four dense
  tables of any compiled program (for example another package's).
* :func:`words_to_torch` / :func:`words_to_numpy` move packed words
  between ``np.uint32`` and the port's int32 tensors, bitcasting at the
  numpy boundary (torch on the CPU has no ``~`` or ``<<`` for uint32).
* :func:`qtensor_from_arrays` builds a
  :class:`~repro_torch.pim.quant.QTensor` from another package's
  quantized ``q`` and ``scale``.
* :func:`params_from_numpy` / :func:`decode_state_from_numpy` turn a
  model's parameter or decode-state tree, as numpy leaves (for the
  reference, ``jax.tree.map(np.asarray, tree)``), into the port's tree
  of tensors on a device, with the same nesting of dicts and lists.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.executor import PackedProgram
from repro_torch.pim.quant import QTensor

__all__ = ["packed_from_arrays", "words_to_torch", "words_to_numpy",
           "qtensor_from_arrays", "params_from_numpy",
           "decode_state_from_numpy"]


def packed_from_arrays(gate_id, in_cols, out_col,
                       init_mask) -> PackedProgram:
    """A :class:`PackedProgram` from its dense tables: ``gate_id``
    ``(T, M)``, ``in_cols`` ``(T, M, 3)``, ``out_col`` ``(T, M)`` and
    ``init_mask`` ``(T, C)``. Column ``C - 1`` is the scratch column, as
    :func:`~repro_torch.core.executor.pack_program` lays it out."""
    gate_id = np.asarray(gate_id, dtype=np.int32)
    in_cols = np.asarray(in_cols, dtype=np.int32)
    out_col = np.asarray(out_col, dtype=np.int32)
    init_mask = np.asarray(init_mask, dtype=bool)
    t, m = gate_id.shape
    if (in_cols.shape != (t, m, 3) or out_col.shape != (t, m)
            or init_mask.ndim != 2 or init_mask.shape[0] != t):
        raise ValueError(
            f"inconsistent tables: gate_id {gate_id.shape}, in_cols "
            f"{in_cols.shape}, out_col {out_col.shape}, init_mask "
            f"{init_mask.shape}")
    c = init_mask.shape[1]
    return PackedProgram(gate_id.copy(), in_cols.copy(), out_col.copy(),
                         init_mask.copy(), n_cols=c - 1, scratch_col=c - 1)


def words_to_torch(words: np.ndarray, device="cpu") -> torch.Tensor:
    """``np.uint32`` packed words -> an int32 tensor on ``device`` with
    the same bits."""
    words = np.asarray(words)
    if words.dtype != np.uint32:
        raise TypeError(f"expected uint32 words, got {words.dtype}")
    return torch.from_numpy(
        np.ascontiguousarray(words).view(np.int32)).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """An int32 tensor of packed words -> ``np.uint32`` on the host with
    the same bits."""
    if words.dtype != torch.int32:
        raise TypeError(f"expected int32 words, got {words.dtype}")
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def qtensor_from_arrays(q, scale, n_bits: int, zero: int) -> QTensor:
    """A :class:`~repro_torch.pim.quant.QTensor` on the CPU from
    quantized values ``q`` (integers in ``[0, 2^n_bits)``, as int32) and
    their float32 ``scale`` (scalar or per channel)."""
    q = np.asarray(q)
    if q.size and (q.min() < 0 or q.max() >= 2 ** n_bits):
        raise ValueError(f"q outside [0, 2^{n_bits})")
    return QTensor(torch.from_numpy(q.astype(np.int32)),
                   torch.from_numpy(np.array(scale, np.float32)),
                   int(n_bits), int(zero))



def params_from_numpy(tree, device="cpu"):
    """A model parameter tree with numpy leaves (nested dicts and lists,
    as the reference keeps it) -> the port's tree of tensors on
    ``device``, dtypes kept (the reference's float32 parameters stay
    float32)."""
    from repro_torch.tree import tree_map
    # np.array copies: a read-only buffer (a JAX array's view) cannot
    # back a tensor.
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                    tree)


def decode_state_from_numpy(tree, device="cpu"):
    """A decode-state tree with numpy leaves -> the port's, on
    ``device``: every cache's ``k``/``v``/``length`` (int32; the
    reference keeps a cache as the dict of its fields) and every
    recurrent state as tensors, ``None`` entries (``scan`` without units,
    ``enc_out`` outside enc-dec) kept."""
    return params_from_numpy(tree, device)
