"""Bit-packing helpers: integers <-> bit planes <-> row-packed words.

The PIM simulator state is a ``(rows, cols)`` tensor of {0,1}. Fixed-point
numbers live in consecutive columns, little-endian (column ``base + j``
holds bit ``j``). Two marshalling layers live here:

* **int <-> bit planes** (:func:`to_bits` / :func:`from_bits`) — host
  integers to the per-cell {0,1} planes the interpreters consume, for
  arbitrary widths (python-int fallback keeps exactness beyond
  signed-int64 range for products like 64x64 bits; machine-width inputs
  take a fully vectorized shift-and-mask path).
* **bit planes <-> bit-plane packed words** (:func:`pack_rows` /
  :func:`unpack_rows`) — the packed-execution representation: the *row*
  axis (the crossbar's SIMD batch axis) is packed 64-per-``uint64``
  (or 32-per-``uint32`` for word sizes JAX/TPU prefer), so
  ``(rows, C) uint8 -> (ceil(rows/word), C) words`` and every stateful
  gate evaluates word-wide with bitwise ops. Row ``r`` lands in bit
  ``r % word`` (little-endian) of word ``r // word``; the ragged tail
  pads with zero rows, which :func:`unpack_rows` discards.
"""
from __future__ import annotations

import numpy as np

__all__ = ["to_bits", "from_bits", "mask", "pack_rows", "unpack_rows",
           "WORD_DTYPES"]

WORD_DTYPES = {64: np.uint64, 32: np.uint32}


def mask(n_bits: int) -> int:
    """All-ones mask of ``n_bits`` bits."""
    return (1 << n_bits) - 1


def to_bits(x, n_bits: int) -> np.ndarray:
    """``(...,)`` ints -> ``(..., n_bits)`` uint8 bit planes (little-endian)."""
    arr = np.asarray(x)
    if arr.dtype != object and np.issubdtype(arr.dtype, np.integer) \
            and n_bits <= 64:
        # Vectorized path: two's-complement wrap into n_bits, like the
        # exact path's int(v) & mask(n_bits).
        a = arr.astype(np.uint64) & np.uint64(mask(n_bits) & mask(64))
        shifts = np.arange(n_bits, dtype=np.uint64)
        return ((a[..., None] >> shifts) & np.uint64(1)).astype(np.uint8)
    arr = np.asarray(x, dtype=object)
    out = np.zeros(arr.shape + (n_bits,), dtype=np.uint8)
    flat = arr.reshape(-1)
    oflat = out.reshape(-1, n_bits)
    for i, v in enumerate(flat):
        v = int(v) & mask(n_bits)
        for j in range(n_bits):
            oflat[i, j] = (v >> j) & 1
    return out


def from_bits(bits: np.ndarray) -> np.ndarray:
    """``(..., n_bits)`` {0,1} -> object-int array (exact for any width)."""
    bits = np.asarray(bits)
    n_bits = bits.shape[-1]
    if n_bits <= 64:
        shifts = np.arange(n_bits, dtype=np.uint64)
        vals = np.bitwise_or.reduce(
            bits.astype(np.uint64) << shifts, axis=-1)
        # .astype(object) turns uint64 elements into exact python ints.
        return vals.astype(object)
    flat = bits.reshape(-1, n_bits)
    out = np.empty((flat.shape[0],), dtype=object)
    for i in range(flat.shape[0]):
        v = 0
        for j in range(n_bits):
            if flat[i, j]:
                v |= 1 << j
        out[i] = v
    return out.reshape(bits.shape[:-1])


# ------------------------------------------------- bit-plane packing ----
def pack_rows(bits: np.ndarray, word_bits: int = 64) -> np.ndarray:
    """``(rows, C)`` {0,1} -> ``(ceil(rows/word_bits), C)`` packed words.

    Row ``r`` becomes bit ``r % word_bits`` of word ``r // word_bits``
    (little-endian); the ragged tail is zero-padded. 64-bit words are the
    numpy default; 32-bit words serve JAX (which keeps x64 disabled) and
    the TPU's native 32-bit lanes.
    """
    dtype = WORD_DTYPES[word_bits]
    bits = np.asarray(bits, dtype=np.uint8)
    rows, cols = bits.shape
    n_words = -(-rows // word_bits) if rows else 0
    pad = n_words * word_bits - rows
    if pad:
        bits = np.pad(bits, ((0, pad), (0, 0)))
    planes = bits.reshape(n_words, word_bits, cols).astype(dtype)
    shifts = np.arange(word_bits, dtype=dtype)[None, :, None]
    return np.bitwise_or.reduce(planes << shifts, axis=1)


def unpack_rows(words: np.ndarray, rows: int) -> np.ndarray:
    """Inverse of :func:`pack_rows`: ``(W, C)`` words -> ``(rows, C)``
    uint8 {0,1}, discarding the zero-padded tail rows."""
    words = np.asarray(words)
    word_bits = words.dtype.itemsize * 8
    n_words, cols = words.shape
    shifts = np.arange(word_bits, dtype=words.dtype)[None, :, None]
    planes = (words[:, None, :] >> shifts) & words.dtype.type(1)
    return planes.reshape(n_words * word_bits, cols)[:rows].astype(np.uint8)
