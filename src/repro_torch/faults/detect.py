"""Host-side detection companions to the compiled residue checks.

The device side of detection is the compiled ``residue`` program
(:func:`repro_torch.core.residue.residue_program`): at ``drain()`` the
resident executor runs it over the carry-save state and reads back a
5-bit ``(mod-3, mod-7)`` residue pair per lane — a cheap D2H transfer
that flags accumulator corruption with probability 20/21 per corrupted
lane. The host side lives here:

* :class:`ResidueShadow` — the per-lane *expected* accumulator,
  maintained from the operand stream the executor already marshals
  (``value += a*b``, reset on a ``fresh`` restart). It yields the
  reference residues the device values are checked against, and doubles
  as the exact checksum for the drained token itself (the drain crosses
  to the host anyway, so checking it there models host-boundary ECC and
  catches corruption injected during the recombination pass, which the
  accumulator residue cannot see).
* :func:`decode_residues` — device residue bit-planes -> canonical
  ``(r3, r7)`` ints. The device value is intentionally non-canonical
  (end-around-carry arithmetic leaves ``3 === 0 (mod 3)`` and ``7 === 0
  (mod 7)`` representations), so both sides reduce before comparing.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.bits import from_bits

__all__ = ["ResidueShadow", "decode_residues"]


def decode_residues(res_bits: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(rows, 5)`` residue output planes (r3 bits ++ r7 bits, LE) ->
    canonical ``(r3, r7)`` int arrays (``r3 in [0,3)``, ``r7 in
    [0,7)``)."""
    r3 = from_bits(res_bits[:, :2]).astype(np.int64) % 3
    r7 = from_bits(res_bits[:, 2:5]).astype(np.int64) % 7
    return r3, r7


class ResidueShadow:
    """Expected per-lane accumulator value, tracked from operands.

    Exact python-int arithmetic (object dtype) so any width is safe;
    ``absorb`` mirrors a MAC pass (``fresh`` lanes restart at ``a*b``),
    ``residues``/``values`` produce the references ``drain()`` checks
    against.
    """

    def __init__(self, rows: int, n_bits: int):
        self.rows = rows
        self.mask = (1 << (2 * n_bits)) - 1
        self.value = np.zeros(rows, dtype=object)

    def absorb(self, a: np.ndarray, b: np.ndarray,
               fresh: np.ndarray) -> None:
        """One MAC pass: ``value = (fresh ? 0 : value) + a*b``."""
        base = np.where(np.asarray(fresh, dtype=bool), 0, self.value)
        self.value = base + (np.asarray(a, dtype=object)
                             * np.asarray(b, dtype=object))

    def values(self) -> np.ndarray:
        """Expected drained tokens: ``value mod 2^(2n)`` (object ints)."""
        return np.array([int(v) & self.mask for v in self.value],
                        dtype=object)

    def residues(self) -> Tuple[np.ndarray, np.ndarray]:
        """Expected ``(mod-3, mod-7)`` residues of the accumulator."""
        vals = self.values()
        r3 = np.array([int(v) % 3 for v in vals], dtype=np.int64)
        r7 = np.array([int(v) % 7 for v in vals], dtype=np.int64)
        return r3, r7

    def zero_lanes(self) -> np.ndarray:
        """Lanes whose expected value is 0 — products are non-negative,
        so these lanes can restart from any point for free (the replay
        window uses this to stay bounded)."""
        return np.array([int(v) == 0 for v in self.value], dtype=bool)

    def reset(self) -> None:
        """Forget everything (executor ``reset()``)."""
        self.value = np.zeros(self.rows, dtype=object)
