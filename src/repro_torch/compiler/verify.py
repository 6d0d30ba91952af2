"""Differential verification: optimized program == original on run_numpy.

The passes are argued correct structurally, but every compiled artifact
is *proven* equivalent the same way the paper validates its schedules:
execute both programs on random row batches through the reference
executor and require bit-exact outputs. Inputs are unconstrained random
bits — equivalence must hold for any input, including ones outside an
algorithm's documented precondition (the schedule itself is
data-independent, so this is the strongest check available short of
exhaustive enumeration, which we also do when the input space is tiny).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

from repro_torch.core.executor import run_numpy
from repro_torch.core.program import Program

__all__ = ["VerifyReport", "verify_equivalence", "verify_or_raise"]

_EXHAUSTIVE_BITS = 12   # <= 4096 input combinations -> enumerate them all


@dataclass
class VerifyReport:
    """Outcome of one differential verification."""

    ok: bool
    rows_checked: int
    exhaustive: bool
    mismatches: List[str] = field(default_factory=list)

    def __bool__(self) -> bool:
        return self.ok


def _total_input_bits(prog: Program) -> int:
    return sum(len(cols) for cols in prog.input_map.values())


def _random_inputs(prog: Program, rows: int, rng) -> Dict[str, np.ndarray]:
    return {name: rng.integers(0, 2, (rows, len(cols)), dtype=np.uint8)
            for name, cols in prog.input_map.items()}


def _exhaustive_inputs(prog: Program) -> Dict[str, np.ndarray]:
    widths = {name: len(cols) for name, cols in prog.input_map.items()}
    total = sum(widths.values())
    combos = np.array(list(itertools.product([0, 1], repeat=total)),
                      dtype=np.uint8)
    out, off = {}, 0
    for name, w in widths.items():
        out[name] = combos[:, off:off + w]
        off += w
    return out


def verify_equivalence(original: Program, optimized: Program, *,
                       rows: int = 64, batches: int = 2,
                       seed: int = 0) -> VerifyReport:
    """Bit-exact differential check of ``optimized`` against ``original``.

    Enumerates the full input space when it is small enough; otherwise
    runs ``batches`` random row batches of ``rows`` each.
    """
    optimized.validate()
    if set(original.output_map) != set(optimized.output_map):
        return VerifyReport(False, 0, False,
                            [f"output sets differ: "
                             f"{sorted(original.output_map)} vs "
                             f"{sorted(optimized.output_map)}"])
    exhaustive = _total_input_bits(original) <= _EXHAUSTIVE_BITS
    rng = np.random.default_rng(seed)
    mismatches: List[str] = []
    checked = 0
    for b in range(1 if exhaustive else batches):
        inputs = (_exhaustive_inputs(original) if exhaustive
                  else _random_inputs(original, rows, rng))
        want = run_numpy(original, inputs)
        got = run_numpy(optimized, inputs)
        checked += next(iter(inputs.values())).shape[0]
        for name in want:
            if not np.array_equal(want[name], got[name]):
                bad = int(np.argwhere(
                    (want[name] != got[name]).any(axis=1))[0][0])
                mismatches.append(
                    f"output '{name}' row {bad}: "
                    f"want {want[name][bad].tolist()} "
                    f"got {got[name][bad].tolist()}")
        if mismatches:
            break
    return VerifyReport(not mismatches, checked, exhaustive, mismatches)


def verify_or_raise(original: Program, optimized: Program, **kw) -> VerifyReport:
    """Run :func:`verify_equivalence` and raise on a mismatch."""
    rep = verify_equivalence(original, optimized, **kw)
    if not rep.ok:
        raise AssertionError(
            f"optimized '{optimized.name}' diverges from original: "
            + "; ".join(rep.mismatches[:3]))
    return rep
