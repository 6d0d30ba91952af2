"""Stateful-logic ISA: the gate set and single-op IR.

Gate semantics follow the accepted abstract stateful-logic model (MAGIC /
FELIX / X-MAGIC):

* Every compute gate drives its *output* cell toward 0: the cell's new
  value is ``old AND gate(inputs)``. A cell initialized to 1 (LRS) therefore
  receives exactly ``gate(inputs)``; skipping initialization implements a
  free AND with the previous content (X-MAGIC input overwriting, used by
  MultPIM optimization IV-B2).
* ``INIT`` is the SET operation (cell -> 1). Batched: many cells across
  many partitions in a single cycle (the usual MAGIC accounting; one
  initialization cycle per algorithm stage).

Gate truth tables (inputs x0, x1, x2 in {0,1}):

=========  =====================================  =================
gate       result                                 used by
=========  =====================================  =================
NOT        1 - x0                                 all
NOR        (x0 + x1) == 0                         Haj-Ali
MIN3       (x0 + x1 + x2) <= 1  (minority-of-3)   MultPIM, RIME
NAND       (x0 AND x1) == 0                       RIME, FELIX
OR         (x0 + x1) >= 1                         FELIX
COPY       x0  (theoretical; Section III only)    partition demos
NOP        1   (AND-identity; executor padding)   executor
=========  =====================================  =================

MultPIM proper uses only NOT/MIN3 (fair comparison with RIME, per the
paper); the wider set exists for the baselines.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["Gate", "Op", "GATE_ARITY"]


class Gate(enum.IntEnum):
    """Stateful-logic gate ids, as stored in the packed tables."""

    NOP = 0
    NOT = 1
    NOR = 2
    MIN3 = 3
    NAND = 4
    OR = 5
    COPY = 6


GATE_ARITY = {
    Gate.NOP: 0,
    Gate.NOT: 1,
    Gate.NOR: 2,
    Gate.MIN3: 3,
    Gate.NAND: 2,
    Gate.OR: 2,
    Gate.COPY: 1,
}


def eval_gate(gate: Gate, xs: Tuple[int, ...]) -> int:
    """Truth table of one gate on {0,1} inputs."""
    if gate == Gate.NOP:
        return 1
    if gate == Gate.NOT:
        return 1 - xs[0]
    if gate == Gate.NOR:
        return int(xs[0] + xs[1] == 0)
    if gate == Gate.MIN3:
        return int(xs[0] + xs[1] + xs[2] <= 1)
    if gate == Gate.NAND:
        return int(not (xs[0] and xs[1]))
    if gate == Gate.OR:
        return int(xs[0] + xs[1] >= 1)
    if gate == Gate.COPY:
        return xs[0]
    raise ValueError(gate)


@dataclass(frozen=True)
class Op:
    """One stateful-logic gate: ``out <- out AND gate(*ins)``.

    ``ins``/``out`` are global column indices. The op electrically engages
    every partition in ``[partition(min col), partition(max col)]`` — the
    inter-partition transistors across that span must conduct, merging the
    span into one effective partition for this cycle.
    """

    gate: Gate
    ins: Tuple[int, ...]
    out: int
    note: str = field(default="", compare=False)

    def __post_init__(self):
        if len(self.ins) != GATE_ARITY[self.gate]:
            raise ValueError(
                f"{self.gate.name} expects {GATE_ARITY[self.gate]} inputs, "
                f"got {len(self.ins)}"
            )

    @property
    def cols(self) -> Tuple[int, ...]:
        """Every column the op touches: inputs, then output."""
        return self.ins + (self.out,)
