"""PIM program IR: partitioned column layout, cycles, legality validation.

A *program* is a static (data-independent) schedule of clock cycles. Each
cycle is either:

* a **compute cycle** — a set of stateful-logic ops executed in parallel.
  Legality (the memristive-partition model of FELIX/RIME/MultPIM):

  - every op electrically engages the contiguous partition span
    ``[partition(min col), partition(max col)]`` (the transistors across
    the span conduct, merging it into one effective partition);
  - engaged spans of distinct ops must be pairwise disjoint;
  - a merged span executes exactly one gate per cycle.

* an **init cycle** — a batched SET (cell -> 1) of any set of cells.
  Standard MAGIC accounting: one cycle regardless of how many cells, since
  initialization voltages drive all selected bitline segments in parallel.

Cycle and memristor (area) accounting therefore falls out of the schedule
itself; this is the same methodology as the paper's custom cycle-accurate
simulator (Section V-C).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .isa import Op

__all__ = ["Layout", "Cycle", "Program", "ProgramBuilder"]


class Layout:
    """Named-cell -> global-column allocator with partition structure.

    Columns are allocated left to right; partitions are contiguous column
    ranges. Cell names are ``(partition_index, local_name)``.
    """

    def __init__(self):
        self._cols: Dict[Tuple[int, str], int] = {}
        self._partition_of_col: List[int] = []
        self._n_partitions = 0

    def new_partition(self) -> int:
        """Declare a new partition and return its id."""
        pid = self._n_partitions
        self._n_partitions += 1
        return pid

    def add_cell(self, pid: int, name: str) -> int:
        """Allocate a named cell in partition ``pid`` and return its column."""
        if pid >= self._n_partitions:
            raise ValueError(f"partition {pid} not declared")
        key = (pid, name)
        if key in self._cols:
            raise ValueError(f"duplicate cell {key}")
        col = len(self._partition_of_col)
        self._cols[key] = col
        self._partition_of_col.append(pid)
        return col

    def cell(self, pid: int, name: str) -> int:
        """Column of the named cell in partition ``pid``."""
        return self._cols[(pid, name)]

    def has_cell(self, pid: int, name: str) -> bool:
        """Whether partition ``pid`` holds the named cell."""
        return (pid, name) in self._cols

    def partition_of(self, col: int) -> int:
        """Partition that holds column ``col``."""
        return self._partition_of_col[col]

    @property
    def n_cols(self) -> int:
        """Number of allocated columns."""
        return len(self._partition_of_col)

    @property
    def n_partitions(self) -> int:
        """Number of declared partitions."""
        return self._n_partitions

    def cells_in_partition(self, pid: int) -> List[int]:
        """Columns of every cell in partition ``pid``."""
        return [c for (p, _), c in self._cols.items() if p == pid]


@dataclass
class Cycle:
    """One clock cycle: parallel compute ops XOR a batched init."""

    ops: List[Op] = field(default_factory=list)
    init_cells: List[int] = field(default_factory=list)
    note: str = ""

    @property
    def is_init(self) -> bool:
        """Whether this cycle is an INIT (SET) cycle."""
        return bool(self.init_cells)


@dataclass
class Program:
    """A validated stateful-logic schedule with its I/O maps."""

    layout: Layout
    cycles: List[Cycle]
    input_map: Dict[str, List[int]]  # logical input name -> bit columns (LE)
    output_map: Dict[str, List[int]]
    name: str = "program"

    # ---------- accounting ----------
    @property
    def n_cycles(self) -> int:
        """Number of cycles."""
        return len(self.cycles)

    @property
    def n_memristors(self) -> int:
        """Area = distinct columns ever used (inputs, outputs, work cells)."""
        used = set()
        for cyc in self.cycles:
            used.update(cyc.init_cells)
            for op in cyc.ops:
                used.update(op.cols)
        for cols in self.input_map.values():
            used.update(cols)
        for cols in self.output_map.values():
            used.update(cols)
        return len(used)

    @property
    def n_partitions(self) -> int:
        """Number of declared partitions."""
        return self.layout.n_partitions

    def gate_histogram(self) -> Dict[str, int]:
        """Count of ops per gate name."""
        hist: Dict[str, int] = {}
        for cyc in self.cycles:
            if cyc.is_init:
                hist["INIT"] = hist.get("INIT", 0) + 1
            for op in cyc.ops:
                hist[op.gate.name] = hist.get(op.gate.name, 0) + 1
        return hist

    # ---------- legality ----------
    def validate(self) -> None:
        """Check partition, hazard and I/O rules; raise on a violation."""
        lay = self.layout
        for t, cyc in enumerate(self.cycles):
            if cyc.is_init and cyc.ops:
                raise ValueError(f"cycle {t}: mixed init+compute not allowed")
            spans: List[Tuple[int, int]] = []
            touched: set = set()
            for op in cyc.ops:
                cols = op.cols
                lo = min(lay.partition_of(c) for c in cols)
                hi = max(lay.partition_of(c) for c in cols)
                for (a, b) in spans:
                    if not (hi < a or lo > b):
                        raise ValueError(
                            f"cycle {t}: overlapping partition spans "
                            f"[{lo},{hi}] vs [{a},{b}] ({op.note})"
                        )
                spans.append((lo, hi))
                if op.out in touched:
                    raise ValueError(f"cycle {t}: column {op.out} written twice")
                touched.add(op.out)
        # dataflow sanity: every compute input must have been written,
        # init'd, or be a program input.
        written = set()
        for cols in self.input_map.values():
            written.update(cols)
        for t, cyc in enumerate(self.cycles):
            written.update(cyc.init_cells)
            for op in cyc.ops:
                for c in op.ins:
                    if c not in written:
                        raise ValueError(
                            f"cycle {t}: reads column {c} before any write "
                            f"({op.note})"
                        )
                written.add(op.out)


class ProgramBuilder:
    """Imperative builder used by the algorithm generators."""

    def __init__(self, layout: Layout, name: str = "program"):
        self.layout = layout
        self.cycles: List[Cycle] = []
        self.input_map: Dict[str, List[int]] = {}
        self.output_map: Dict[str, List[int]] = {}
        self.name = name

    def declare_input(self, name: str, cols: Sequence[int]) -> None:
        """Bind input ``name`` to its bit columns (little-endian)."""
        self.input_map[name] = list(cols)

    def declare_output(self, name: str, cols: Sequence[int]) -> None:
        """Bind output ``name`` to its bit columns (little-endian)."""
        self.output_map[name] = list(cols)

    def cycle(self, ops: Sequence[Op], note: str = "") -> Cycle:
        """Append a compute cycle of ``ops``."""
        cyc = Cycle(ops=list(ops), note=note)
        self.cycles.append(cyc)
        return cyc

    def init(self, cells: Sequence[int], note: str = "") -> Cycle:
        """Append an INIT cycle that SETs ``cells``."""
        cells = sorted(set(cells))
        if not cells:
            raise ValueError("empty init")
        cyc = Cycle(init_cells=list(cells), note=note)
        self.cycles.append(cyc)
        return cyc

    def build(self, validate: bool = True) -> Program:
        """Finish the program (validated unless ``validate`` is false)."""
        prog = Program(
            layout=self.layout,
            cycles=self.cycles,
            input_map=self.input_map,
            output_map=self.output_map,
            name=self.name,
        )
        if validate:
            prog.validate()
        return prog
