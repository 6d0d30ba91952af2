"""Lossless (de)serialization of compiled program artifacts.

The disk cache (:mod:`.diskcache`) stores one ``.npz`` per compiled
entry: the four dense :class:`~repro_torch.core.executor.PackedProgram` tables
as native arrays plus a JSON blob carrying the optimized
:class:`~repro_torch.core.program.Program` (cycles, layout, input/output maps),
the optimization stats and the verification report. Round-tripping is
exact: a reloaded program re-packs to bit-identical tables (asserted by
the engine test suite), so cold processes can skip build, optimize *and*
differential verify.

The port's copy of ``repro.compiler.serialize``: the same ``.npz`` layout
and JSON fields, so an entry either package writes loads in the other.
"""
from __future__ import annotations

import io
import json
from typing import Any, Dict

import numpy as np

from repro_torch.core.executor import PackedProgram, pack_program
from repro_torch.core.isa import Gate, Op
from repro_torch.core.program import Cycle, Layout, Program

from .passes import OptStats
from .verify import VerifyReport

__all__ = ["program_to_dict", "program_from_dict",
           "entry_to_bytes", "entry_from_bytes"]


# ------------------------------------------------------------ program ----
def program_to_dict(prog: Program) -> Dict[str, Any]:
    """JSON-ready form of a :class:`Program` (layout, cycles, maps)."""
    return {
        "name": prog.name,
        "partition_of_col": list(prog.layout._partition_of_col),
        "cycles": [
            {"init": list(c.init_cells), "note": c.note} if c.is_init else
            {"ops": [[int(op.gate), list(op.ins), op.out, op.note]
                     for op in c.ops],
             "note": c.note}
            for c in prog.cycles
        ],
        "input_map": {k: list(v) for k, v in prog.input_map.items()},
        "output_map": {k: list(v) for k, v in prog.output_map.items()},
    }


def program_from_dict(d: Dict[str, Any]) -> Program:
    """Inverse of :func:`program_to_dict`; the result is validated."""
    lay = Layout()
    parts = d["partition_of_col"]
    for _ in range(max(parts) + 1 if parts else 0):
        lay.new_partition()
    for col, pid in enumerate(parts):
        lay.add_cell(pid, f"c{col}")
    cycles = []
    for c in d["cycles"]:
        if "init" in c:
            cycles.append(Cycle(init_cells=list(c["init"]),
                                note=c.get("note", "")))
        else:
            cycles.append(Cycle(
                ops=[Op(Gate(g), tuple(ins), out, note=note)
                     for g, ins, out, note in c["ops"]],
                note=c.get("note", "")))
    prog = Program(layout=lay, cycles=cycles,
                   input_map={k: list(v) for k, v in d["input_map"].items()},
                   output_map={k: list(v) for k, v in d["output_map"].items()},
                   name=d.get("name", "program"))
    prog.validate()
    return prog


# -------------------------------------------------------------- entry ----
def entry_to_bytes(entry: "CompiledEntry") -> bytes:
    """Serialize a verified cache entry to an ``.npz`` byte blob."""
    from .cache import CompiledEntry  # noqa: F401  (type only)
    meta = {
        "program": program_to_dict(entry.program),
        "stats": vars(entry.stats),
        "verified": (None if entry.verified is None else
                     {"ok": entry.verified.ok,
                      "rows_checked": entry.verified.rows_checked,
                      "exhaustive": entry.verified.exhaustive}),
        "packed": {"n_cols": entry.packed.n_cols,
                   "scratch_col": entry.packed.scratch_col},
    }
    buf = io.BytesIO()
    np.savez_compressed(
        buf,
        gate_id=entry.packed.gate_id, in_cols=entry.packed.in_cols,
        out_col=entry.packed.out_col, init_mask=entry.packed.init_mask,
        meta=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8))
    return buf.getvalue()


def entry_from_bytes(blob: bytes, key) -> "CompiledEntry":
    """Reconstruct a :class:`~repro_torch.compiler.cache.CompiledEntry`.

    The optimized program doubles as ``raw`` — equivalence was already
    proven (and recorded) when the entry was spilled, so the original
    unoptimized build is not stored.
    """
    from .cache import CompiledEntry
    with np.load(io.BytesIO(blob)) as z:
        meta = json.loads(bytes(z["meta"].tobytes()).decode())
        packed = PackedProgram(
            gate_id=z["gate_id"], in_cols=z["in_cols"],
            out_col=z["out_col"], init_mask=z["init_mask"],
            n_cols=int(meta["packed"]["n_cols"]),
            scratch_col=int(meta["packed"]["scratch_col"]))
    prog = program_from_dict(meta["program"])
    fresh = pack_program(prog, pad_cols_to=packed.init_mask.shape[1])
    if not (np.array_equal(fresh.gate_id, packed.gate_id)
            and np.array_equal(fresh.in_cols, packed.in_cols)
            and np.array_equal(fresh.out_col, packed.out_col)
            and np.array_equal(fresh.init_mask, packed.init_mask)):
        raise ValueError("disk entry self-check failed: stored tables do "
                         "not match a re-pack of the stored program")
    stats = OptStats(**meta["stats"])
    ver = meta.get("verified")
    report = (None if ver is None else
              VerifyReport(ok=bool(ver["ok"]),
                           rows_checked=int(ver["rows_checked"]),
                           exhaustive=bool(ver["exhaustive"])))
    return CompiledEntry(key=key, raw=prog, program=prog, packed=packed,
                         stats=stats, verified=report, from_disk=True)
