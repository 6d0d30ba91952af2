"""Crossbar waterfall: cycle-level occupancy + switching-activity proxy.

Two modeled-time views of a compiled program, both derived purely from
the IR / packed tables (no hardware in the loop):

* :func:`cycle_occupancy` walks the :class:`~repro_torch.core.program.Program`
  schedule and reports, per cycle, how busy the crossbar is — ops
  issued, partition-span columns engaged (the electrical spans the
  validator checks for disjointness), cells written/SET. Rendered by
  :func:`waterfall_events` as Chrome trace *counter* tracks on a
  modeled-cycle time axis (``ts = t * cycle_ns``), so a list-scheduled
  vs greedy schedule — or a co-scheduled group's interleaving — is
  visible as the shape of the occupancy curve.

* :func:`switching_profile` interprets the packed tables over a
  deterministic random input state and counts bit flips (popcount of
  the XOR between consecutive packed states) per cycle.
  :func:`switching_activity` reduces that to one scalar — mean bit
  flips per crossbar row for a full pass — which the engine surfaces as
  ``ExecCost.energy_proxy``: the switching counts ROADMAP direction 5
  asks for, free because the packed executor is just bitwise words.

Layering: this module may import :mod:`repro_torch.core` only — the compiler
and engine import :mod:`repro_torch.obs`, so anything higher would cycle.
Partition spans are therefore recomputed inline from
``layout.partition_of`` (matching ``Program.validate``) rather than
reusing the compiler's dep-graph helpers.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.bits import pack_rows
from repro_torch.core.costmodel import CYCLE_NS_DEFAULT
from repro_torch.core.executor import PackedProgram, gate_eval_packed
from repro_torch.core.program import Program

__all__ = ["cycle_occupancy", "switching_profile", "switching_activity",
           "waterfall_events"]

# Popcount via byte-view lookup: no numpy popcount until 2.x.
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint32)


def _popcount(a: np.ndarray) -> int:
    return int(_POP8[a.view(np.uint8)].sum())


# ---------------------------------------------------------- occupancy ----
def cycle_occupancy(prog: Program) -> Dict[str, List[int]]:
    """Per-cycle busy-ness of ``prog``'s schedule.

    Returns parallel lists of length ``prog.n_cycles``:

    * ``ops`` — compute ops issued this cycle (0 for init cycles);
    * ``partitions_busy`` — total partitions electrically engaged: the
      sum over ops of their merged span width
      ``partition(max col) - partition(min col) + 1`` (compute), or the
      count of distinct partitions holding SET cells (init);
    * ``cols_written`` — cells AND-written (compute) or SET (init);
    * ``init`` — 1 for init cycles, else 0.
    """
    lay = prog.layout
    ops: List[int] = []
    busy: List[int] = []
    written: List[int] = []
    init: List[int] = []
    for cyc in prog.cycles:
        if cyc.is_init:
            ops.append(0)
            busy.append(len({lay.partition_of(c) for c in cyc.init_cells}))
            written.append(len(cyc.init_cells))
            init.append(1)
            continue
        b = 0
        for op in cyc.ops:
            pids = [lay.partition_of(c) for c in op.cols]
            b += max(pids) - min(pids) + 1
        ops.append(len(cyc.ops))
        busy.append(b)
        written.append(len({op.out for op in cyc.ops}))
        init.append(0)
    return {"ops": ops, "partitions_busy": busy,
            "cols_written": written, "init": init}


# ----------------------------------------------------------- switching ----
def switching_profile(packed: PackedProgram, rows: int = 64,
                      seed: int = 0) -> np.ndarray:
    """Bit flips per crossbar row per cycle, shape ``(n_cycles,)``.

    Interprets the packed tables word-wide (same bitwise semantics as
    the packed backends) starting from a deterministic random {0,1}
    state — an average-case activity estimate rather than a
    data-specific one. ``rows`` must be a multiple of 64 so the packed
    words carry no zero-padded phantom lanes (padding lanes would
    otherwise count spurious flips on every init cycle).
    """
    if rows % 64:
        raise ValueError(f"rows must be a multiple of 64, got {rows}")
    rng = np.random.default_rng(seed)
    C = packed.init_mask.shape[1]
    bits = rng.integers(0, 2, size=(rows, C), dtype=np.uint8)
    # The scratch column only ever receives NOP results (constant 1
    # AND-written): it cannot flip, so its start value is irrelevant;
    # zero it for determinism across pad widths.
    bits[:, packed.scratch_col:] = 0
    state = pack_rows(bits, word_bits=64)

    full = np.uint64(~np.uint64(0))
    flips = np.zeros(packed.n_cycles, dtype=np.float64)
    for t in range(packed.n_cycles):
        init = packed.init_mask[t]
        if init.any():
            new = state | np.where(init, full, np.uint64(0))[None, :]
        else:
            x = state[:, packed.in_cols[t]]            # (W, M, 3)
            res = gate_eval_packed(np, packed.gate_id[t][None, :],
                                   x[:, :, 0], x[:, :, 1], x[:, :, 2])
            new = state.copy()
            np.bitwise_and.at(new, (slice(None), packed.out_col[t]), res)
        flips[t] = _popcount(state ^ new)
        state = new
    return flips / rows


def switching_activity(packed: PackedProgram, rows: int = 64,
                       seed: int = 0) -> float:
    """Total bit flips per crossbar row for one full pass of ``packed``
    (the ``energy_proxy`` scalar). Memoized on the packed program."""
    memo = getattr(packed, "_energy_proxy", None)
    if memo is not None and memo[0] == (rows, seed):
        return memo[1]
    v = float(switching_profile(packed, rows=rows, seed=seed).sum())
    packed._energy_proxy = ((rows, seed), v)
    return v


# -------------------------------------------------------------- export ----
def waterfall_events(prog: Program, *, packed: Optional[PackedProgram]
                     = None, name: Optional[str] = None, pid: int = 2,
                     cycle_ns: float = CYCLE_NS_DEFAULT,
                     track: Optional[str] = None) -> List[dict]:
    """Chrome trace events for one program's waterfall.

    Emits a ``process_name`` metadata event plus per-cycle counter
    (``ph: "C"``) samples on a modeled time axis (cycle ``t`` at
    ``t * cycle_ns``): an ``occupancy`` track with ops /
    partitions-busy / cols-written series and — when ``packed`` is
    given — a ``switching`` track with bit flips per row. Feed the
    result to ``Tracer.add_events``; use a distinct ``pid`` (>= 2) per
    program so each gets its own process row next to the wall-time
    spans (pid 1). ``track`` prefixes the counter names (e.g.
    ``"ch0.bg0.b0.x0"`` from a device placement) so several placed
    copies of the same program stay distinguishable in one process row.
    """
    label = name or prog.name
    prefix = f"{track}/" if track else ""
    occ = cycle_occupancy(prog)
    sw = switching_profile(packed) if packed is not None else None
    events: List[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": f"waterfall: {prefix}{label} (modeled cycles)"},
    }]
    T = prog.n_cycles
    for t in range(T + 1):        # one trailing sample closes the track
        ts = t * cycle_ns / 1e3   # trace ts is microseconds
        done = t == T
        events.append({
            "name": f"{prefix}occupancy", "ph": "C", "ts": ts, "pid": pid,
            "args": {
                "ops": 0 if done else occ["ops"][t],
                "partitions_busy": 0 if done else occ["partitions_busy"][t],
                "cols_written": 0 if done else occ["cols_written"][t],
            },
        })
        if sw is not None:
            events.append({
                "name": f"{prefix}switching", "ph": "C", "ts": ts, "pid": pid,
                "args": {"bit_flips_per_row":
                         0.0 if done else round(float(sw[t]), 3)},
            })
    return events
