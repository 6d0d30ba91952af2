"""Hierarchical cost model: charge a command trace against a device.

:func:`charge` walks a :class:`~repro_torch.device.trace.CommandTrace` and
produces a :class:`DeviceCostReport` — the device-level counterpart of
the flat per-program :class:`~repro_torch.engine.executable.ExecCost`. The
flat quantities survive unchanged (EXEC records carry the engine's
modeled cycles and per-gate ``energy_uj``); the hierarchy adds the
terms a single-crossbar model cannot see:

* **concurrency** — BARRIERs split the stream into phases; within a
  phase, EXECs at different coordinates overlap, so the critical path
  charges each phase its *busiest coordinate* only
  (``crit_cycles = sum over phases of max-per-coord busy``);
* **row activation energy** — every EXEC adds ``rows x passes x
  row_activation_pj`` on top of the per-gate energy;
* **interconnect hops** — each MOV charges the hop latency of the
  outermost level its endpoints differ at; a BCAST charges its
  *worst* destination (fanout links run in parallel);
* **host transfers** — H2D/D2H bytes over the ``host_bw_gbps`` link.

Hop latency and host transfers are charged serially (one shared
interconnect, one host link) — a deliberate, documented simplification.
On a ``1x1x1x1`` device every added term except the host transfer is
structurally zero, so ``crit_cycles`` and ``exec_energy_uj`` reproduce
the flat single-crossbar accounting exactly (property-tested in
``tests/test_device.py``).

:meth:`DeviceCostReport.capacity` answers the fleet-sizing question:
how many devices sustain a target aggregate tokens/sec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

from .config import Coord, DeviceConfig
from .trace import CommandTrace

__all__ = ["DeviceCostReport", "charge"]


@dataclass
class DeviceCostReport:
    """Per-device cost rollup of one command trace (see :func:`charge`).

    ``levels`` holds one utilization/cost row per hierarchy level
    (crossbar -> bank -> bank group -> channel -> device); scalars carry
    the trace-wide totals. ``tokens`` is the number of tokens the trace
    models (scales :attr:`tokens_per_sec`, not the totals).
    """

    device: DeviceConfig
    tokens: int = 1
    crit_cycles: int = 0          # critical-path cycles across phases
    busy_cycles: int = 0          # sum of all EXEC cycles (all coords)
    hop_ns: float = 0.0           # MOV/BCAST interconnect latency
    transfer_us: float = 0.0      # H2D/D2H host-link time
    exec_energy_uj: float = 0.0   # per-gate energy (flat model, summed)
    row_energy_uj: float = 0.0    # rows x passes x row_activation_pj
    levels: List[Dict] = field(default_factory=list)

    # --------------------------------------------------------- totals ----
    @property
    def compute_us(self) -> float:
        """Critical-path compute time (cycles x cycle_ns)."""
        return self.crit_cycles * self.device.crossbar.cycle_ns / 1e3

    @property
    def latency_us(self) -> float:
        """End-to-end modeled latency: critical-path compute +
        interconnect hops + host transfers."""
        return self.compute_us + self.hop_ns / 1e3 + self.transfer_us

    @property
    def energy_uj(self) -> float:
        """Total energy: per-gate (flat) + row-activation terms."""
        return self.exec_energy_uj + self.row_energy_uj

    @property
    def tokens_per_sec(self) -> float:
        """Decode throughput of ONE device running this trace in a loop."""
        if self.latency_us <= 0:
            return float("inf")
        return self.tokens * 1e6 / self.latency_us

    def capacity(self, target_tokens_per_sec: float, *,
                 spare_frac: float = 0.0) -> int:
        """Fleet sizing: devices needed to sustain an aggregate
        ``target_tokens_per_sec`` (ceil; >= 1 for any positive target).

        ``spare_frac`` reserves failover headroom: the fleet must hold
        the target even after losing that fraction of its devices to
        quarantine (``CoordAllocator.block`` escalations), so the count
        is sized against ``(1 - spare_frac)`` of each device's
        throughput. ``spare_frac=0.25`` with a 4-device answer returns
        6: lose any quarter of the fleet and the target still holds."""
        if target_tokens_per_sec <= 0:
            return 0
        if not 0.0 <= spare_frac < 1.0:
            raise ValueError(f"spare_frac must be in [0, 1), "
                             f"got {spare_frac}")
        return max(1, math.ceil(
            target_tokens_per_sec
            / (self.tokens_per_sec * (1.0 - spare_frac))))

    # -------------------------------------------------------- display ----
    def as_dict(self) -> Dict:
        """JSON-friendly form (what the ``device`` benchmark emits)."""
        return {
            "device": str(self.device),
            "tokens": self.tokens,
            "crit_cycles": self.crit_cycles,
            "busy_cycles": self.busy_cycles,
            "hop_ns": self.hop_ns,
            "transfer_us": self.transfer_us,
            "compute_us": self.compute_us,
            "latency_us": self.latency_us,
            "exec_energy_uj": self.exec_energy_uj,
            "row_energy_uj": self.row_energy_uj,
            "energy_uj": self.energy_uj,
            "tokens_per_sec": self.tokens_per_sec,
            "levels": self.levels,
        }

    def summary(self) -> str:
        """Human-readable per-level table + totals."""
        lines = [f"device cost ({self.device}, {self.tokens} token"
                 f"{'s' if self.tokens != 1 else ''}):"]
        lines.append(f"  {'level':<10} {'units':>6} {'used':>5} "
                     f"{'busy cyc':>12} {'util':>7}")
        for row in self.levels:
            lines.append(
                f"  {row['level']:<10} {row['units']:>6} "
                f"{row['used']:>5} {row['busy_cycles']:>12,} "
                f"{row['utilization']:>6.1%}")
        lines.append(
            f"  critical path {self.crit_cycles:,} cyc = "
            f"{self.compute_us:,.1f} us compute + {self.hop_ns:,.0f} ns "
            f"hops + {self.transfer_us:,.2f} us host transfer "
            f"-> {self.latency_us:,.1f} us/{self.tokens} tok")
        lines.append(
            f"  energy {self.energy_uj:,.2f} uJ "
            f"({self.exec_energy_uj:,.2f} gate + "
            f"{self.row_energy_uj:,.2f} row-activation), "
            f"{self.tokens_per_sec:,.0f} tokens/sec/device")
        return "\n".join(lines)


def _unit_key(coord: Coord, level: str):
    """Coordinate -> its containing unit at ``level``."""
    if level == "device":
        return 0
    if level == "channel":
        return coord.channel
    if level == "group":
        return (coord.channel, coord.group)
    if level == "bank":
        return (coord.channel, coord.group, coord.bank)
    return (coord.channel, coord.group, coord.bank, coord.crossbar)


def charge(trace: CommandTrace, *, tokens: int = 1) -> DeviceCostReport:
    """Charge every record of ``trace`` against its device; see the
    module docstring for the model. ``tokens`` declares how many tokens
    the trace covers (``block_trace(plan, dev, tokens=T)`` -> T)."""
    dev = trace.device
    rep = DeviceCostReport(device=dev, tokens=tokens)
    busy: Dict[Coord, int] = {}           # whole-trace busy per coord
    phase_busy: Dict[Coord, int] = {}     # current phase only

    def close_phase():
        if phase_busy:
            rep.crit_cycles += max(phase_busy.values())
            phase_busy.clear()

    for rec in trace.records:
        if rec.kind == "EXEC":
            at = Coord.parse(rec.fields["at"])
            cycles = int(rec.get("cycles", "0"))
            busy[at] = busy.get(at, 0) + cycles
            phase_busy[at] = phase_busy.get(at, 0) + cycles
            rep.busy_cycles += cycles
            rep.exec_energy_uj += float(rec.get("energy_uj", "0"))
            rep.row_energy_uj += (int(rec.get("rows", "0"))
                                  * int(rec.get("passes", "1"))
                                  * dev.row_activation_pj / 1e6)
        elif rec.kind == "MOV":
            rep.hop_ns += dev.hop_ns(Coord.parse(rec.fields["src"]),
                                     Coord.parse(rec.fields["dst"]))
        elif rec.kind == "BCAST":
            src = Coord.parse(rec.fields["src"])
            rep.hop_ns += max(
                dev.hop_ns(src, Coord.parse(d))
                for d in rec.fields["dst"].split(","))
        elif rec.kind in ("H2D", "D2H"):
            rep.transfer_us += dev.transfer_us(int(rec.get("bytes", "0")))
        elif rec.kind == "BARRIER":
            close_phase()
    close_phase()

    # Per-level utilization rows: how much of the critical-path window
    # each level's *engaged* capacity spent computing.
    per_unit = {
        "crossbar": 1,
        "bank": dev.crossbars_per_bank,
        "group": dev.crossbars_per_bank * dev.banks_per_group,
        "channel": (dev.crossbars_per_bank * dev.banks_per_group
                    * dev.groups_per_channel),
        "device": dev.n_crossbars,
    }
    totals = {
        "crossbar": dev.n_crossbars,
        "bank": dev.n_banks,
        "group": dev.groups_per_channel * dev.channels_per_device,
        "channel": dev.channels_per_device,
        "device": 1,
    }
    for level in ("crossbar", "bank", "group", "channel", "device"):
        units = {}
        for coord, cyc in busy.items():
            key = _unit_key(coord, level)
            units[key] = units.get(key, 0) + cyc
        used = len(units)
        window = rep.crit_cycles * used * per_unit[level]
        rep.levels.append({
            "level": level,
            "units": totals[level],
            "used": used,
            "busy_cycles": sum(units.values()),
            "utilization": (sum(units.values()) / window
                            if window else 0.0),
        })
    return rep
