"""Command traces: the host<->device ISA of the hierarchy simulator.

A :class:`CommandTrace` is the flat record stream a host controller
would issue to drive one PIM device — the repo's analogue of
HBM-PIMulator's ``example.trace`` (``PIM MAC GRF,0 BANK,0 SRF,0``), with
crossbar coordinates in place of GRF/SRF operand files. The text format
is specified in `docs/trace-format.md`; one line per record::

    KIND id=<N> key=value ... [| name:1,2,3;name2:4,5]

Record kinds:

``DEVICE``   device shape + cost parameters (always the first record);
``PROG``     a compiled co-scheduled group's identity (op:n:copies:label
             members, in slot order) — the trace's program table;
``H2D``      host -> device operand upload for one slot (payload =
             integer operands, name:csv);
``EXEC``     one fused crossbar pass of a PROG at a coordinate;
             ``in=`` lists the H2D records it consumes (its dependency
             edges), ``cycles``/``rows``/``passes``/``energy_uj`` carry
             the modeled cost;
``D2H``      device -> host readback of one slot's outputs (payload =
             the integers the pass produced — traces are
             self-verifying);
``MOV``      point-to-point operand movement between coordinates;
``BCAST``    one source coordinate to many destinations;
``BARRIER``  ordering edge: records after it may not start until every
             record before it retired. Between barriers, records at
             *different* coordinates are concurrent.

Two producers emit traces. :class:`TraceRecorder` hooks
:meth:`repro_torch.engine.executable.GroupedExecutable.run` (its
``recorder=`` parameter) and captures *executed* passes with full
operand/result payloads — such traces replay bit-exact:
:meth:`CommandTrace.replay` recompiles each PROG through a fresh Engine,
re-runs the H2D payloads, and :meth:`CommandTrace.verify_replay` proves
the outputs equal the recorded D2H payloads. :func:`block_trace` instead
*models* a planned transformer block
(:func:`repro_torch.pim.planner.plan_block`) token by token — per-scope
H2D/BCAST/EXEC/MOV/BARRIER with modeled cycles and byte counts but no
payloads — which is what the hierarchical cost model
(:mod:`repro_torch.device.cost`) charges.

The port's copy of ``repro.device.trace``. The text format is the same
in both packages, so a trace recorded by either replays in the other.
On a CUDA engine each replayed EXEC is one crossbar kernel launch (K1
packed, K2 unpacked).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.bits import from_bits, to_bits

from .config import Coord, CoordAllocator, DeviceConfig

__all__ = ["Record", "CommandTrace", "TraceRecorder", "block_trace"]

# Record kinds, in the order docs/trace-format.md documents them.
KINDS = ("DEVICE", "PROG", "H2D", "EXEC", "D2H", "MOV", "BCAST",
         "BARRIER")


def _fmt(value) -> str:
    """Field value -> token (floats shortest-round-trip, no spaces)."""
    if isinstance(value, float):
        return format(value, ".10g")
    return str(value)


@dataclass
class Record:
    """One command-trace line: ``KIND id=N key=value ... [| payload]``.

    ``fields`` preserves emission order; ``payload`` (H2D operands, D2H
    results) maps plane names to exact integer lists and round-trips
    arbitrary-precision ints.
    """

    kind: str
    rid: int
    fields: Dict[str, str] = field(default_factory=dict)
    payload: Optional[Dict[str, List[int]]] = None

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        """Field value as the serialized string (``None``-safe)."""
        return self.fields.get(key, default)

    def ints(self, key: str) -> List[int]:
        """A comma-separated integer field (``in=3,4,5``) as a list;
        empty/missing fields give ``[]``."""
        raw = self.fields.get(key, "")
        return [int(t) for t in raw.split(",") if t != ""]

    def line(self) -> str:
        """Serialize to the one-line text form."""
        toks = [self.kind, f"id={self.rid}"]
        toks += [f"{k}={_fmt(v)}" for k, v in self.fields.items()]
        text = " ".join(toks)
        if self.payload is not None:
            body = ";".join(
                f"{name}:{','.join(str(int(v)) for v in vals)}"
                for name, vals in self.payload.items())
            text += " | " + body
        return text

    @classmethod
    def parse(cls, line: str) -> "Record":
        """Inverse of :meth:`line`."""
        head, sep, body = line.partition(" | ")
        toks = head.split()
        if len(toks) < 2 or toks[0] not in KINDS:
            raise ValueError(f"bad trace record {line!r}")
        fields: Dict[str, str] = {}
        rid = None
        for tok in toks[1:]:
            k, eq, v = tok.partition("=")
            if not eq:
                raise ValueError(f"bad field {tok!r} in {line!r}")
            if k == "id":
                rid = int(v)
            else:
                fields[k] = v
        if rid is None:
            raise ValueError(f"record without id: {line!r}")
        payload = None
        if sep:
            payload = {}
            for part in body.split(";"):
                name, colon, csv = part.partition(":")
                if not colon:
                    raise ValueError(f"bad payload {part!r} in {line!r}")
                payload[name] = [int(t) for t in csv.split(",")
                                 if t != ""]
        return cls(kind=toks[0], rid=rid, fields=fields, payload=payload)


def _plane_bytes(rows: int, widths: Sequence[int]) -> int:
    """Host-link bytes for ``rows`` operands over the given bit widths."""
    return sum(-(-rows * w // 8) for w in widths)


def _pack_value(name: str, value) -> Tuple[List[int], bool]:
    """One slot input/output -> (exact row integers, was_bit_planes).

    Integer-form values pass through; ``(rows, n_bits)`` {0,1} bit
    planes row-pack losslessly via :func:`repro_torch.core.bits.from_bits`
    (the payload stays a flat integer list either way — ``planes=``
    fields name which entries need re-expansion on replay)."""
    arr = np.asarray(value)
    if arr.ndim > 2:
        raise TypeError(f"{name!r}: expected (rows,) ints or "
                        f"(rows, n_bits) planes, got shape {arr.shape}")
    if arr.ndim == 2:
        return [int(v) for v in from_bits(np.asarray(arr, dtype=np.uint8))
                ], True
    return [int(v) for v in np.atleast_1d(arr).tolist()], False


class CommandTrace:
    """An ordered record stream for one device.

    Build with :meth:`add` (or via :class:`TraceRecorder` /
    :func:`block_trace`), serialize with :meth:`dumps`/:meth:`dump`,
    reload with :meth:`loads`/:meth:`load`, and re-execute payload
    traces with :meth:`replay`/:meth:`verify_replay`. Record 0 is
    always the ``DEVICE`` record describing the target.
    """

    def __init__(self, device: DeviceConfig):
        self.device = device
        self.records: List[Record] = []
        self._next = 0
        xb = device.crossbar
        self.add("DEVICE", shape=str(device), rows=xb.rows, cols=xb.cols,
                 cycle_ns=xb.cycle_ns, energy_pj=xb.energy_pj_per_gate,
                 row_act_pj=device.row_activation_pj,
                 hop_ns=",".join(_fmt(h) for h in (
                     device.crossbar_hop_ns, device.bank_hop_ns,
                     device.group_hop_ns, device.channel_hop_ns)),
                 host_gbps=device.host_bw_gbps)

    # --------------------------------------------------------- building ----
    def add(self, kind: str,
            payload: Optional[Dict[str, List[int]]] = None,
            **fields) -> Record:
        """Append a record (id auto-assigned); returns it."""
        if kind not in KINDS:
            raise ValueError(f"unknown record kind {kind!r} "
                             f"(one of {', '.join(KINDS)})")
        rec = Record(kind=kind, rid=self._next,
                     fields={k: _fmt(v) for k, v in fields.items()},
                     payload=payload)
        self._next += 1
        self.records.append(rec)
        return rec

    # ----------------------------------------------------------- queries ----
    def by_kind(self, kind: str) -> List[Record]:
        """All records of one kind, in stream order."""
        return [r for r in self.records if r.kind == kind]

    def record(self, rid: int) -> Record:
        """Record by id."""
        for r in self.records:
            if r.rid == rid:
                return r
        raise KeyError(f"no record id={rid}")

    def progs(self) -> Dict[int, List]:
        """PROG table: record id -> the :class:`repro_torch.engine.GroupSpec`
        list that recompiles the group (slot order preserved)."""
        from repro_torch.engine import GroupSpec
        table: Dict[int, List] = {}
        for rec in self.by_kind("PROG"):
            specs = []
            for member in rec.fields["members"].split("|"):
                op, n, copies, label = member.split(":", 3)
                specs.append(GroupSpec(op=op, n=int(n), copies=int(copies),
                                       label=label or None))
            table[rec.rid] = specs
        return table

    def summary(self) -> str:
        """One line per record kind: count plus aggregate bytes/cycles."""
        counts = {k: 0 for k in KINDS}
        for r in self.records:
            counts[r.kind] += 1
        cycles = sum(int(r.get("cycles", "0")) for r in self.by_kind("EXEC"))
        moved = sum(int(r.get("bytes", "0")) for r in self.records
                    if r.kind in ("H2D", "D2H", "MOV", "BCAST"))
        parts = [f"{k}:{c}" for k, c in counts.items() if c]
        return (f"trace[{self.device}] {len(self.records)} records "
                f"({' '.join(parts)}), {cycles:,} EXEC cycles, "
                f"{moved:,} bytes moved")

    # ------------------------------------------------------ serialization ----
    def dumps(self) -> str:
        """The documented text form (`docs/trace-format.md`).

        The header is the reference package's, word for word, so a trace
        dumps byte-identically from either package."""
        head = [
            "# repro.device command trace (format: docs/trace-format.md)",
            f"# device {self.device} = channels x bank-groups x banks "
            f"x crossbars",
            "# KIND id=N key=value ... [| name:int,int;name2:int,...]",
        ]
        return "\n".join(head + [r.line() for r in self.records]) + "\n"

    @classmethod
    def loads(cls, text: str) -> "CommandTrace":
        """Parse :meth:`dumps` output back into a trace (bit-exact:
        payload integers are unbounded)."""
        from repro_torch.core.costmodel import CrossbarSpec
        records = [Record.parse(ln) for ln in text.splitlines()
                   if ln.strip() and not ln.lstrip().startswith("#")]
        if not records or records[0].kind != "DEVICE":
            raise ValueError("trace must start with a DEVICE record")
        dev_rec = records[0]
        hops = [float(t) for t in dev_rec.fields["hop_ns"].split(",")]
        device = DeviceConfig.parse(
            dev_rec.fields["shape"],
            crossbar=CrossbarSpec(
                rows=int(dev_rec.fields["rows"]),
                cols=int(dev_rec.fields["cols"]),
                cycle_ns=float(dev_rec.fields["cycle_ns"]),
                energy_pj_per_gate=float(dev_rec.fields["energy_pj"])),
            crossbar_hop_ns=hops[0], bank_hop_ns=hops[1],
            group_hop_ns=hops[2], channel_hop_ns=hops[3],
            host_bw_gbps=float(dev_rec.fields["host_gbps"]),
            row_activation_pj=float(dev_rec.fields["row_act_pj"]))
        trace = cls(device)
        trace.records = records
        trace._next = max(r.rid for r in records) + 1
        return trace

    def dump(self, path) -> None:
        """Write :meth:`dumps` to ``path``."""
        with open(path, "w") as f:
            f.write(self.dumps())

    @classmethod
    def load(cls, path) -> "CommandTrace":
        """Read a trace file written by :meth:`dump`."""
        with open(path) as f:
            return cls.loads(f.read())

    # ------------------------------------------------------------ replay ----
    def replay(self, engine, *, backend=None
               ) -> Dict[int, List[Dict[str, List[int]]]]:
        """Re-execute every payload-bearing EXEC through ``engine``.

        Each EXEC's PROG recompiles via
        :meth:`repro_torch.engine.Engine.compile_group` (hitting the shared
        program cache) and runs the operand payloads of its ``in=`` H2D
        records, in slot order. Returns ``{exec_id: [slot outputs]}``
        with every output an exact integer list — deterministic and
        bit-identical to the original execution for any backend.
        Modeled traces (:func:`block_trace`, no payloads) yield ``{}``.
        """
        progs = self.progs()
        out: Dict[int, List[Dict[str, List[int]]]] = {}
        for ex in self.by_kind("EXEC"):
            h2ds = [self.record(rid) for rid in ex.ints("in")]
            if not h2ds or any(h.payload is None for h in h2ds):
                continue                      # modeled EXEC: cost-only
            h2ds.sort(key=lambda h: int(h.fields["slot"]))
            gex = engine.compile_group(progs[int(ex.fields["prog"])],
                                       backend=backend)
            batches = []
            for i, h in enumerate(h2ds):
                widths = {n: len(c) for n, c in
                          gex.base_entries[i].program.input_map.items()}
                planes = set(h.get("planes", "").split(","))
                batches.append({
                    name: (to_bits(np.array(vals, dtype=object),
                                   widths[name])
                           if name in planes
                           else np.array(vals, dtype=object))
                    for name, vals in h.payload.items()})
            results = gex.run(batches)
            out[ex.rid] = [
                {name: _pack_value(name, vals)[0]
                 for name, vals in slot.items()}
                for slot in results]
        return out

    def verify_replay(self, engine, *, backend=None) -> int:
        """Replay and prove bit-exactness against the recorded D2H
        payloads. Returns the number of D2H slot records checked;
        raises :class:`AssertionError` on any mismatch."""
        replayed = self.replay(engine, backend=backend)
        checked = 0
        for d2h in self.by_kind("D2H"):
            ex_id = int(d2h.fields["exec"])
            if ex_id not in replayed:
                continue
            slot = int(d2h.fields["slot"])
            got = replayed[ex_id][slot]
            want = d2h.payload or {}
            if got != want:
                raise AssertionError(
                    f"replay mismatch at EXEC id={ex_id} slot={slot}: "
                    f"{got} != recorded {want}")
            checked += 1
        return checked


class TraceRecorder:
    """Captures executed :class:`~repro_torch.engine.executable.
    GroupedExecutable` passes into a replayable :class:`CommandTrace`.

    Pass an instance as the ``recorder=`` argument of
    :meth:`GroupedExecutable.run <repro_torch.engine.executable.
    GroupedExecutable.run>`; every pass appends one H2D record per slot
    (full operands), one EXEC, and one D2H per slot (full results).
    Executables are pinned to coordinates with :meth:`bind`; unbound
    ones are auto-placed in locality order.

    Payloads are exact integer lists either way the caller marshals:
    integer-form operands record verbatim, bit-plane operands row-pack
    losslessly (the record's ``planes=`` field names them and replay
    re-expands with :func:`repro_torch.core.bits.to_bits` before running, so
    the replayed pass marshals identically to the original).
    """

    def __init__(self, device: DeviceConfig,
                 trace: Optional[CommandTrace] = None):
        self.device = device
        self.trace = trace if trace is not None else CommandTrace(device)
        self._alloc = CoordAllocator(device)
        self._bound: Dict[int, Tuple[int, Coord]] = {}

    @staticmethod
    def _members(gex) -> str:
        """``op:n:copies:label|...`` — consecutive identical slots of
        ``gex`` compressed into ``copies`` runs."""
        runs: List[List] = []
        for ent, label in zip(gex.base_entries, gex.labels):
            if ent.key.flags:
                raise ValueError(
                    f"cannot serialize group member {ent.key} to a "
                    f"trace: builder flags are not representable in "
                    f"PROG records")
            item = [ent.key.kind, ent.key.n, label]
            if runs and runs[-1][0] == item:
                runs[-1][1] += 1
            else:
                runs.append([item, 1])
        return "|".join(f"{kind}:{n}:{copies}:{label or ''}"
                        for (kind, n, label), copies in runs)

    def bind(self, gex, coord: Coord) -> int:
        """Pin ``gex`` to a crossbar coordinate and emit its PROG
        record; returns the PROG id. Idempotent per executable."""
        key = id(gex)
        if key in self._bound:
            return self._bound[key][0]
        self.device.validate(coord)
        rec = self.trace.add("PROG", members=self._members(gex))
        self._bound[key] = (rec.rid, coord)
        return rec.rid

    def record_pass(self, gex, batches, results) -> int:
        """Append one executed pass (called from
        :meth:`GroupedExecutable.run <repro_torch.engine.executable.
        GroupedExecutable.run>`); returns the EXEC record id."""
        key = id(gex)
        if key not in self._bound:
            label = next(iter(dict.fromkeys(gex.labels)), "group")
            self.bind(gex, self._alloc.place(label))
        pid, coord = self._bound[key]

        h2d_ids: List[int] = []
        rows = None
        for i, (batch, ent) in enumerate(zip(batches, gex.base_entries)):
            payload: Dict[str, List[int]] = {}
            plane_names: List[str] = []
            for name in ent.program.input_map:
                vals, was_planes = _pack_value(name, batch[name])
                if was_planes:
                    plane_names.append(name)
                rows = len(vals) if rows is None else rows
                payload[name] = vals
            widths = [len(c) for c in ent.program.input_map.values()]
            rec = self.trace.add(
                "H2D", payload=payload, dst=coord, slot=i, prog=pid,
                bytes=_plane_bytes(rows or 1, widths),
                planes=",".join(plane_names))
            h2d_ids.append(rec.rid)

        cost = gex.cost()
        ex = self.trace.add(
            "EXEC", prog=pid, at=coord, k=gex.k, cycles=gex.n_cycles,
            rows=rows or 1, passes=1, energy_uj=cost.energy_uj,
            **{"in": ",".join(str(i) for i in h2d_ids)})

        for i, (slot, ent) in enumerate(zip(results, gex.base_entries)):
            payload = {}
            plane_names = []
            for name, vals in slot.items():
                payload[name], was_planes = _pack_value(name, vals)
                if was_planes:
                    plane_names.append(name)
            widths = [len(c) for c in ent.program.output_map.values()]
            self.trace.add("D2H", payload=payload, exec=ex.rid, slot=i,
                           bytes=_plane_bytes(rows or 1, widths),
                           planes=",".join(plane_names))
        return ex.rid


def block_trace(plan, device: DeviceConfig, *, tokens: int = 1
                ) -> CommandTrace:
    """Model a planned block (:func:`repro_torch.pim.planner.plan_block`) as a
    per-token command trace on ``device``.

    Per token, each scope becomes one concurrent phase: an H2D of the
    scope's activations to its first crossbar, a BCAST fanning them to
    the scope's other crossbars, one EXEC per co-scheduled group
    (``cycles`` = the group's full per-token chain including staging and
    recombination, compressed to a single record), a MOV of every
    group's outputs toward the next scope (D2H for the last), and a
    BARRIER — scopes are sequential, groups within a scope parallel,
    exactly the :class:`~repro_torch.pim.planner.BlockPlan` dependence
    structure. Groups planned with a device placer keep their
    coordinates; unplaced groups are placed here in locality order.
    These EXECs carry no operand payloads (cost modeling, not replay).
    """
    trace = CommandTrace(device)
    alloc = CoordAllocator(device)
    coords = [g.coord if getattr(g, "coord", None) is not None
              else alloc.place(",".join(l.name for l in g.linears),
                               g.scope)
              for g in plan.groups]
    for c in coords:
        device.validate(c)

    scopes = plan.scopes
    n = plan.n_bits
    for _ in range(tokens):
        last: List[int] = []
        for si, scope in enumerate(scopes):
            pairs = [(g, c) for g, c in zip(plan.groups, coords)
                     if g.scope == scope]
            entry = pairs[0][1]
            act_bytes = max(
                _plane_bytes(1, [l.in_dim * n for l in g.linears])
                for g, _ in pairs)
            if si == 0:
                trace.add("H2D", dst=entry, slot=0, bytes=act_bytes)
            fan = [c for _, c in pairs[1:] if c != entry]
            if fan:
                trace.add("BCAST", src=entry,
                          dst=",".join(str(c) for c in fan),
                          bytes=act_bytes)
            execs: List[int] = []
            for g, c in pairs:
                e = (g.executable.cost().energy_uj * g.passes_per_token
                     if g.executable is not None else 0.0)
                rec = trace.add(
                    "EXEC", prog=-1, at=c, k=g.macs_per_pass,
                    cycles=g.cycles_per_token, rows=g.rows,
                    passes=g.passes_per_token, energy_uj=e,
                    **{"in": ",".join(str(i) for i in last)})
                execs.append(rec.rid)
            # Results move toward the next scope's entry point (or back
            # to the host after the last scope).
            for (g, c), ex in zip(pairs, execs):
                out_bytes = _plane_bytes(
                    1, [l.out_dim * 2 * n for l in g.linears])
                if si + 1 < len(scopes):
                    nxt = next(cc for gg, cc in zip(plan.groups, coords)
                               if gg.scope == scopes[si + 1])
                    trace.add("MOV", src=c, dst=nxt, bytes=out_bytes)
                else:
                    trace.add("D2H", exec=ex, slot=0, bytes=out_bytes)
            trace.add("BARRIER", after=scope)
            last = execs
    return trace
